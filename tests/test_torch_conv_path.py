"""The conv kernel's plan of designs (``ops/conv_chain.conv3x3_path``) and
the wrapper's refusals, on the CPU.

csrc/conv_chain.cu has three designs: the f32 kernel (3xTF32 on
``mma.sync``), the bf16 ``mma.sync`` kernel for the small and narrow steps,
and the bf16 ``wgmma`` kernel with persistent blocks for the large ones. The plan is Python, so
the shapes each model's steps send to each design are checked here; the
kernels themselves run only on the card (tests/test_torch_gpu.py).
"""

from __future__ import annotations

import importlib

import pytest
import torch

from drba_tpu_torch.ops.conv_chain import (PATHS, WGMMA_RESIDENT_BYTES, chain_step, conv3x3_cuda,
                                           conv3x3_path, pack_weights, wgmma_blocks)

conv_chain_mod = importlib.import_module("drba_tpu_torch.ops.conv_chain")

torch.set_num_threads(1)

H, W = 1088, 1920  # 1080p padded to 64
HU = 1152          # GMFSS_UNION's pad of 128
BF16, F32 = torch.bfloat16, torch.float32

# the GMFSS and GMFSS_UNION chain steps of a T=3 window at 1080p:
# (n, h, w, cin, cout)
GMFSS_STEPS = {
    "gridnet L0": (3, H // 2, W // 2, 64, 64),
    "gridnet L1": (3, H // 4, W // 4, 128, 128),
    "gridnet head1 first step": (3, H // 2, W // 2, 128, 64),
    "gridnet tail upsample": (3, H // 2, W // 2, 64, 256),
    "metricnet": (1, H // 2, W // 2, 64, 64),
    "featurenet L1": (1, H // 2, W // 2, 64, 64),
    "union L0": (3, HU // 2, W // 2, 64, 64),
}
# the steps that stay on mma.sync: IFNet's ResConvs (c = 192, 128, 96, 64
# at 1/16-1/4 resolution, N = 3 and the flow pass's N = 1; the union's
# auxiliary IFNet at half resolution: too few tiles), the GMFSS steps with odd
# widths (Cin 14 / 12 / 9, Cout 2) and GridNet's 256 -> 128 head, whose
# weights the wgmma design would stream (slower than mma.sync there)
MMA_STEPS = {
    "gridnet head2": (3, H // 4, W // 4, 256, 128),
    "ifnet block 0": (3, 17, 30, 192, 192),
    "ifnet block 0 flow pass": (1, 17, 30, 192, 192),
    "ifnet block 1": (3, 34, 60, 128, 128),
    "ifnet block 2": (3, 68, 120, 96, 96),
    "ifnet block 3": (3, 136, 240, 64, 64),
    "ifnet block 4": (3, 272, 480, 32, 32),
    "union aux block 0": (3, 9, 15, 192, 192),
    "union aux block 1": (3, 18, 30, 128, 128),
    "metricnet in": (1, H // 2, W // 2, 14, 64),
    "metricnet out": (1, H // 2, W // 2, 64, 2),
    "gridnet head": (3, H // 2, W // 2, 12, 64),
    "union head0": (3, HU // 2, W // 2, 9, 64),
}
# the steps only f32 sends to the kernel (bf16 leaves them on cuDNN):
# GridNet's 192-channel L2 blocks and FeatureNet's levels 2-3
F32_STEPS = {
    "gridnet L2": (3, H // 8, W // 8, 192, 192),
    "gridnet head3 first step": (3, H // 8, W // 8, 384, 192),
    "featurenet L2": (1, H // 4, W // 4, 128, 128),
    "featurenet L3": (1, H // 8, W // 8, 192, 192),
}


@pytest.mark.parametrize("step", list(GMFSS_STEPS))
def test_plan_sends_the_gmfss_steps_to_wgmma(step):
    assert conv3x3_path(*GMFSS_STEPS[step], BF16) == "wgmma"


@pytest.mark.parametrize("step", list(MMA_STEPS))
def test_plan_keeps_the_deep_narrow_and_odd_steps_on_mma(step):
    assert conv3x3_path(*MMA_STEPS[step], BF16) == "mma"


@pytest.mark.parametrize("step", list(GMFSS_STEPS) + list(MMA_STEPS) + list(F32_STEPS))
def test_plan_sends_every_f32_step_to_the_tf32_kernel(step):
    shape = GMFSS_STEPS.get(step) or MMA_STEPS.get(step) or F32_STEPS[step]
    assert conv3x3_path(*shape, F32) == "tf32"


def test_wgmma_blocks_keep_their_weights_where_they_fit():
    """Output channels a block and rows a warpgroup tile as the C launcher
    picks them; resident weights never pass the budget."""
    assert wgmma_blocks(64, 64) == (64, 2, True)
    assert wgmma_blocks(128, 128) == (64, 2, True)    # 128 channels would not fit
    assert wgmma_blocks(128, 64) == (64, 2, True)
    assert wgmma_blocks(64, 256) == (128, 1, True)    # two blocks of 128 channels
    assert wgmma_blocks(256, 128) == (128, 1, False)  # streamed with each K chunk
    assert wgmma_blocks(192, 64) == (64, 2, False)
    for cin in range(16, 257, 16):
        for cout in (64, 128, 192, 256):
            nb, rows, resident = wgmma_blocks(cin, cout)
            assert cout % nb == 0 and rows * nb == 128
            assert resident == (9 * cin * nb * 2 <= WGMMA_RESIDENT_BYTES)


def test_plan_needs_enough_tiles_for_wgmma():
    """A step with fewer than WGMMA_MIN_TILES warpgroup tiles stays on mma:
    a 64 -> 64 step (two rows a tile) at 1 x 280 x 960 has 140 x 15 = 2100."""
    assert conv3x3_path(1, 280, 960, 64, 64, BF16) == "mma"
    assert conv3x3_path(1, 282, 960, 64, 64, BF16) == "wgmma"
    assert conv3x3_path(1, 8, 64, 64, 64, BF16) == "mma"


def _step(cin, cout, dtype=BF16):
    g = torch.Generator().manual_seed(cin + cout)
    return chain_step(torch.randn(cout, cin, 3, 3, generator=g).to(dtype),
                      torch.randn(cout, generator=g).to(dtype))


@pytest.mark.parametrize("path", [None, "tf32", "mma", "wgmma"])
def test_conv3x3_cuda_with_a_path_raises_on_cpu_tensors(path):
    st = _step(64, 64)
    x = torch.zeros(1, 8, 8, 64, dtype=BF16)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_cuda(x, st.w, st.b, wp=st.wp, path=path)


@pytest.fixture
def launches(monkeypatch):
    """conv3x3_cuda with the CUDA checks and the launch mocked on the CPU:
    the list of the design codes it launched."""
    codes = []
    monkeypatch.setattr(conv_chain_mod, "check_cuda_input", lambda *a, **k: None)
    monkeypatch.setattr(conv_chain_mod, "stream_of", lambda t: 0)
    monkeypatch.setattr(conv_chain_mod.CONV, "launch",
                        lambda *a, device, entry=None: codes.append(a[-2]))
    return codes


@pytest.mark.parametrize("shape,dtype,path", [
    ((3, 40, 130, 64, 64), BF16, "wgmma"), ((3, 40, 130, 64, 64), BF16, "mma"),
    ((1, 8, 8, 12, 64), BF16, "mma"), ((1, 8, 8, 64, 64), F32, "tf32")])
def test_conv3x3_cuda_passes_the_design_to_the_kernel(launches, shape, dtype, path):
    n, h, w, cin, cout = shape
    st = _step(cin, cout, dtype)
    x = torch.zeros(n, h, w, cin, dtype=dtype)
    conv3x3_cuda(x, st.w, st.b, wp=st.wp, path=path)
    conv3x3_cuda(x, st.w, st.b, wp=st.wp)  # the plan's design
    assert launches == [PATHS.index(path), PATHS.index(conv3x3_path(*shape, dtype))]


@pytest.mark.parametrize("cin,cout,dtype,path,match", [
    (12, 64, BF16, "wgmma", "Cin a multiple of 16"),
    (64, 96, BF16, "wgmma", "Cout a multiple of 64"),
    (64, 320, BF16, "wgmma", "up to 256"),
    (64, 64, F32, "wgmma", "does not take"),
    (64, 64, F32, "mma", "does not take"),
    (64, 64, BF16, "tf32", "does not take"),
    (64, 64, BF16, "tensor", "valid: tf32, mma, wgmma")])
def test_conv3x3_cuda_refuses_a_design_the_step_does_not_fit(launches, cin, cout, dtype, path,
                                                              match):
    st = _step(cin, cout, dtype)
    x = torch.zeros(1, 8, 8, cin, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        conv3x3_cuda(x, st.w, st.b, wp=st.wp, path=path)
    assert launches == []


def test_wgmma_reads_the_packed_weights_as_its_32_byte_swizzled_b_operand():
    """The wgmma kernel stages pack_weights' rows unchanged, swapping the two
    16-byte halves of row r when bit 2 of r is set, and reads them as a
    K-major B operand with the 32-byte swizzle: element (n, k) of the k16
    step of K chunk c and tap t lies at byte 32 row + 2 k ^ 16 * bit2(row)
    of that step's NB x 32-byte block, row = n. Rebuild the weights from
    the staged bytes by that rule."""
    cin, cout, nb = 32, 128, 64
    g = torch.Generator().manual_seed(0)
    w = torch.randn(cout, cin, 3, 3, generator=g)
    wp = pack_weights(w)
    for blk in range(cout // nb):
        co0 = blk * nb
        # the kernel's copy: row (chunk * 9 + tap) * NB + r, half h at
        # swz(row, h) = row * 32 + ((h ^ bit2(row)) << 4)
        staged = torch.zeros(wp.shape[0] * 9 * nb * 16)
        for ct in range(wp.shape[0] * 9):
            for r in range(nb):
                row = ct * nb + r
                for h in range(2):
                    off = (row * 32 + ((h ^ ((row >> 2) & 1)) << 4)) // 2
                    staged[off:off + 8] = wp[ct // 9, ct % 9, co0 + r, 8 * h:8 * h + 8]
        for c in range(wp.shape[0]):
            for tap in range(9):
                base = (c * 9 + tap) * nb * 32  # the descriptor's start, 256-byte aligned
                assert base % 256 == 0
                for n in (0, 5, nb - 1):
                    for k in (0, 7, 8, 15):
                        byte = base + n * 32 + ((2 * k) ^ (16 * ((n >> 2) & 1)))
                        assert staged[byte // 2] == w[co0 + n, 16 * c + k, tap // 3, tap % 3]
