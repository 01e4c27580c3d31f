"""IFNet's block inputs and outputs written once, in place (models/ifnet.py,
ops/block_input.py, ops/block_output.py, ops/planes.py), on the CPU.

The plain assembly (what the CPU runs, and the card's kernel is held to)
against the reference's concatenate-then-resize expression written out
here, at every stage and pyramid scale, in f32; the permuted, zero-padded
first conv weights against the originals; the operands read where they lie
(a shared frame with a batch stride of 0, a per-plane choice of two); the
block output's plain version against the block's tail written out; the
block counters.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from drba_tpu_torch.config import F32
from drba_tpu_torch.models.ifnet import (BLOCK_IN, BLOCK_IN_PADDED, IN_ORDER, LASTCONV_PADDED,
                                         WARPED, assembled_layout, block0_input, ifnet_apply,
                                         ifnet_block_at_scale, stage_input)
from drba_tpu_torch.models.rife import RIFE
from drba_tpu_torch.ops.block_input import assemble
from drba_tpu_torch.ops.block_output import block_output
from drba_tpu_torch.ops.planes import Pick, dense, first_channels, shared
from drba_tpu_torch.ops.resize import resize_bilinear
from drba_tpu_torch.ops.warp import backwarp2
from drba_tpu_torch.utils import profiling

H, W = 64, 128
T = 3
SCALES = [16.0, 8.0, 4.0, 2.0, 1.0, 2.5]  # 2.5: not an integer (64x128 -> 25x51)
# PyTorch's CPU bilinear kernel (F.interpolate, channels last) takes another
# code path by channel count (vector lanes or a scalar tail, fused or not),
# so one channel resized alone and inside a wider tensor may differ by one
# f32 ulp; the warped channels come from the same calls, bit for bit
ULP = dict(rtol=2 ** -22, atol=2 ** -22)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return RIFE(weights=None, config=F32, device="cpu")


def _rand(rng, *shape, lo=0.0, hi=1.0):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def _window_operands(seed=0):
    """A DRBA window's operands as ``_drba_window`` hands them to IFNet: I1
    and f1 shared by the T planes, the B side picked per plane, the timestep
    maps picked per plane; flow, mask and feat as a block returns them (mask
    and feat strided views of one 13-channel map)."""
    rng = np.random.default_rng(seed)
    I0, I1, I2 = (_rand(rng, 1, H, W, 3) for _ in range(3))
    f0, f1, f2 = (_rand(rng, 1, H, W, 16, lo=-1) for _ in range(3))
    take_b = torch.tensor([False, True, True])
    d01, d12 = _rand(rng, T, H, W, 1), _rand(rng, T, H, W, 1)
    tmp = _rand(rng, T, H, W, 13, lo=-1)
    flow = _rand(rng, T, H, W, 4, lo=-6, hi=6)
    ops = dict(img0=shared(I1, T), img1=Pick(shared(I0, T), shared(I2, T), take_b),
               f0=shared(f1, T), f1=Pick(shared(f0, T), shared(f2, T), take_b),
               timestep=Pick(d01, d12, take_b), flow=flow, mask=tmp[..., 4:5], feat=tmp[..., 5:])
    return ops


def test_operands_read_where_they_lie():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    s = shared(x[:1], 4)
    assert s.shape == (4, 3, 4, 5) and s.stride()[0] == 0 and torch.equal(s[3], x[0])
    p = Pick(shared(x[:1], 2), shared(x[1:], 2), torch.tensor([True, False]))
    assert torch.equal(dense(p), torch.stack([x[1], x[0]]))
    # more than one frame a plane: copied, in timestep-major order
    assert torch.equal(shared(x, 2), torch.cat([x, x]))


@pytest.mark.parametrize("scale", SCALES)
def test_block0_input_is_the_reference_concat_then_resize(scale):
    o = _window_operands()
    got = block0_input(o["img0"], o["img1"], o["f0"], o["f1"], o["timestep"], scale,
                       backend="torch")
    size = (int(H / scale), int(W / scale))
    want = resize_bilinear(torch.cat([dense(o["img0"])[..., :3], dense(o["img1"])[..., :3],
                                      dense(o["f0"]), dense(o["f1"]), dense(o["timestep"])],
                                     dim=-1), size)
    assert got.shape == (T, *size, BLOCK_IN_PADDED[0])
    # bilinear resizing is per channel: the same arithmetic per value
    torch.testing.assert_close(got[..., :BLOCK_IN[0]], want, **ULP)
    assert not got[..., BLOCK_IN[0]:].any()


@pytest.mark.parametrize("scale", SCALES[1:])
def test_stage_input_is_the_reference_concat_then_resize(scale):
    """Blocks 1-4: the reference's expression (models/ifnet.py before the
    assembly: the two directions' warps, tap-grid at an even k, then the
    timestep, mask, feat and the resized flow over the scale) in its channel
    order, against the assembled input read through IN_ORDER."""
    o = _window_operands(1)
    a = torch.cat([dense(o["img0"])[..., :3], dense(o["f0"])], dim=-1)
    b = torch.cat([dense(o["img1"])[..., :3], dense(o["f1"])], dim=-1)
    t, flow = dense(o["timestep"]), o["flow"]
    n = T
    size = (int(H / scale), int(W / scale))
    if scale == int(scale) and int(scale) % 2 == 0:
        k = int(scale)
        both = backwarp2(a, b, flow, k, backend="torch")
        rest = resize_bilinear(torch.cat([t, o["mask"], o["feat"]], dim=-1), size)
        x = torch.cat([both[:n, ..., :3], both[n:, ..., :3], both[:n, ..., 3:], both[n:, ..., 3:],
                       rest], dim=-1)
    else:
        both = backwarp2(a, b, flow, backend="torch")
        x = torch.cat([both[:n, ..., :3], both[n:, ..., :3], both[:n, ..., 3:], both[n:, ..., 3:],
                       t, o["mask"], o["feat"]], dim=-1)
        x = resize_bilinear(x, size)
    want = torch.cat([x, resize_bilinear(flow, size) * (1.0 / scale)], dim=-1)

    got = stage_input((first_channels(o["img0"], 3), o["f0"]),
                       (first_channels(o["img1"], 3), o["f1"]), flow, o["timestep"], o["mask"],
                       o["feat"], scale, backend="torch")
    assert got.shape == (n, *size, BLOCK_IN_PADDED[1])
    torch.testing.assert_close(got[..., :BLOCK_IN[1]], want[..., list(IN_ORDER)], **ULP)
    assert not got[..., BLOCK_IN[1]:].any()
    # each direction's frame and features are one run of channels
    assert IN_ORDER[:WARPED] == (0, 1, 2, *range(6, 22))


def test_assemble_resizes_or_places_each_part_and_zeros_the_rest():
    rng = np.random.default_rng(3)
    out = torch.full((2, 8, 16, 16), 7.0)
    a, b, c = _rand(rng, 2, 16, 32, 3), _rand(rng, 2, 16, 32, 5), _rand(rng, 2, 8, 16, 4)
    assemble(out, [(a, 1.0), (b, 0.5), (c, 1.0)], backend="torch")
    assert torch.equal(out[..., :3], resize_bilinear(a, (8, 16)))
    assert torch.equal(out[..., 3:8], resize_bilinear(b, (8, 16)) * 0.5)
    assert torch.equal(out[..., 8:12], c)  # already at the block's resolution: placed
    assert not out[..., 12:].any()
    with pytest.raises(ValueError):
        assemble(out, [(a, 1.0), (b, 1.0), (_rand(rng, 2, 16, 32, 9), 1.0)], backend="torch")
    with pytest.raises(ValueError):  # two full resolutions
        assemble(out, [(a, 1.0), (_rand(rng, 2, 32, 64, 3), 1.0)], backend="torch")
    with pytest.raises(ValueError):
        assemble(out, [(a, 1.0)], backend="cuda")  # a CPU tensor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_flow", [False, True])
@pytest.mark.parametrize("scale", SCALES)
def test_block_output_is_the_blocks_eager_tail(scale, with_flow, dtype):
    """``block_output``'s plain version (what the kernel is held to) against
    the block's tail written out with PyTorch's own layers: the lastconv's
    output (LASTCONV_PADDED channels at half the block's resolution: two
    stride-2 convs round it up to a multiple of 4, the stride-2 transposed
    conv doubles it) pixel-shuffled, its first 13 channels resized to full
    resolution (at scale 1 the shuffle gives it, and nothing is resized),
    the flow times the scale plus the running flow (none at block 0), each
    step in ``dtype``."""
    rng = np.random.default_rng(int(scale * 10) + with_flow)
    half = lambda n: -(-n // 2)  # noqa: E731
    hl, wl = (2 * half(half(int(d / scale))) for d in (H, W))
    assert scale != 1 or (2 * hl, 2 * wl) == (H, W)
    lc = _rand(rng, T, hl, wl, LASTCONV_PADDED, lo=-1).to(dtype)
    flow = _rand(rng, T, H, W, 4, lo=-6, hi=6).to(dtype) if with_flow else None
    got = block_output(lc, scale, flow, (H, W), backend="torch")

    shuffled = F.pixel_shuffle(lc.permute(0, 3, 1, 2)[:, :52], 2)
    if tuple(shuffled.shape[2:]) != (H, W):
        shuffled = F.interpolate(shuffled, size=(H, W), mode="bilinear", align_corners=False)
    tail = shuffled.permute(0, 2, 3, 1)
    want_flow = tail[..., :4] * scale if flow is None else flow + tail[..., :4] * scale
    for g, w in zip(got, (want_flow, tail[..., 4:5], tail[..., 5:])):
        assert g.dtype == dtype and torch.equal(g, w)
    with pytest.raises(ValueError):
        block_output(lc, scale, flow, (H, W), backend="cuda")  # a CPU tensor
    with pytest.raises(ValueError):  # the flow at another resolution
        block_output(lc, scale, _rand(rng, T, H // 2, W, 4).to(dtype), (H, W), backend="torch")


def test_ifnet_counts_each_block_output(model):
    """Each block's output, by the kernel or the plain version: five an IFNet
    call, one a RIFE pass (block 0's flow)."""
    o = _window_operands(2)
    with profiling.tracer() as st:
        ifnet_apply(model.params, o["img0"], o["img1"], o["timestep"], (16.0, 8.0, 4.0, 2.0, 1.0),
                    f0=o["f0"], f1=o["f1"], warp_backend="torch", conv_backend="torch")
    assert st.counters["ifnet.out_plain"] == 5 and st.counters["ifnet.out_fused"] == 0
    assert "ifnet.out_fused" in st.report() and "ifnet.out_plain" in st.report()
    frame = dense(o["img0"])[:1]
    with profiling.tracer() as st:
        model.reuse(frame, frame.flip(2))
    assert st.counters["ifnet.out_plain"] == 1 and st.counters["ifnet.out_fused"] == 0


@pytest.mark.parametrize("idx", range(5))
def test_padded_permuted_first_conv_matches_the_reference_weights(model, idx):
    """Block ``idx`` on its reference-layout input (``conv0.0.0.weight``)
    and on the same values assembled (IN_ORDER, zero pad; ``.wp``): the
    same flow, mask and features within f32 rounding (the first conv sums
    its 9 * C products in another order)."""
    rng = np.random.default_rng(10 + idx)
    x = _rand(rng, 2, 16, 32, BLOCK_IN[idx], lo=-1)
    order = list(IN_ORDER) if idx else list(range(BLOCK_IN[0]))
    xa = torch.cat([x[..., order], torch.zeros(2, 16, 32, BLOCK_IN_PADDED[idx] - BLOCK_IN[idx])],
                   dim=-1)
    assert torch.equal(assembled_layout(x, idx), xa)
    # the same block with the reference weight in the first conv's place
    reference = dict(model.params)
    reference[f"block{idx}.conv0.0.0.wp"] = model.params[f"block{idx}.conv0.0.0.weight"]
    want = ifnet_block_at_scale(reference, idx, x, 4.0, (64, 128), "torch")
    got = ifnet_block_at_scale(model.params, idx, xa, 4.0, (64, 128), "torch")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_ifnet_counts_each_block_input(model):
    o = _window_operands(2)
    with profiling.tracer() as st:
        ifnet_apply(model.params, o["img0"], o["img1"], o["timestep"], (16.0, 8.0, 4.0, 2.0, 1.0),
                    f0=o["f0"], f1=o["f1"], warp_backend="torch", conv_backend="torch")
    assert st.counters["ifnet.concat"] == 5 and st.counters["ifnet.assembled"] == 0
    assert "ifnet.assembled" in st.report() and "ifnet.concat" in st.report()


def test_window_operands_match_the_tiled_frames(model):
    """``ifnet_apply`` on the shared and picked operands equals it on the
    T-fold copies the window used to make (bit for bit: the same values
    reach the same ops)."""
    o = _window_operands(4)
    scales = (16.0, 8.0, 4.0, 2.0, 1.0)
    got, gflows = ifnet_apply(model.params, o["img0"], o["img1"], o["timestep"], scales,
                              f0=o["f0"], f1=o["f1"], warp_backend="torch", conv_backend="torch")
    want, wflows = ifnet_apply(model.params, *(dense(o[k]).contiguous()
                                               for k in ("img0", "img1", "timestep")), scales,
                               f0=dense(o["f0"]).contiguous(), f1=dense(o["f1"]).contiguous(),
                               warp_backend="torch", conv_backend="torch")
    assert torch.equal(got, want)
    for g, w in zip(gflows, wflows):
        assert torch.equal(g, w)
