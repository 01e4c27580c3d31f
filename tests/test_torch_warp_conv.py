"""The port's two-direction warp, the conv chain's packed weights, the
models' device defaults and the kernels' launch device guard, on the CPU.

``backwarp2``'s plain version is held against the single-direction plain
warps (exactly) and against drba_tpu's ``backwarp`` / ``_warp_then_downsample``
on the same numpy inputs; the packed weight layout of the bf16 conv kernel
against ``F.conv2d``. The kernels themselves run only on a CUDA device:
tests/test_torch_gpu.py holds them against these plain versions.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from drba_tpu_torch.ops.conv_chain import (conv3x3_packed_plain, pack_weights,
                                           unpack_weights)
from drba_tpu_torch.ops.warp import backwarp, backwarp2, warp_downsample

# f32: the two packages compute the same formulas; XLA and PyTorch order
# sums and fuse ops differently (a few ulps)
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per machine; keep this file's
    small PyTorch CPU ops on one thread instead of oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------------------------ warp


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_backwarp2_plain_matches_single_warps_and_jax(k, padding_mode):
    """Both directions of a 4-channel flow, stacked a-first; flows reaching
    up to ~20 px past the frame exercise both padding modes."""
    from drba_tpu.models.ifnet import _warp_then_downsample
    from drba_tpu.ops.resize import resize_bilinear as jax_resize
    from drba_tpu.ops.warp import backwarp as jax_backwarp

    rng = np.random.default_rng(10 + k)
    n, h, w, c = 2, 32, 48, 19
    a = rng.uniform(0, 1, (n, h, w, c)).astype(np.float32)
    b = rng.uniform(0, 1, (n, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 4)) * 8).astype(np.float32)
    got = backwarp2(_t(a), _t(b), _t(flow), k, padding_mode, backend="torch")
    assert tuple(got.shape) == (2 * n, h // k, w // k, c)

    single = backwarp if k == 1 else (lambda i, f, m, backend: warp_downsample(i, f, k, m,
                                                                               backend))
    for half, (img, sl) in enumerate(((a, slice(0, 2)), (b, slice(2, 4)))):
        part = got[half * n:(half + 1) * n]
        # the same plain function on the same inputs: bit-identical
        assert torch.equal(part, single(_t(img), _t(flow[..., sl]), padding_mode,
                                        backend="torch"))
        want = jax_backwarp(jnp.asarray(img), jnp.asarray(flow[..., sl]), padding_mode)
        if k > 1:  # downsample_k(backwarp): the tap grid is exact
            want = jax_resize(want, (h // k, w // k))
        np.testing.assert_allclose(part.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)
        if k > 1 and padding_mode == "border":
            tap = _warp_then_downsample(jnp.asarray(img), jnp.asarray(flow[..., sl]), k)
            np.testing.assert_allclose(part.numpy(), np.asarray(tap), atol=F32_TOL, rtol=0)


def test_backwarp2_cuda_backend_on_cpu_tensors_raises():
    from drba_tpu_torch import _build

    launches = _build.counts()
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        backwarp2(x, x, torch.zeros(1, 8, 8, 4), 2, backend="cuda")
    assert _build.counts() == launches


# ------------------------------------------------------------------------- conv packing


@pytest.mark.parametrize("cin,cout", [(32, 32), (192, 192), (24, 40), (19, 5)])
def test_pack_weights_round_trips_and_packed_conv_matches_conv2d(cin, cout):
    """IFNet widths, a bias-only 24 -> 40 step and widths that are no
    multiple of the kernel's 16-channel chunk (zero-padded)."""
    g = torch.Generator().manual_seed(cin + cout)
    w = torch.randn(cout, cin, 3, 3, generator=g) / (9 * cin) ** 0.5
    b = torch.randn(cout, generator=g) * 0.1
    x = torch.randn(2, 9, 13, cin, generator=g)
    wp = pack_weights(w)
    assert tuple(wp.shape) == (-(-cin // 16), 9, cout, 16)
    assert torch.equal(unpack_weights(wp, cin), w)
    # K chunk g, tap ky * 3 + kx, output channel o, lane i: w[o, 16 g + i, ky, kx]
    for o, ci, ky, kx in ((0, 0, 0, 0), (cout - 1, cin - 1, 2, 1), (cout // 2, cin // 2, 1, 2)):
        assert wp[ci // 16, ky * 3 + kx, o, ci % 16] == w[o, ci, ky, kx]
    if cin % 16:  # the padding past Cin is zero
        assert not wp[-1, :, :, cin % 16:].any()
    want = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)
    # f32 sums of 9 * Cin products in another order (chunk by chunk, tap by tap)
    torch.testing.assert_close(conv3x3_packed_plain(x, wp, b), want, atol=1e-5, rtol=1e-5)


def test_rife_packs_its_resconv_weights_once():
    """The model's parameters hold every ResConv step's weights packed, in
    the parameters' dtype, and each block's chain reads them as they are
    (no packing per call)."""
    from drba_tpu_torch.config import F32
    from drba_tpu_torch.models.ifnet import BLOCK_CHANNELS, _resconv_steps
    from drba_tpu_torch.models.rife import RIFE

    m = RIFE(config=F32, device="cpu")
    for i, c in enumerate(BLOCK_CHANNELS):
        steps = _resconv_steps(m.params, f"block{i}", torch.float32)
        assert len(steps) == 8
        for j, s in enumerate(steps):
            name = f"block{i}.convblock.{j}.conv"
            assert s.wp is m.params[f"{name}.wp"] and s.wp.dtype == torch.float32
            assert torch.equal(unpack_weights(s.wp, c), m.params[f"{name}.weight"])


# ------------------------------------------------------------------------ device defaults


@pytest.mark.parametrize("model", ["rife", "gmfss", "gmfss_union"])
def test_models_default_to_cuda_and_raise_without_it(model, monkeypatch):
    from drba_tpu_torch.config import F32

    if model == "rife":
        from drba_tpu_torch.models.rife import RIFE as cls
    elif model == "gmfss":
        from drba_tpu_torch.models.gmfss import GMFSS as cls
    else:
        from drba_tpu_torch.models.gmfss_union import GMFSS_UNION as cls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(config=F32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(config=F32, device="cuda:0")
    m = cls(config=F32, device="cpu")
    assert m.device == torch.device("cpu")


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from drba_tpu_torch import cli

    assert cli.parse_args(["-m", "rife"]).device == "cuda"
    assert cli.parse_args(["--device", "cpu"]).device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["-m", "rife", "-i", str(tmp_path / "none.mp4")])
    # the model type is checked first; gmfss_union is one
    with pytest.raises(ValueError, match="gmfss_union"):
        cli.main(["-m", "gmfss_plus", "-i", str(tmp_path / "none.mp4")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["-m", "gmfss_union", "-s", "-i", str(tmp_path / "none.mp4")])
    # with --device cpu the run gets past the device to the input check, -s accepted
    with pytest.raises(FileNotFoundError):
        cli.main(["-m", "rife", "--device", "cpu", "-i", str(tmp_path / "none.mp4")])
    with pytest.raises(FileNotFoundError):
        cli.main(["-m", "gmfss_union", "-s", "-st", "0.2", "--device", "cpu", "-i",
                  str(tmp_path / "none.mp4")])


# ------------------------------------------------------------------- the launch device guard


def test_model_device_refuses_cards_it_does_not_see(monkeypatch, tmp_path):
    """``cuda:7`` on a machine with one card raises, as does the CLI's
    ``--device cuda:1``, before any model is built."""
    from drba_tpu_torch import cli
    from drba_tpu_torch.config import model_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="sees 1 CUDA device"):
        model_device("cuda:7")
    assert model_device("cuda:0") == torch.device("cuda", 0)
    assert model_device("cuda") == torch.device("cuda")
    monkeypatch.setattr(cli, "load_model", lambda *a, **k: pytest.fail("model built"))
    with pytest.raises(RuntimeError, match="cuda:1 does not exist"):
        cli.main(["-m", "gmfss_union", "--device", "cuda:1", "-i", str(tmp_path / "x.mp4")])


def _mock_guard(monkeypatch, kernel, current=0):
    """Let ``kernel.launch`` run on the CPU: its C entries record the device
    current when they run; ``torch.cuda.device`` records the index it is
    entered with."""
    import contextlib

    from drba_tpu_torch import _build

    state = {"current": current, "entered": [], "ran_on": []}

    @contextlib.contextmanager
    def guard(index):
        state["entered"].append(index)
        prev, state["current"] = state["current"], index
        try:
            yield
        finally:
            state["current"] = prev

    monkeypatch.setattr(_build.torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(_build.torch.cuda, "device", guard)
    monkeypatch.setattr(kernel, "load", lambda: None)
    monkeypatch.setattr(kernel, "_fns", {e: (lambda *a: state["ran_on"].append(state["current"])
                                            or 0) for e in kernel.entries})
    return state


def test_kernel_launch_runs_on_its_device(monkeypatch):
    """The C entry runs with the tensors' device current: the guard is entered
    with its index where another device is current, and skipped where it is
    current already; a launch without a CUDA device raises."""
    from drba_tpu_torch import _build

    state = _mock_guard(monkeypatch, _build.WARP, current=0)
    n0 = _build.WARP.launches
    _build.WARP.launch(1, 2, device=torch.device("cuda", 1))
    assert state["entered"] == [1] and state["ran_on"] == [1] and state["current"] == 0
    _build.WARP.launch(1, 2, device=torch.device("cuda", 0))
    _build.WARP.launch(1, 2, device=torch.device("cuda"))
    assert state["entered"] == [1] and state["ran_on"] == [1, 0, 0]
    with pytest.raises(ValueError, match="CUDA device"):
        _build.WARP.launch(1, 2, device=torch.device("cpu"))
    assert _build.WARP.launches - n0 == 3


def _op_calls():
    """Each kernel wrapper with small CPU tensors: (module, kernel, call,
    the tensor whose device the launch must take)."""
    from types import SimpleNamespace

    import importlib

    from drba_tpu_torch._build import CONV, FLASH, LAYER, SPLAT, WARP, WINDOW
    from drba_tpu_torch.ops import attention, attn_layer, splat_cuda, warp_cuda

    conv_chain = importlib.import_module("drba_tpu_torch.ops.conv_chain")

    z = torch.zeros
    ten, acc = z(1, 2, 3, 4), z(1, 2, 3, 8)
    img, x = z(1, 4, 4, 3), z(1, 4, 4, 8)
    q = z(2, 64, 128)
    lx = z(1, 2, 2, 128)
    wt = SimpleNamespace(ffn=None, ffn_p=None, merge_p=z(1), norm1=(z(1), z(1)))
    return {
        "splat scatter": (splat_cuda, SPLAT,
                          lambda: splat_cuda.splat_scatter_cuda(ten, z(1, 2, 3, 2), None, 0), ten),
        "splat normalise": (splat_cuda, SPLAT,
                            lambda: splat_cuda.splat_normalise_cuda(acc, 4, 1, torch.float32),
                            acc),
        "warp": (warp_cuda, WARP, lambda: warp_cuda.warp_cuda(img, z(1, 4, 4, 2)), img),
        "conv": (conv_chain, CONV, lambda: conv_chain.conv3x3_cuda(
            x, z(8, 8, 3, 3), z(8), wp=conv_chain.pack_weights_tf32(z(8, 8, 3, 3))), x),
        "window": (attention, WINDOW, lambda: attention._window_cuda(q, q, q, None, False), q),
        "flash": (attention, FLASH,
                  lambda: attention._flash_cuda(q, q, z(2, 64, 2), None, False), q),
        "layer projection": (attn_layer, LAYER, lambda: attn_layer.layer_proj_cuda(lx, lx, z(1)),
                             lx),
        "layer tail": (attn_layer, LAYER, lambda: attn_layer.layer_tail_cuda(lx, lx, wt), lx),
    }


@pytest.mark.parametrize("op", list(_op_calls()))
def test_each_kernel_launch_takes_its_tensors_device(monkeypatch, op):
    """Every wrapper hands its launch the device of its tensors (mocked on the
    CPU, where the tensors' device is the CPU's); with
    test_kernel_launch_runs_on_its_device, each launch runs on that device."""
    module, kernel, call, tensor = _op_calls()[op]
    devices = []
    monkeypatch.setattr(module, "check_cuda_input", lambda *a, **k: None)
    monkeypatch.setattr(module, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernel, "launch", lambda *a, device, entry=None: devices.append(device))
    call()
    assert devices and all(d == tensor.device for d in devices), devices
