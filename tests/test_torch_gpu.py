"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips when torch.cuda.is_available() is
False. This file imports neither JAX nor drba_tpu, so it also runs where JAX
is absent; there, skip the JAX-based conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

TF32 is off in every comparison; each tolerance is stated with its reason.
"""

import pytest
import torch
import torch.nn.functional as F

from drba_tpu_torch import _build
from drba_tpu_torch.ops.conv_chain import chain_step, conv_chain
from drba_tpu_torch.ops.softsplat import softsplat
from drba_tpu_torch.ops.warp import backwarp, backwarp2, warp_downsample

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _flow(gen, n, h, w, mag, dev):
    coarse = (torch.rand(n, 2, h // 8 + 2, w // 8 + 2, generator=gen, device=dev) * 2 - 1) * mag
    return F.interpolate(coarse, size=(h, w), mode="bilinear").permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splat_kernel_matches_plain(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    ten = torch.rand(2, 40, 72, 3, generator=gen, device=dev).to(dtype)
    flow = _flow(gen, 2, 40, 72, 9.0, dev).to(dtype)
    flow[0, 3, 5, 0] = float("nan")  # dropped by both
    n0 = _build.SPLAT.launches
    got = softsplat(ten, flow, None, "avg", backend="cuda", return_coverage=True)
    want = softsplat(ten, flow, None, "avg", backend="torch", return_coverage=True)
    assert _build.SPLAT.launches == n0 + 2  # the scatter and the normalise step
    # f32 accumulation on both sides, atomics in another order; then the
    # output dtype's rounding (one bf16 ulp, 2^-7, at values <= 1)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


_MODES = ["sum", "avg", "avg-zeroeps", "avg-clipeps", "linear", "linear-zeroeps",
          "linear-clipeps", "soft", "soft-zeroeps", "soft-clipeps"]


@pytest.mark.parametrize("dtypes", [(torch.float32,) * 3, (torch.bfloat16,) * 3,
                                    (torch.float32, torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("c", [2, 3, 67, 128, 192])
def test_fused_splat_matches_plain(dev, c, dtypes):
    """The fused scatter (factor formed in the kernel) and the normalise
    step against their plain versions at the path's channel counts (C + 1
    <= 4 one thread a pixel; C % 4 == 0 vector loads and stores; C = 67
    neither), every mode, with coverage; values, flow and metric each in
    its dtype (the DRM splat's f32 values with a bf16 flow and metric).
    The flow has non-finite targets and image 1 lies wholly out of frame."""
    from drba_tpu_torch.ops.softsplat import FACTOR, _scatter_plain
    from drba_tpu_torch.ops.splat_cuda import splat_scatter_cuda

    tdt, fdt, mdt = dtypes
    gen = torch.Generator(device=dev).manual_seed(20 + c)
    ten = torch.rand(2, 24, 40, c, generator=gen, device=dev).to(tdt)
    flow = _flow(gen, 2, 24, 40, 9.0, dev)
    flow[0, 3, 5, 0] = float("nan")
    flow[0, 7, 9, 1] = float("inf")
    flow[1] += 100.0  # every target out of frame: image 1 gets nothing
    flow = flow.to(fdt)
    for mode in _MODES:
        main = mode.split("-")[0]
        metric = None
        if main in ("linear", "soft"):
            lo = 0.1 if main == "linear" else -1.0
            metric = (lo + (1 - lo) * torch.rand(2, 24, 40, 1, generator=gen, device=dev)).to(mdt)
        # the accumulators: f32 sums of <= ~8 terms of size <= e, in another order
        acc = splat_scatter_cuda(ten, flow, metric, FACTOR[main])
        want_acc = _scatter_plain(ten, flow, metric, FACTOR[main])
        torch.testing.assert_close(acc, want_acc, atol=2e-5, rtol=1e-5)
        assert not acc[1].any()
        cov = main != "sum"
        n0 = _build.SPLAT.launches
        got = softsplat(ten, flow, metric, mode, backend="cuda", return_coverage=cov)
        assert _build.SPLAT.launches == n0 + 2
        want = softsplat(ten, flow, metric, mode, backend="torch", return_coverage=cov)
        # the sums' order, divided by denominators >= ~0.1 w; in bf16 one
        # output ulp (2^-8 relative) on top
        tol = 1e-4 if tdt == torch.float32 else 8e-3
        for g, w in zip(got if cov else [got], want if cov else [want]):
            assert g.dtype == tdt and g.shape == w.shape
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                       msg=lambda m: f"{mode}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_warp_kernel_matches_plain(dev, dtype, k):
    gen = torch.Generator(device=dev).manual_seed(1)
    img = torch.rand(2, 48, 96, 19, generator=gen, device=dev).to(dtype)
    flow = _flow(gen, 2, 48, 96, 30.0, dev).to(dtype)  # reaches past the frame edge
    for mode in ("border", "zeros"):
        if k == 1:
            got = backwarp(img, flow, mode, backend="cuda")
            want = backwarp(img, flow, mode, backend="torch")
        else:
            got = warp_downsample(img, flow, k, mode, backend="cuda")
            want = warp_downsample(img, flow, k, mode, backend="torch")
        # same f32 arithmetic up to FMA contraction; in bf16 one output ulp
        tol = 1e-5 if dtype == torch.float32 else 8e-3
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 16, 19, 128])
def test_warp2_kernel_matches_plain(dev, dtype, c):
    """Both directions of a 4-channel flow in one launch, read in place (a
    non-contiguous flow view is made contiguous by the wrapper only), at
    W = 72 (no multiple of 32), flows reaching past the frame edge."""
    gen = torch.Generator(device=dev).manual_seed(10 + c)
    a, b = (torch.rand(2, 40, 72, c, generator=gen, device=dev).to(dtype) for _ in range(2))
    flow = torch.cat([_flow(gen, 2, 40, 72, 25.0, dev) for _ in range(2)], dim=-1).to(dtype)
    for k in (1, 2, 4, 8):
        for mode in ("border", "zeros"):
            n0 = _build.WARP.launches
            got = backwarp2(a, b, flow, k, mode, backend="cuda")
            assert _build.WARP.launches == n0 + 1
            want = backwarp2(a, b, flow, k, mode, backend="torch")
            # same f32 arithmetic up to FMA contraction; in bf16 one output ulp
            tol = 1e-5 if dtype == torch.float32 else 8e-3
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0,
                                       msg=lambda m: f"k={k} {mode}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("cin,cout,beta", [(32, 32, True), (64, 64, True), (96, 96, True),
                                           (128, 128, True), (192, 192, True), (24, 40, False),
                                           (19, 40, False)])
def test_conv_chain_kernel_matches_plain(dev, dtype, n, cin, cout, beta):
    """IFNet's ResConv widths at N = 1 and 3 on a 19 x 37 map (no multiple
    of the 16-column tile or its rows), and bias-only steps at widths that
    are not multiples of the kernel's channel tiles (Cin = 19: staged
    without cp.async); weights packed once per step (``chain_step``)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (torch.rand(n, 19, 37, cin, generator=gen, device=dev) * 2 - 1).to(dtype)
    bound = 1.0 / (9 * cin) ** 0.5
    steps, c = [], cin
    for _ in range(2 if beta else 1):
        args = (((torch.rand(cout, c, 3, 3, generator=gen, device=dev) * 2 - 1) * bound).to(dtype),
                ((torch.rand(cout, generator=gen, device=dev) * 2 - 1) * 0.05).to(dtype),
                (1 + 0.2 * torch.randn(cout, generator=gen, device=dev)).to(dtype)
                if beta else None)
        steps.append(chain_step(*args))
        c = cout
    n0 = _build.CONV.launches
    got = conv_chain(x, steps, backend="cuda")
    assert _build.CONV.launches == n0 + len(steps)
    want = conv_chain(x, steps, backend="torch")
    # f32: sums of 9*C products in another order; bf16: the conv output and
    # three epilogue ops round to bf16 on both sides, at possibly other ulps
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,pre,residual", [
    (64, 64, True, "none"), (64, 64, True, "plain"), (64, 64, True, "input"),
    (64, 64, True, "extra"), (128, 128, True, "input"), (14, 64, False, "none"),
    (12, 64, True, "none"), (9, 64, True, "extra"), (64, 2, True, "none"),
    (64, 256, True, "none"), (256, 128, True, "extra")])
def test_conv_chain_gmfss_epilogues_match_plain(dev, dtype, cin, cout, pre, residual):
    """The GMFSS steps' epilogues on the kernel: the pre-PReLU (a negative
    slope on a patch that straddles the frame's zero padding), the plain
    residual, the chain's input as the final residual (two steps, so that it
    is not the last step's input) and an extra residual; at GMFSS's widths
    that are no multiple of the kernel's tiles: Cin 14 / 12 / 9 (staged
    without cp.async), Cout 2 (unvectorised store) and 256 (96-channel
    blocks, the last partly masked); on a 19 x 37 map, N = 2."""
    gen = torch.Generator(device=dev).manual_seed(cin + cout)
    x = (torch.rand(2, 19, 37, cin, generator=gen, device=dev) * 2 - 1).to(dtype)
    res = (torch.rand(2, 19, 37, cout, generator=gen, device=dev) * 2 - 1).to(dtype)
    alpha = torch.tensor(-0.3, device=dev).to(dtype) if pre else None
    steps, c = [], cin
    for _ in range(2 if residual == "input" else 1):
        bound = 1.0 / (9 * c) ** 0.5
        steps.append(chain_step(
            ((torch.rand(cout, c, 3, 3, generator=gen, device=dev) * 2 - 1) * bound).to(dtype),
            ((torch.rand(cout, generator=gen, device=dev) * 2 - 1) * 0.05).to(dtype),
            pre_alpha=alpha, plain_res=residual == "plain"))
        c = cout
    mode = residual if residual in ("input", "extra") else "none"
    r = res if residual == "extra" else None
    n0 = _build.CONV.launches
    got = conv_chain(x, steps, mode, r, backend="cuda")
    assert _build.CONV.launches == n0 + len(steps)
    want = conv_chain(x, steps, mode, r, backend="torch")
    # f32: sums of 9*C products in another order; bf16: the PReLU product
    # rounds alike on both sides, the conv output and the residual add round
    # to bf16 at possibly other ulps (values up to ~3)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_conv_kernel_bf16_without_packed_weights_raises(dev):
    from drba_tpu_torch.ops.conv_chain import conv3x3_cuda

    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(16, 16, 3, 3, dtype=torch.bfloat16, device=dev)
    n0 = _build.CONV.launches
    with pytest.raises(ValueError, match="packed weights"):
        conv3x3_cuda(x, w, torch.zeros(16, dtype=torch.bfloat16, device=dev))
    assert _build.CONV.launches == n0


def _conv_step(gen, dev, cin, cout, pre=False, plain=False, beta=False):
    bound = 1.0 / (9 * cin) ** 0.5
    bf = torch.bfloat16
    return chain_step(
        ((torch.rand(cout, cin, 3, 3, generator=gen, device=dev) * 2 - 1) * bound).to(bf),
        ((torch.rand(cout, generator=gen, device=dev) * 2 - 1) * 0.05).to(bf),
        (1 + 0.2 * torch.randn(cout, generator=gen, device=dev)).to(bf) if beta else None,
        pre_alpha=torch.tensor(-0.3, device=dev).to(bf) if pre else None, plain_res=plain)


@pytest.mark.parametrize("hw", [(19, 37), (17, 70)])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("cin,cout,epilogue", [
    (ci, co, e) for ci, co in ((64, 64), (128, 128), (128, 64), (256, 128), (64, 256))
    for e in ("none", "prelu", "plain", "input", "extra", "beta")
    if ci == co or e in ("none", "prelu", "extra")])
def test_conv_wgmma_kernel_matches_plain(dev, hw, n, cin, cout, epilogue):
    """The wgmma design, forced with path="wgmma", against the plain step on
    ragged maps (no multiple of its 64-column tile or its rows), with every
    epilogue: the pre-PReLU (a negative slope on a patch that straddles the
    frame's zero padding), the plain residual, the chain's input and an
    extra tensor as the final residual, and the ResConv beta (Cin ==
    Cout). Resident weights (64 -> 64, 128 -> 128 and 128 -> 64 in blocks
    of 64 channels, 64 -> 256 in two blocks of 128) and streamed ones
    (256 -> 128)."""
    from drba_tpu_torch.ops.conv_chain import _step_plain, conv3x3_cuda

    gen = torch.Generator(device=dev).manual_seed(cin * 7 + cout + n)
    h, w = hw
    x = (torch.rand(n, h, w, cin, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    extra = (torch.rand(n, h, w, cout, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    st = _conv_step(gen, dev, cin, cout, pre=epilogue in ("prelu", "plain", "input", "extra"),
                    plain=epilogue == "plain", beta=epilogue == "beta")
    res = {"plain": x, "input": x, "extra": extra}.get(epilogue)
    n0 = _build.CONV.launches
    got = conv3x3_cuda(x, st.w, st.b, st.beta, st.wp, st.pre_alpha, res, path="wgmma")
    assert _build.CONV.launches == n0 + 1
    want = _step_plain(x, st, res)
    # the conv output with its bias, and each epilogue op, round to bf16 on
    # both sides, possibly at other ulps (sums of 9 * Cin products in
    # another order); values up to ~3
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (64, 256)])
def test_conv_wgmma_and_mma_kernels_agree(dev, cin, cout):
    """Both bf16 designs at a shape both take (Cin a multiple of 16, Cout of
    64), with the pre-PReLU and an extra residual: f32 sums of the same
    products in another order, then the same roundings."""
    from drba_tpu_torch.ops.conv_chain import conv3x3_cuda

    gen = torch.Generator(device=dev).manual_seed(cin + cout)
    x = (torch.rand(3, 40, 130, cin, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    res = (torch.rand(3, 40, 130, cout, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    st = _conv_step(gen, dev, cin, cout, pre=True)
    args = (x, st.w, st.b, None, st.wp, st.pre_alpha, res)
    a, b = conv3x3_cuda(*args, path="wgmma"), conv3x3_cuda(*args, path="mma")
    # at most one bf16 ulp of the conv output (values up to ~3: 2^-6)
    torch.testing.assert_close(a.float(), b.float(), atol=1.6e-2, rtol=0)


def test_conv_wgmma_refuses_shapes_it_does_not_take(dev):
    """The wrapper refuses the wgmma design for a width outside its rules
    and for f32; the C entry refuses it as well when called directly (no
    fallback: nothing runs and the launch raises)."""
    from drba_tpu_torch.ops.conv_chain import PATHS, conv3x3_cuda

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    for cin, cout in ((12, 64), (64, 96), (64, 2)):
        x = torch.zeros(1, 20, 70, cin, dtype=bf, device=dev)
        st = _conv_step(gen, dev, cin, cout)
        with pytest.raises(ValueError, match="wgmma"):
            conv3x3_cuda(x, st.w, st.b, wp=st.wp, path="wgmma")
        out = torch.empty(1, 20, 70, cout, dtype=bf, device=dev)
        n0 = _build.CONV.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.CONV.launch(x.data_ptr(), st.w.data_ptr(), st.wp.data_ptr(), st.b.data_ptr(),
                               None, None, None, out.data_ptr(), 1, 20, 70, cin, cout, 1,
                               PATHS.index("wgmma"), torch.cuda.current_stream(dev).cuda_stream,
                               device=dev)
        assert _build.CONV.launches == n0
    x = torch.zeros(1, 20, 70, 64, device=dev)
    w = torch.zeros(64, 64, 3, 3, device=dev)
    with pytest.raises(ValueError, match="does not take"):
        conv3x3_cuda(x, w, torch.zeros(64, device=dev), path="wgmma")


def _f32_step(gen, dev, cin, cout, pre=False, plain=False, beta=False):
    bound = 1.0 / (9 * cin) ** 0.5
    return chain_step(
        (torch.rand(cout, cin, 3, 3, generator=gen, device=dev) * 2 - 1) * bound,
        (torch.rand(cout, generator=gen, device=dev) * 2 - 1) * 0.05,
        1 + 0.2 * torch.randn(cout, generator=gen, device=dev) if beta else None,
        pre_alpha=torch.tensor(-0.3, device=dev) if pre else None, plain_res=plain)


@pytest.mark.parametrize("nhw", [(1, 19, 37), (3, 17, 70), (3, 72, 200)])
@pytest.mark.parametrize("cin,cout,epilogue", [
    (ci, co, e) for ci, co in ((64, 64), (128, 128), (192, 192), (384, 192), (64, 256),
                               (9, 64), (12, 64), (14, 64), (64, 2))
    for e in ("none", "prelu", "plain", "input", "extra", "beta")
    if ci == co or e in ("none", "prelu", "extra")])
def test_conv_tf32_kernel_matches_plain(dev, nhw, cin, cout, epilogue):
    """The f32 design (3xTF32 on mma.sync), forced with path="tf32", against
    the plain step on ragged maps (no multiple of its 32-column tile or its
    rows), with every epilogue: the pre-PReLU (a negative slope on a patch
    that straddles the frame's zero padding), the plain residual, the
    chain's input and an extra tensor as the final residual, and the
    ResConv beta (Cin == Cout). Cin 9 / 14 (no multiple of 4: staged by
    plain loads) and 12 (cp.async of 4 channels), each padded to 8 in K;
    Cout 2 (one masked n8 tile, unpaired stores), 256 (four 64-channel
    blocks); the maps take the launcher's tile plans from 2 to 8 rows."""
    from drba_tpu_torch.ops.conv_chain import _step_plain, conv3x3_cuda

    n, h, w = nhw
    gen = torch.Generator(device=dev).manual_seed(cin * 7 + cout + n + h)
    x = torch.rand(n, h, w, cin, generator=gen, device=dev) * 2 - 1
    extra = torch.rand(n, h, w, cout, generator=gen, device=dev) * 2 - 1
    st = _f32_step(gen, dev, cin, cout, pre=epilogue in ("prelu", "plain", "input", "extra"),
                   plain=epilogue == "plain", beta=epilogue == "beta")
    res = {"plain": x, "input": x, "extra": extra}.get(epilogue)
    n0 = _build.CONV.launches
    got = conv3x3_cuda(x, st.w, st.b, st.beta, st.wp, st.pre_alpha, res, path="tf32")
    assert _build.CONV.launches == n0 + 1
    want = _step_plain(x, st, res)
    # f32 sums of 9 * Cin products in another order, each product 3xTF32
    # (about 2^-21 of it off); values up to ~3
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_conv_tf32_kernel_matches_its_emulation(dev):
    """The kernel's products as ``conv3x3_tf32_plain`` emulates them (the
    same split, the same three TF32 products per K chunk and tap): within
    f32 summation order of each other, far closer than either is to a
    single TF32 product."""
    from drba_tpu_torch.ops.conv_chain import conv3x3_cuda, conv3x3_tf32_plain

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand(2, 21, 45, 128, generator=gen, device=dev) * 2 - 1
    st = _f32_step(gen, dev, 128, 64)
    got = conv3x3_cuda(x, st.w, st.b, wp=st.wp)
    emu = conv3x3_tf32_plain(x, st.wp, st.b)
    torch.testing.assert_close(got, emu, atol=2e-5, rtol=0)


def test_conv_tf32_refuses_weights_not_split_for_it(dev):
    """The f32 kernel reads only ``pack_weights_tf32``'s layout: the bf16
    layout (even cast to f32), no packed weights at all, and a bf16 design
    for an f32 step are refused before anything launches; the C entry
    refuses an f32 call on a bf16 design as well."""
    from drba_tpu_torch.ops.conv_chain import PATHS, conv3x3_cuda, pack_weights

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.zeros(1, 20, 70, 64, device=dev)
    st = _f32_step(gen, dev, 64, 64)
    n0 = _build.CONV.launches
    with pytest.raises(ValueError, match="wp: expected"):
        conv3x3_cuda(x, st.w, st.b, wp=pack_weights(st.w))
    with pytest.raises(TypeError, match="wp"):
        conv3x3_cuda(x, st.w, st.b, wp=st.wp.to(torch.bfloat16))
    with pytest.raises(ValueError, match="packed weights"):
        conv3x3_cuda(x, st.w, st.b)
    for path in ("mma", "wgmma"):
        with pytest.raises(ValueError, match="does not take"):
            conv3x3_cuda(x, st.w, st.b, wp=st.wp, path=path)
    assert _build.CONV.launches == n0
    out = torch.empty_like(x)
    for path in ("mma", "wgmma"):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.CONV.launch(x.data_ptr(), st.w.data_ptr(), st.wp.data_ptr(), st.b.data_ptr(),
                               None, None, None, out.data_ptr(), 1, 20, 70, 64, 64, 0,
                               PATHS.index(path), torch.cuda.current_stream(dev).cuda_stream,
                               device=dev)
    assert _build.CONV.launches == n0


def test_gmfss_f32_window_launch_counts(dev):
    """An f32 T=3 window runs 44 conv chain steps: FeatureNet's levels 1-3
    for I2 (3), MetricNet (5), GridNet's L0 (14), L1 (12) and L2 (10: the
    four stride-1 blocks' two steps, the two stride-2 blocks' trailing
    conv), where bf16 runs 32 (``test_gmfss_window_launch_counts``)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    base = torch.rand(1, 128, 192 + 12, 3, generator=gen, device=dev)
    fr = [base[:, :, 6 * i:6 * i + 192].contiguous() for i in range(3)]
    m = _graph_model("gmfss", torch.float32, dev)
    _, reuse = m.inference_ts_drba(*fr, [0.7, 1.1], None, linear=True)
    before = _build.counts()
    m.inference_ts_drba(*fr, [0.6, 1.0, 1.4], reuse, linear=True)
    after = _build.counts()
    assert after["conv_chain"] - before["conv_chain"] == 44


def test_rife_1080p_window_kernel_path_matches_plain(dev):
    """The 1080p window on the kernel path against the plain path, in f32 and
    bf16, with the same seed-0 model; every kernel of the RIFE path launches."""
    from drba_tpu_torch.config import DEFAULT, F32
    from drba_tpu_torch.models.rife import RIFE

    gen = torch.Generator(device=dev).manual_seed(3)
    base = torch.rand(1, 1088, 1920 + 12, 3, generator=gen, device=dev)
    fr = [base[:, :, 6 * i:6 * i + 1920].contiguous() for i in range(3)]
    for cfg, mean_tol in ((F32, 1e-4), (DEFAULT, 1e-2)):
        m = RIFE(config=cfg, device=dev)
        plain = RIFE(config=cfg.replace(splat_backend="torch", warp_backend="torch",
                                        conv_backend="torch"), device=dev)
        frames = [f.to(cfg.compute_dtype) for f in fr]
        before = _build.counts()
        got, reuse = m.inference_ts_drba(*frames, [0.7, 1.1], None, linear=True)
        after = _build.counts()
        assert all(after[k] > before[k] for k in ("splat", "warp", "conv_chain"))
        # a T=3 window with the reuse chained: both directions of every stage
        # and of the merge in one launch each, 5 warp launches in all
        w0 = _build.WARP.launches
        m.inference_ts_drba(*frames, [0.6, 1.0, 1.4], reuse, linear=True)
        assert _build.WARP.launches - w0 == 5
        want, _ = plain.inference_ts_drba(*frames, [0.7, 1.1], None, linear=True)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (1, 1088, 1920, 3) and bool(torch.isfinite(g).all())
            # atomic/FMA order (f32) and bf16 rounding at other places, amplified
            # through five random-weight stages; coverage thresholds may flip pixels
            d = (g.float() - w.float()).abs()
            assert float(d.mean()) <= mean_tol
            assert float((d > 1e-2).float().mean()) <= 5e-3


# ------------------------------------------------------------------------------ attention kernels


def _qkv(gen, shape, dev, dtype, scale=1.0):
    return [(torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype) for _ in range(3)]


# bf16: the scores are exact bf16 products summed in f32 on both sides; the
# kernel rounds P to bf16 for the tensor-core P.V (relative 2^-9 per weight)
# and both round the output to bf16 (2^-8)
_ATTN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernel_matches_plain(dev, dtype, masked):
    """(B, L, c) windows with region ids; L spans several key tiles and is
    not a tile multiple."""
    from drba_tpu_torch.ops.attention import window_attention

    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = _qkv(gen, (3, 300, 128), dev, dtype)
    rid = torch.randint(0, 4, (3, 300), generator=gen, device=dev) if masked else None
    n0 = _build.WINDOW.launches
    got = window_attention(q, k, v, rid, masked, backend="cuda")
    want = window_attention(q, k, v, rid, masked, backend="torch")
    assert _build.WINDOW.launches == n0 + 1
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_nhwc_kernel_matches_plain(dev, dtype, masked):
    from drba_tpu_torch.models.gmflow_net import shift_region_labels
    from drba_tpu_torch.ops.attention import window_attention_nhwc

    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = _qkv(gen, (2, 24, 40, 128), dev, dtype)
    lab = shift_region_labels(24, 40, 2)
    got = window_attention_nhwc(q, k, v, 2, lab, masked, backend="cuda")
    want = window_attention_nhwc(q, k, v, 2, lab, masked, backend="torch")
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b", [1, 2])
def test_flash_attention_kernel_matches_plain(dev, dtype, masked, b):
    """A 2-wide f32 value of pixel coordinates, as in the global correlation:
    one grid broadcast over the batch (a non-contiguous view). The keys
    split over several blocks at both batch sizes and in both dtypes
    (L = 1100 gives few query tiles), with the second, combining launch."""
    from drba_tpu_torch.ops.attention import flash_attention, flash_split_plan

    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, _ = _qkv(gen, (b, 1100, 128), dev, dtype, scale=0.3)
    v = (torch.rand(1, 1100, 2, generator=gen, device=dev) * 240).expand(b, 1100, 2)
    rid = torch.randint(0, 3, (b, 1100), generator=gen, device=dev) if masked else None
    n_split, _ = flash_split_plan(b, 1100, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count)
    assert n_split > 1
    n0 = _build.FLASH.launches
    got = flash_attention(q, k, v, rid, masked, out_dtype=torch.float32, backend="cuda")
    want = flash_attention(q, k, v, rid, masked, out_dtype=torch.float32, backend="torch")
    assert _build.FLASH.launches == n0 + (2 if n_split > 1 else 1)
    # P.V in f32 on both sides; sums of 1100 terms in another order, at values <= 240
    torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_in_layer_geometry_matches_plain(dev, dtype):
    """The transformer layer's middle launch at scale 1, (4, 136, 240) k = 8
    (L = 510, ragged against the 64-key tile): q|k|v interleaved in one
    (B, H, W, 384) map (token strides 3c, 3c, 3c and c for the output),
    keys and values from the other batch half (half = 2), shift labels."""
    from drba_tpu_torch.models.gmflow_net import shift_region_labels
    from drba_tpu_torch.ops.attention import window_attention_nhwc
    from drba_tpu_torch.ops.attn_layer import layer_window_attention

    gen = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn(4, 136, 240, 384, generator=gen, device=dev).to(dtype)
    lab = shift_region_labels(136, 240, 8)
    n0 = _build.WINDOW.launches
    got = layer_window_attention(qkv, 8, lab, with_mask=True, cross_swap=True)
    assert _build.WINDOW.launches == n0 + 1
    q, k, v = qkv.split(128, dim=-1)
    swap = lambda t: torch.cat([t[2:], t[:2]])
    want = window_attention_nhwc(q, swap(k), swap(v), 8, lab, True, backend="torch")
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def _layer_params(dev, dtype, seed):
    from drba_tpu_torch.convert import from_jax_params
    from drba_tpu_torch.models.gmflow_net import GMFLOW_SPEC, pack_transformer_weights
    from drba_tpu_torch.models.layers import init_from_spec

    return pack_transformer_weights(
        {k: v.to(dev, dtype) for k, v in
         from_jax_params(init_from_spec(GMFLOW_SPEC, seed=seed), GMFLOW_SPEC).items()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cross,masked", [(False, False), (False, True), (True, True)])
def test_transformer_layer_kernel_matches_plain(dev, dtype, cross, masked):
    """Self layers (no FFN) and a cross layer (hidden 1024, batch-half swap,
    a separate target), with and without the shift mask, on weights packed
    as GMFSS packs them; 8160 tokens, no multiple of the 128-token tile."""
    from drba_tpu_torch.models.gmflow_net import shift_region_labels
    from drba_tpu_torch.ops.attn_layer import layer_weights, transformer_layer

    p = _layer_params(dev, dtype, 7)
    gen = torch.Generator(device=dev).manual_seed(7)
    x, tgt, _ = _qkv(gen, (4, 34, 60, 128), dev, dtype, scale=0.5)
    base = f"transformer.layers.1.{'cross_attn_ffn' if cross else 'self_attn'}"
    wt = layer_weights(p, base, cross)
    chunk = 16 if dtype == torch.float32 else 64  # hidden columns of a packed FFN chunk
    assert wt.ffn is None or wt.ffn_p.shape[0] * chunk == 1024
    kw = dict(labels=shift_region_labels(34, 60, 2), with_mask=masked, cross_swap=cross,
              target=tgt if cross else None)
    n0 = _build.LAYER.launches
    got = transformer_layer(x, wt, 2, backend="cuda", **kw)
    want = transformer_layer(x, wt, 2, backend="torch", **kw)
    assert _build.LAYER.launches == n0 + 2
    # f32: sums in another order; bf16: the kernel keeps the merge, the norms
    # and the FFN sum in f32 where the plain ops round each to bf16, and
    # rounds P, so outputs of size ~4 may differ by a few bf16 ulps (2^-6)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,ks,masked,swap", [
    ((2, 24, 40, 128), 2, False, False),   # L = 240: three full key tiles and a ragged one
    ((2, 24, 40, 128), 2, True, False),
    ((4, 34, 60, 128), 2, True, True),     # L = 510, the batch-half swap
    ((4, 18, 30, 128), 3, False, True),    # L = 60: one ragged tile, no full one
])
def test_f32_window_attention_on_tensor_cores_matches_plain(dev, shape, ks, masked, swap):
    """The f32 window kernel (3xTF32 on mma.sync): ragged L, masked and
    unmasked, keys and values from the other batch half; f32's tolerance."""
    from drba_tpu_torch.models.gmflow_net import shift_region_labels
    from drba_tpu_torch.ops.attention import launch_window, window_attention_nhwc

    b, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = _qkv(gen, shape, dev, torch.float32)
    lab = shift_region_labels(h, w, ks)
    if swap:
        from drba_tpu_torch.ops.attention import device_labels

        out = torch.empty_like(q)
        lab_t = device_labels(lab.reshape(ks * ks, -1), dev) if masked else None
        n0 = _build.WINDOW.launches
        launch_window(q, k, v, out, b, h, w, ks, (c, c, c, c), lab_t,
                      ((h // ks) * (w // ks), 0), b // 2)
        assert _build.WINDOW.launches == n0 + 1
        sw = lambda t: torch.cat([t[b // 2:], t[:b // 2]])
        want = window_attention_nhwc(q, sw(k), sw(v), ks, lab, masked, backend="torch")
    else:
        out = window_attention_nhwc(q, k, v, ks, lab, masked, backend="cuda")
        want = window_attention_nhwc(q, k, v, ks, lab, masked, backend="torch")
    torch.testing.assert_close(out, want, atol=_ATTN_TOL[torch.float32][0], rtol=0)


@pytest.mark.parametrize("b,L", [(40, 1700), (1, 8160), (2, 300)])
@pytest.mark.parametrize("masked", [False, True])
def test_f32_flash_attention_splits_keys_like_bf16(dev, b, L, masked):
    """f32 flash with one key split (40 x 14 query tiles fill the card) and
    with several (B = 1, L = 8160: GMFlow's global correlation, 8 splits),
    each against the plain version; the second launch exactly when split."""
    from drba_tpu_torch.ops.attention import flash_attention, flash_split_plan

    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, _ = _qkv(gen, (b, L, 128), dev, torch.float32, scale=0.3)
    v = (torch.rand(1, L, 2, generator=gen, device=dev) * 119).expand(b, L, 2)
    rid = torch.randint(0, 9, (1, L), generator=gen, device=dev).expand(b, L) if masked else None
    n_split, _ = flash_split_plan(b, L, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count)
    assert (n_split == 1) == (b == 40) and (b != 1 or n_split == 8)
    n0 = _build.FLASH.launches
    got = flash_attention(q, k, v, rid, masked, out_dtype=torch.float32, backend="cuda")
    assert _build.FLASH.launches == n0 + (2 if n_split > 1 else 1)
    want = flash_attention(q, k, v, rid, masked, out_dtype=torch.float32, backend="torch")
    # P.V in f32 on both sides; sums of L terms in another order, at values <= 119
    torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-5)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("hw,ks", [((18, 30), 2), ((9, 15), 1)])
def test_f32_layer_on_tensor_cores_matches_plain(dev, cross, hw, ks):
    """The f32 projection and tail (3xTF32 on mma.sync, weights streamed
    split) with and without the FFN, on token counts that are no multiple
    of the 128-token tile (2 x 18 x 30 = 1080, 2 x 9 x 15 = 270); each
    launch against its plain steps, and the layer as a whole."""
    from drba_tpu_torch.models.gmflow_net import shift_region_labels
    from drba_tpu_torch.models.layers import gelu, layer_norm, linear
    from drba_tpu_torch.ops.attn_layer import (layer_proj_cuda, layer_tail_cuda,
                                               layer_weights, transformer_layer)

    p = _layer_params(dev, torch.float32, 8)
    gen = torch.Generator(device=dev).manual_seed(13)
    x, tgt, av = _qkv(gen, (2, *hw, 128), dev, torch.float32, scale=0.5)
    base = f"transformer.layers.2.{'cross_attn_ffn' if cross else 'self_attn'}"
    wt = layer_weights(p, base, cross)
    t = tgt if cross else x
    qkv = layer_proj_cuda(x, t, wt.qkv_p)
    want = torch.cat([x @ wt.wq, t @ wt.wk, t @ wt.wv], dim=-1)
    torch.testing.assert_close(qkv, want, atol=1e-4, rtol=1e-4)
    q = {"merge.weight": wt.wmerge, "norm1.weight": wt.norm1[0], "norm1.bias": wt.norm1[1]}
    msg = layer_norm(q, "norm1", linear(q, "merge", av))
    if cross:
        q.update({"mlp.0.weight": wt.ffn[0], "mlp.2.weight": wt.ffn[1],
                  "norm2.weight": wt.ffn[2], "norm2.bias": wt.ffn[3]})
        msg = linear(q, "mlp.0", torch.cat([x, msg], dim=-1))
        msg = layer_norm(q, "norm2", linear(q, "mlp.2", gelu(msg)))
    torch.testing.assert_close(layer_tail_cuda(x, av, wt), x + msg, atol=1e-4, rtol=1e-4)
    kw = dict(labels=shift_region_labels(*hw, ks), with_mask=cross and ks > 1,
              cross_swap=cross, target=tgt if cross else None)
    got = transformer_layer(x, wt, ks, backend="cuda", **kw)
    torch.testing.assert_close(got, transformer_layer(x, wt, ks, backend="torch", **kw),
                               atol=1e-4, rtol=1e-4)


def test_layer_kernels_without_packed_weights_raise(dev):
    from drba_tpu_torch.convert import from_jax_params
    from drba_tpu_torch.models.gmflow_net import GMFLOW_SPEC
    from drba_tpu_torch.models.layers import init_from_spec
    from drba_tpu_torch.ops.attn_layer import layer_weights, transformer_layer

    p = {k: v.to(dev, torch.bfloat16) for k, v in
         from_jax_params(init_from_spec(GMFLOW_SPEC, seed=1), GMFLOW_SPEC).items()}
    x = torch.zeros(2, 8, 8, 128, dtype=torch.bfloat16, device=dev)
    n0 = _build.LAYER.launches
    with pytest.raises(ValueError, match="packed weights"):
        transformer_layer(x, layer_weights(p, "transformer.layers.0.self_attn", False), 2)
    assert _build.LAYER.launches == n0


def test_gmfss_window_launch_counts(dev):
    """One T=3 window with the reuse chained: one GMFlow pass (24 layers, a
    projection and a tail launch each), four softsplats (the DRM
    alignment, three pyramid levels), two splat launches each, and 32 conv
    chain steps: FeatureNet's level 1 for I2 (1), MetricNet (5), GridNet's
    L0 (14) and L1 (12) steps."""
    from drba_tpu_torch.models.gmfss import GMFSS

    gen = torch.Generator(device=dev).manual_seed(11)
    base = torch.rand(1, 128, 192 + 12, 3, generator=gen, device=dev)
    fr = [base[:, :, 6 * i:6 * i + 192].contiguous().to(torch.bfloat16) for i in range(3)]
    m = GMFSS(device=dev)
    _, reuse = m.inference_ts_drba(*fr, [0.7, 1.1], None, linear=True)
    before = _build.counts()
    m.inference_ts_drba(*fr, [0.6, 1.0, 1.4], reuse, linear=True)
    after = _build.counts()
    assert after["transformer_layer"] - before["transformer_layer"] == 48
    assert after["splat"] - before["splat"] == 8
    assert after["conv_chain"] - before["conv_chain"] == 32


def test_gmfss_window_kernel_path_matches_plain(dev):
    """A small GMFSS window on the kernel path against the plain path, f32
    and bf16; every kernel of the path launches."""
    from drba_tpu_torch.config import DEFAULT, F32
    from drba_tpu_torch.models.gmfss import GMFSS

    gen = torch.Generator(device=dev).manual_seed(8)
    base = torch.rand(1, 256, 384 + 12, 3, generator=gen, device=dev)
    fr = [base[:, :, 6 * i:6 * i + 384].contiguous() for i in range(3)]
    for cfg, mean_tol in ((F32, 1e-4), (DEFAULT, 1e-2)):
        m = GMFSS(config=cfg, device=dev)
        plain = GMFSS(config=cfg.replace(splat_backend="torch", warp_backend="torch",
                                         attn_backend="torch", conv_backend="torch"), device=dev)
        frames = [f.to(cfg.compute_dtype) for f in fr]
        before = _build.counts()
        got, _ = m.inference_ts_drba(*frames, [0.7, 1.1], None, linear=True)
        after = _build.counts()
        for name in ("splat", "warp", "conv_chain", "window_attention",
                     "flash_attention", "transformer_layer"):
            assert after[name] > before[name], name
        want, _ = plain.inference_ts_drba(*frames, [0.7, 1.1], None, linear=True)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (1, 256, 384, 3) and bool(torch.isfinite(g).all())
            d = (g.float() - w.float()).abs()
            assert float(d.mean()) <= mean_tol
            assert float((d > 1e-2).float().mean()) <= 5e-2


# ------------------------------------------------------------------- devices, union, scene flags


def test_kernels_launch_on_their_tensors_device():
    """With card 0 current, every kernel on tensors of card 1 runs there and
    agrees with its plain version; card 0 stays current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from drba_tpu_torch.ops.attention import flash_attention, window_attention_nhwc

    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    gen = torch.Generator(device=d1).manual_seed(21)
    img = torch.rand(2, 64, 96, 19, generator=gen, device=d1)
    flow = _flow(gen, 2, 64, 96, 6.0, d1)
    metric = torch.randn(2, 64, 96, 1, generator=gen, device=d1)
    x = torch.rand(1, 16, 24, 32, generator=gen, device=d1)
    st = chain_step(torch.randn(32, 32, 3, 3, generator=gen, device=d1) * 0.05,
                    torch.zeros(32, device=d1), torch.ones(32, device=d1))
    q, k, v = (torch.randn(2, 16, 24, 128, generator=gen, device=d1) for _ in range(3))
    qf, kf = (torch.randn(1, 384, 128, generator=gen, device=d1) * 0.3 for _ in range(2))
    vf = torch.rand(1, 384, 2, generator=gen, device=d1)
    for kern, plain, tol in (
            (lambda: softsplat(img, flow, metric, "soft", backend="cuda"),
             lambda: softsplat(img, flow, metric, "soft", backend="torch"), 1e-4),
            (lambda: backwarp(img, flow, backend="cuda"),
             lambda: backwarp(img, flow, backend="torch"), 1e-5),
            (lambda: conv_chain(x, [st], backend="cuda"),
             lambda: conv_chain(x, [st], backend="torch"), 1e-4),
            (lambda: window_attention_nhwc(q, k, v, 2, None, False, backend="cuda"),
             lambda: window_attention_nhwc(q, k, v, 2, None, False, backend="torch"), 2e-5),
            (lambda: flash_attention(qf, kf, vf, None, False, out_dtype=torch.float32,
                                     backend="cuda"),
             lambda: flash_attention(qf, kf, vf, None, False, out_dtype=torch.float32,
                                     backend="torch"), 2e-3)):
        got = kern()
        assert got.device == d1 and torch.cuda.current_device() == 0
        torch.testing.assert_close(got, plain(), atol=tol, rtol=1e-5)


def test_union_window_launches_all_six_kernels_and_matches_plain(dev):
    """A small GMFSS_UNION T=3 window (256x384, divisible by its pad of 128)
    on the kernel path against the plain path in f32 and bf16; the window
    launches all six kernels: GMFlow's layers, window and flash attention,
    the splats, the warps and the auxiliary IFNet's conv chain."""
    from drba_tpu_torch.config import DEFAULT, F32
    from drba_tpu_torch.models.gmfss_union import GMFSS_UNION

    gen = torch.Generator(device=dev).manual_seed(9)
    base = torch.rand(1, 256, 384 + 12, 3, generator=gen, device=dev)
    fr = [base[:, :, 6 * i:6 * i + 384].contiguous() for i in range(3)]
    for cfg, mean_tol in ((F32, 1e-4), (DEFAULT, 1e-2)):
        m = GMFSS_UNION(config=cfg, device=dev)
        plain = GMFSS_UNION(config=cfg.replace(splat_backend="torch", warp_backend="torch",
                                               conv_backend="torch", attn_backend="torch"),
                            device=dev)
        frames = [f.to(cfg.compute_dtype) for f in fr]
        reuse = m.reuse(frames[1], frames[0])
        before = _build.counts()
        got, _ = m.inference_ts_drba(*frames, [0.6, 1.0, 1.4], reuse, linear=True)
        after = _build.counts()
        for name in ("splat", "warp", "conv_chain", "window_attention", "flash_attention",
                     "transformer_layer"):
            assert after[name] > before[name], name
        want, _ = plain.inference_ts_drba(*frames, [0.6, 1.0, 1.4], reuse, linear=True)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (1, 256, 384, 3) and bool(torch.isfinite(g).all())
            d = (g.float() - w.float()).abs()
            assert float(d.mean()) <= mean_tol
            # the 25x timestep swap and the < 0.999 hole fill flip pixels on
            # rounding-level differences, as the coverage thresholds do in GMFSS
            assert float((d > 1e-2).float().mean()) <= 5e-2


def test_scene_flag_resolves_while_the_compute_stream_is_busy(dev):
    """The prefetch thread uploads and scores each frame on its own stream:
    with the loop's stream kept busy, frames read only after that stream got
    its work still get their flags while it has not finished. As in
    ``run_pipeline``, the loop's thread uploads and scores the first frames
    first (which also loads the kernels these steps use)."""
    import threading

    import numpy as np

    from drba_tpu_torch.pipeline import _Prefetcher
    from drba_tpu_torch.utils import to_inp
    from drba_tpu_torch.utils.scdet import scene_ssim

    go = threading.Event()

    class _IO:
        def __init__(self, frames):
            self._frames = list(frames)

        def read_frame(self):
            assert go.wait(30)  # decode only once the loop's stream is busy
            return self._frames.pop(0) if self._frames else None

    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 255, (64, 128, 3), np.uint8)
    prev = to_inp(u8, (64, 128), torch.float32, dev)
    assert float(scene_ssim(prev, prev)) > 0.99
    pf = _Prefetcher(_IO([u8, 255 - u8]), (64, 128), torch.float32, dev, prev=prev)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev)
    torch.cuda._sleep(2_000_000_000)  # ~1 s of spinning on the loop's stream
    go.set()
    same, inverted = pf.next(), pf.next()
    assert not same.cut(0.3) and inverted.cut(0.3)
    assert not stream.query(), "the flags waited for the loop's stream"
    x = inverted.take()
    assert pf.next() is None
    torch.cuda.synchronize()
    torch.testing.assert_close(x, 1 - prev, atol=1e-6, rtol=0)


def test_download_comes_down_pinned_without_a_stream_sync(dev):
    """``to_uint8`` from the card: the values of the pageable copy, bit for
    bit, without a synchronising call (a pageable copy, a stream sync) while
    the loop's stream is busy: the download waits on its own event."""
    from drba_tpu_torch.utils.imageproc import to_uint8

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand(1, 108, 192, 3, generator=gen, device=dev).to(torch.bfloat16)
    want = (x[0].float() * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # keep the stream busy behind the download
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = to_uint8(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.dtype == want.dtype and got.shape == (108, 192, 3)
    assert (got == want).all()


def test_emitter_holds_no_pinned_memory_behind_a_slow_sink(dev):
    """The download pool's frames come down through pinned memory but reach
    the sink in pageable memory: a sink that keeps every frame (an encoder
    whose queue fills) leaves the caching host allocator no more blocks
    than the copies in flight, and the frames are the pageable copy's."""
    from drba_tpu_torch.pipeline import PipelineStats, _Emitter

    class _KeepAll:
        def __init__(self):
            self.frames = []

        def write_frame(self, arr):
            self.frames.append(arr)

    n, workers = 48, 4
    gen = torch.Generator(device=dev).manual_seed(6)
    xs = [torch.rand(1, 64, 128, 3, generator=gen, device=dev) for _ in range(n)]
    want = [(x[0] * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy() for x in xs]
    torch.cuda.synchronize()
    before = torch.cuda.host_memory_stats()["allocations.current"]
    sink, stats = _KeepAll(), PipelineStats()
    em = _Emitter(sink, (64, 128), stats, workers=workers)
    for x in xs:
        em.emit(x)
    em.finish()
    assert stats.frames_out == n and len(sink.frames) == n
    grown = torch.cuda.host_memory_stats()["allocations.current"] - before
    assert grown <= 2 * workers, grown
    assert not any(torch.from_numpy(a).is_pinned() for a in sink.frames)
    for got, w in zip(sink.frames, want):
        assert (got == w).all()


def test_download_queued_behind_a_long_kernel_waits_in_d2h_wait(dev):
    """A frame whose download is queued behind a long kernel on the
    stream: its ``download`` span holds the wait as ``d2h-wait``, and the
    ``copy-out`` after it is short."""
    from drba_tpu_torch.pipeline import PipelineStats, _Emitter
    from drba_tpu_torch.utils import profiling

    class _Sink:
        def write_frame(self, arr):
            self.frame = arr

    x = torch.rand(1, 64, 128, 3, generator=torch.Generator(device=dev).manual_seed(7),
                   device=dev)
    want = (x[0] * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
    torch.cuda.synchronize()
    sink, stats = _Sink(), PipelineStats()
    with profiling.tracer() as st:
        em = _Emitter(sink, (64, 128), stats, workers=1, tracer=st)
        torch.cuda._sleep(1_000_000_000)  # about 0.5 s of spinning before the download
        em.emit(x)
        em.finish()
    assert stats.frames_out == 1 and (sink.frame == want).all()
    (dl,), (wait,), (out,) = ([r for r in st.records if r.name == name]
                              for name in ("download", "d2h-wait", "copy-out"))
    assert wait.parent == out.parent == dl.id
    assert dl.start_ns <= wait.start_ns <= wait.end_ns <= out.start_ns <= out.end_ns <= dl.end_ns
    assert wait.seconds > 0.2, wait.seconds
    assert out.seconds < 0.02 and wait.seconds > 0.9 * dl.seconds, (out.seconds, dl.seconds)


# ------------------------------------------------------------- dispatch threads, the planner


def _card_windows(dev, dtype, n=4):
    gen = torch.Generator(device=dev).manual_seed(12)
    base = torch.rand(1, 128, 192 + 6 * (n + 2), 3, generator=gen, device=dev)
    fr = [base[:, :, 6 * i:6 * i + 192].contiguous().to(dtype) for i in range(n + 2)]
    ts = ([0.6, 1.0, 1.4], [0.8, 1.2])
    return [(fr[k], fr[k + 1], fr[k + 2], ts[k % 2]) for k in range(n)]


def test_two_dispatch_threads_on_one_card_match_one_thread(dev):
    """The planner with two GMFSS replicas on one card (two dispatch
    threads, two streams) against the serial chain on one thread, bf16:
    within the bf16 window gate (the splat's f32 atomics add in any order,
    so two runs need not agree in their last bits); every kernel of the path
    launches."""
    from drba_tpu_torch.models.gmfss import GMFSS
    from drba_tpu_torch.parallel.batch import WindowPlanner

    m = GMFSS(device=dev)
    windows = _card_windows(dev, torch.bfloat16)
    want, reuse = [], None
    for w in windows:
        out, reuse = m.inference_ts_drba(*w, reuse, linear=True)
        want.append(out)
    planner = WindowPlanner([dev, dev], m)
    try:
        before = _build.counts()
        got = list(planner.run(windows))
        torch.cuda.synchronize()
        after = _build.counts()
    finally:
        planner.close()
    for name in ("splat", "warp", "window_attention", "flash_attention", "transformer_layer"):
        assert after[name] > before[name], name
    for g, w in zip(got, want):
        assert len(g) == len(w)
        d = torch.stack([(a.float() - b.float()).abs() for a, b in zip(g, w)])
        assert float(d.mean()) <= 1e-2 and float((d > 1e-2).float().mean()) <= 5e-2


def test_device_labels_cache_is_safe_across_streams(dev):
    """A label tensor cached while its uploading stream is busy is whole
    when another stream reads it at once: the upload is a blocking copy."""
    import numpy as np

    from drba_tpu_torch.ops.attention import device_labels

    lab = np.arange(64 * 4099, dtype=np.int32).reshape(64, 4099)  # a shape nothing else caches
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        torch.cuda._sleep(500_000_000)  # s1 busy for a while
        t = device_labels(lab, dev)
    with torch.cuda.stream(s2):
        got = t.clone()  # no wait on s1
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy(), lab)


def test_launch_counts_are_exact_under_two_threads(dev):
    """Two threads launching the warp kernel at once, each on a stream of
    its own, with the interpreter switching threads often: every launch is
    counted."""
    import sys
    import threading

    gen = torch.Generator(device=dev).manual_seed(13)
    img = torch.rand(1, 16, 32, 3, generator=gen, device=dev)
    flow = _flow(gen, 1, 16, 32, 3.0, dev)
    backwarp(img, flow, backend="cuda")  # built and loaded
    n, errors = 300, []

    def launch():
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for _ in range(n):
                    backwarp(img, flow, backend="cuda")
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n0 = _build.WARP.launches
        threads = [threading.Thread(target=launch) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        assert _build.WARP.launches - n0 == 2 * n
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()


def test_planner_on_two_cards_matches_the_serial_chain():
    """RIFE windows over two cards against the serial chain on card 0, f32;
    the carry crosses once per group boundary (frames given as tensors on
    card 0 are copied to card 1, and counted)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from drba_tpu_torch.config import F32
    from drba_tpu_torch.models.rife import RIFE
    from drba_tpu_torch.parallel.batch import WindowPlanner, exchange_accounting

    torch.backends.cudnn.allow_tf32 = False
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    m = RIFE(config=F32, device=d0)
    windows = _card_windows(d0, torch.float32)
    want, reuse = [], None
    for w in windows:
        out, reuse = m.inference_ts_drba(*w, reuse, linear=True)
        want.append(out)
    planner = WindowPlanner([d0, d1], m)
    try:
        got = list(planner.run(windows))
        acc = exchange_accounting(planner, windows)
    finally:
        planner.close()
    assert [g[0].device for g in got] == [d0, d1, d0, d1]
    for g, w in zip(got, want):
        d = torch.stack([(a.to(d0) - b).abs() for a, b in zip(g, w)])
        # f32: the splat's atomics in another order, through five IFNet stages
        assert float(d.mean()) <= 1e-4 and float((d > 1e-2).float().mean()) <= 1e-3
    assert acc["carries"] == [(0, 1)] and acc["frames"] == 3


# ------------------------------------------------------------------- the window as a CUDA graph

# the window gates of chip_smoke.py (GATES), per dtype: (mean abs, share of
# values off by more than 1e-2). The graph runs the eager window's kernels in
# the same order; the splat's f32 atomics add in any order, and five IFNet
# stages or GMFlow's 24 layers amplify that, so graph and eager need not
# agree bitwise
_GRAPH_GATES = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-2, 5e-2)}
_GRAPH_SIZES = {"rife": (128, 256), "gmfss": (128, 192), "gmfss_union": (256, 384)}


def _graph_model(name, dtype, dev):
    import importlib

    from drba_tpu_torch.config import DEFAULT

    module, cls = {"rife": ("rife", "RIFE"), "gmfss": ("gmfss", "GMFSS"),
                   "gmfss_union": ("gmfss_union", "GMFSS_UNION")}[name]
    model = getattr(importlib.import_module(f"drba_tpu_torch.models.{module}"), cls)
    return model(config=DEFAULT.replace(compute_dtype=dtype), device=dev)


def _graph_windows(name, dtype, dev, n=5):
    """``n`` chained windows at 24 -> 60's alternating T = 3, 2, and the
    chain start's reuse."""
    h, w = _GRAPH_SIZES[name]
    gen = torch.Generator(device=dev).manual_seed(17)
    base = torch.rand(1, h, w + 6 * (n + 2), 3, generator=gen, device=dev)
    fr = [base[:, :, 6 * i:6 * i + w].contiguous().to(dtype) for i in range(n + 2)]
    ts = ([0.6, 1.0, 1.4], [0.8, 1.2])
    return [(fr[k], fr[k + 1], fr[k + 2], ts[k % 2]) for k in range(n)]


def _eager_window(m, I0, I1, I2, ts, reuse):
    """The eager pieces the graph fuses: the window's pass, then its
    timesteps (the model's ``_fused_window``, called directly: no graph)."""
    from drba_tpu_torch import graphs

    host = graphs.host_timesteps(ts)
    out, nxt = m._fused_window(I0, I1, I2, m._ts(host), host, reuse, True)
    return list(out.unbind(0)), nxt


def _tensors(tree):
    from drba_tpu_torch.graphs import _leaves

    return _leaves(tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["rife", "gmfss", "gmfss_union"])
def test_graphed_window_matches_its_eager_pieces(dev, name, dtype):
    """A chain of windows through ``inference_ts_drba`` (the first T = 3 and
    T = 2 windows capture, the rest replay) against the eager pieces'
    chain from the same reuse, within chip_smoke's GATES; a replay's frames
    and reuse outlive the next replays; N replays count the launches of N
    eager windows."""
    from collections import Counter

    from drba_tpu_torch import graphs

    m = _graph_model(name, dtype, dev)
    windows = _graph_windows(name, dtype, dev)
    reuse = m.reuse(windows[0][1], windows[0][0])
    for w in windows[:2]:  # the captures
        _, reuse = m.inference_ts_drba(*w, reuse, linear=True)
    assert len(graphs.state(m).entries) == 2
    g_reuse, e_reuse = reuse, reuse
    g_counts, e_counts, kept = Counter(), Counter(), []
    mean_tol, share_tol = _GRAPH_GATES[dtype]
    for w in windows[2:]:
        c0 = _build.counts()
        got, g_reuse = m.inference_ts_drba(*w, g_reuse, linear=True)
        c1 = _build.counts()
        want, e_reuse = _eager_window(m, *w, e_reuse)
        c2 = _build.counts()
        g_counts.update({k: c1[k] - c0[k] for k in c0})
        e_counts.update({k: c2[k] - c1[k] for k in c0})
        kept.append([(t, t.clone()) for t in got + _tensors(g_reuse)])
        assert len(got) == len(want) == len(w[3])
        for g, e in zip(got, want):
            assert g.shape == e.shape and bool(torch.isfinite(g).all())
            d = (g.float() - e.float()).abs()
            assert float(d.mean()) <= mean_tol
            assert float((d > 1e-2).float().mean()) <= share_tol
    assert g_counts == e_counts and g_counts["splat"] > 0
    torch.cuda.synchronize()
    for window in kept:
        for t, saved in window:
            assert torch.equal(t, saved)


@pytest.mark.parametrize("name", ["rife", "gmfss", "gmfss_union"])
def test_steady_state_windows_make_no_host_sync(dev, name):
    """With the graphs captured and the caches warm, steady-state windows,
    graphed (``inference_ts_drba``) and eager (``next_reuse`` +
    ``drba_window``), run under ``torch.cuda.set_sync_debug_mode("error")``:
    no blocking copy, no read-back, no synchronise inside a window."""
    m = _graph_model(name, torch.bfloat16, dev)
    windows = _graph_windows(name, torch.bfloat16, dev)
    reuse = m.reuse(windows[0][1], windows[0][0])
    for w in windows[:2]:  # captures, and the eager pieces' first run
        _eager_window(m, *w, reuse)
        _, reuse = m.inference_ts_drba(*w, reuse, linear=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_reuse = e_reuse = reuse
        for w in windows[2:]:
            _, g_reuse = m.inference_ts_drba(*w, g_reuse, linear=True)
            _, e_reuse = _eager_window(m, *w, e_reuse)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["rife", "gmfss", "gmfss_union"])
def test_plain_and_pass_replays_match_eager_without_host_sync(dev, name):
    """``inference_ts`` on a given reuse (a ``plain`` graph) and the chain
    start's pass (a ``pass`` graph): each key's first call eager, its second
    captures; then one replay of each under
    ``torch.cuda.set_sync_debug_mode("error")`` (no blocking copy, no
    read-back, no synchronise), within the window test's bf16 gates of the
    eager bodies, with the launches of the eager calls."""
    from drba_tpu_torch import graphs
    from drba_tpu_torch.graphs import _leaves

    m = _graph_model(name, torch.bfloat16, dev)
    I0, I1 = _graph_windows(name, torch.bfloat16, dev, n=1)[0][:2]
    ts = [0.2, 0.6]
    r01 = m._pass(I0, I1) if m.PLAIN_PASS else None
    calls = {"pass": ((lambda: m.reuse(I1, I0)), lambda: m._pass(I1, I0)),
             "plain": ((lambda: m.inference_ts(I0, I1, ts, reuse=r01)),
                       lambda: m._plain(I0, I1, m._ts(ts), r01))}
    for graph, _ in calls.values():
        for _ in range(2):  # eager, then the capture
            graph()
    torch.cuda.synchronize()
    got, counts = {}, {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kind, (graph, _) in calls.items():
            c0 = _build.counts()
            got[kind] = graph()
            counts[kind] = {k: v - c0[k] for k, v in _build.counts().items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    st = graphs.state(m)
    assert sorted((k[0], e.replays) for k, e in st.entries.items()) == [("pass", 1),
                                                                        ("plain", 1)]
    mean_tol, share_tol = _GRAPH_GATES[torch.bfloat16]
    for kind, (_, eager) in calls.items():
        c0 = _build.counts()
        want = eager()
        assert counts[kind] == {k: v - c0[k] for k, v in _build.counts().items()}
        g = torch.cat([t.float().reshape(-1) for t in _leaves(tuple(got[kind]))])
        w = torch.cat([t.float().reshape(-1) for t in _leaves(want)])
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        d = (g - w).abs()
        assert float(d.mean()) <= mean_tol, kind
        assert float((d > 1e-2).float().mean()) <= share_tol, kind


# ------------------------------------------------------------------------------ IFNet block inputs

# the block shapes the cells run: RIFE at 1088x1920, the union's auxiliary
# IFNet at half of 1152x1920 and, at -scale 0.5 on 4K, at 1152x1920 with
# scales 32-2; and RIFE at -scale 0.75 (no integer scale)
_BLOCK_SHAPES = {"rife": ((1088, 1920), (16.0, 8.0, 4.0, 2.0, 1.0)),
                 "union_aux": ((576, 960), (16.0, 8.0, 4.0, 2.0, 1.0)),
                 "union_4k_aux": ((1152, 1920), (32.0, 16.0, 8.0, 4.0, 2.0)),
                 "rife_scale_0.75": ((1088, 1920),
                                     tuple(s / 0.75 for s in (16.0, 8.0, 4.0, 2.0, 1.0)))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("case", list(_BLOCK_SHAPES))
def test_block_inputs_kernel_matches_plain(dev, case, T, dtype):
    """Every block input of ``ifnet_apply`` at the cells' shapes, written by
    the warp and assembly kernels and by their plain versions from the same
    operands as a DRBA window hands them over (I1 and f1 shared by the T
    planes, the B side and the f32 timestep maps picked per plane, mask and
    feat strided views of one map). The assembled channels are bit for bit
    at integer scales (the same taps, weights and roundings as
    F.interpolate); elsewhere within two ulps of each channel's largest
    value: F.interpolate's kernel may fuse the bilinear multiply-adds in
    another order (one rounding of the largest term), and the flow's
    product with 1 / scale rounds once more. The warped channels (resized
    with the rest where the scale is no integer) within the warp tests'
    tolerance; one warp and one assembly launch a block."""
    from drba_tpu_torch.models.ifnet import WARPED, block0_input, stage_input
    from drba_tpu_torch.ops.planes import Pick, first_channels, shared

    (h, w), scales = _BLOCK_SHAPES[case]
    gen = torch.Generator(device=dev).manual_seed(40 + T)
    rnd = lambda *shape: torch.rand(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    I0, I1, I2 = (rnd(1, h, w, 3) for _ in range(3))
    f0, f1, f2 = (rnd(1, h, w, 16) * 2 - 1 for _ in range(3))
    take_b = torch.arange(T, device=dev) > 0
    img0, f_a = shared(I1, T), shared(f1, T)
    img1, f_b = Pick(shared(I0, T), shared(I2, T), take_b), Pick(shared(f0, T), shared(f2, T),
                                                                 take_b)
    t = Pick(*(torch.rand(T, h, w, 1, generator=gen, device=dev) for _ in range(2)), take_b)
    tmp = rnd(T, h, w, 13) * 2 - 1
    flow = ((rnd(T, h, w, 4) * 2 - 1) * 12).contiguous()
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -23
    warp_tol = 1e-5 if dtype == torch.float32 else 8e-3  # as test_warp_kernel_matches_plain
    for i, sc in enumerate(scales):
        c0 = (_build.BLOCK_INPUT.launches, _build.WARP.launches)
        if i == 0:
            args = (img0, img1, f_a, f_b, t, sc)
            got, want = block0_input(*args, backend="cuda"), block0_input(*args, backend="torch")
            first = 0
        else:
            args = ((first_channels(img0, 3), f_a), (first_channels(img1, 3), f_b), flow, t,
                    tmp[..., 4:5], tmp[..., 5:], sc)
            got = stage_input(*args, backend="cuda")
            want = stage_input(*args, backend="torch")
            # the warps in channels [0, 38); at a scale that is no integer
            # they are resized with the rest, which rounds once more
            first = 2 * WARPED
            torch.testing.assert_close(got[..., :first].float(), want[..., :first].float(),
                                       atol=warp_tol + (0 if float(sc).is_integer() else ulp),
                                       rtol=0, msg=lambda m: f"block {i}: {m}")
        assert (_build.BLOCK_INPUT.launches - c0[0], _build.WARP.launches - c0[1]) == (1, int(i > 0))
        g, wt = got[..., first:].float(), want[..., first:].float()
        if float(sc).is_integer():
            assert torch.equal(g, wt), f"block {i} (scale {sc}): {int((g != wt).sum())} differ"
        else:
            tol = 2 * ulp * wt.abs().amax(dim=(0, 1, 2))  # per channel
            bad = int(((g - wt).abs() > tol).sum())
            assert not bad, f"block {i} (scale {sc}): {bad} values beyond {tol.tolist()}"


def test_rife_window_graph_writes_block_inputs_in_place(dev, monkeypatch):
    """A 1088x1920 RIFE window's capture makes no ``torch.cat`` in IFNet
    (ifnet.py and the ops it calls) and counts every block input as
    assembled (``ifnet.concat`` 0); a profiled replay of the captured graph
    launches no ``nhwcAddPaddingKernel`` (the first convs read 40 and 56
    channels, the lastconvs write 56), and no ``CatArrayBatchedCopy``
    beyond the cats the capture made elsewhere (the DRM maps, the flow
    inversion)."""
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    from drba_tpu_torch.models.rife import RIFE
    from drba_tpu_torch.utils import profiling

    m = RIFE(device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    base = torch.rand(1, 1088, 1920 + 12, 3, generator=gen, device=dev)
    I0, I1, I2 = (base[:, :, 6 * i:6 * i + 1920].contiguous().to(torch.bfloat16)
                  for i in range(3))
    real_cat, cats = torch.cat, []

    def cat(*args, **kwargs):
        out = real_cat(*args, **kwargs)
        f = sys._getframe(1)
        cats.append((os.path.basename(f.f_code.co_filename), f.f_lineno, tuple(out.shape)))
        return out

    monkeypatch.setattr(torch, "cat", cat)
    with profiling.tracer() as st:
        reuse = m.reuse(I1, I0)
        _, reuse = m.inference_ts_drba(I0, I1, I2, [0.6, 1.0, 1.4], reuse, linear=True)
    ifnet_files = {"ifnet.py", "block_input.py", "planes.py", "warp.py", "warp_cuda.py"}
    assert not [c for c in cats if c[0] in ifnet_files], cats
    assert st.counters["ifnet.concat"] == 0 and st.counters["ifnet.assembled"] >= 6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m.inference_ts_drba(I0, I1, I2, [0.6, 1.0, 1.4], reuse, linear=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() for _ in range(e.count)]
    assert not [n for n in names if "nhwcAddPadding" in n]
    assert sum("CatArrayBatchedCopy" in n for n in names) <= len(cats)


# ----------------------------------------------------------------------------- IFNet block outputs


def _lastconv_output(gen, n, h, w, scale, dtype, dev):
    """A block's lastconv output as cuDNN leaves it for the IFNet at (h, w)
    and ``scale``: LASTCONV_PADDED channels last, at half the block's
    resolution (two stride-2 convs round it up to a multiple of 4, the
    stride-2 transposed conv doubles it): at scale 1 the shuffle gives the
    full resolution, read as it is."""
    from drba_tpu_torch.models.ifnet import LASTCONV_PADDED

    half = lambda d: -(-d // 2)  # noqa: E731
    hl, wl = (2 * half(half(int(d / scale))) for d in (h, w))
    nchw = (torch.rand(n, LASTCONV_PADDED, hl, wl, generator=gen, device=dev) * 2 - 1).to(dtype)
    return nchw.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("case", list(_BLOCK_SHAPES))
def test_block_outputs_kernel_matches_plain(dev, case, n, dtype):
    """Every block output of ``ifnet_apply`` at the cells' shapes (block 0
    with no running flow, blocks 1-4 adding to one), written by the kernel
    and by the plain version from the same lastconv output: bit for bit at
    integer scales (the same taps, weights and roundings as F.interpolate,
    the multiply and the add); elsewhere each channel within two ulps of its
    largest value, and the flow within two ulps of its largest resized
    product besides (F.interpolate's kernel may fuse the bilinear
    multiply-adds in another order, and the product with the scale and the
    sum round once more). One launch a block."""
    from drba_tpu_torch.ops.block_output import block_output

    (h, w), scales = _BLOCK_SHAPES[case]
    gen = torch.Generator(device=dev).manual_seed(60 + n)
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -23
    flow = None
    for i, sc in enumerate(scales):
        lc = _lastconv_output(gen, n, h, w, sc, dtype, dev)
        c0 = _build.BLOCK_OUTPUT.launches
        got = block_output(lc, sc, flow, (h, w), backend="cuda")
        assert _build.BLOCK_OUTPUT.launches - c0 == 1
        want = block_output(lc, sc, flow, (h, w), backend="torch")
        for name, g, wt in zip(("flow", "mask", "feat"), got, want):
            assert g.shape == wt.shape and g.dtype == wt.dtype, name
            g, wt = g.float(), wt.float()
            if float(sc).is_integer():
                assert torch.equal(g, wt), f"block {i} {name} (scale {sc}): " \
                                           f"{int((g != wt).sum())} differ"
                continue
            tol = 2 * ulp * wt.abs().amax(dim=(0, 1, 2))  # per channel
            if name == "flow":
                fd = block_output(lc, sc, None, (h, w), backend="torch")[0].float()
                tol = tol + 2 * ulp * fd.abs().amax(dim=(0, 1, 2))
            bad = int(((g - wt).abs() > tol).sum())
            assert not bad, f"block {i} {name} (scale {sc}): {bad} values beyond {tol.tolist()}"
        # the next block adds to this one's flow, as ifnet_apply chains them
        flow = want[0].contiguous() if i == 0 else (want[0] * 0.5).contiguous()


def test_block_output_replays_in_a_captured_graph(dev):
    """The kernel captured in a CUDA graph (as the model-call graphs capture
    it), replayed on new lastconv outputs and flows copied into the captured
    inputs: each replay equals the plain version bit for bit (RIFE's block
    2 at 1088x1920, scale 4, T = 3, bf16); the capture records one launch."""
    from drba_tpu_torch.ops.block_output import block_output

    gen = torch.Generator(device=dev).manual_seed(7)
    lc = _lastconv_output(gen, 3, 1088, 1920, 4.0, torch.bfloat16, dev)
    flow = (torch.rand(3, 1088, 1920, 4, generator=gen, device=dev) * 24 - 12).to(torch.bfloat16)
    block_output(lc, 4.0, flow, (1088, 1920), backend="cuda")  # built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as record, torch.cuda.graph(graph):
        out = block_output(lc, 4.0, flow, (1088, 1920), backend="cuda")
    assert record == {"block_output": 1}
    for _ in range(2):
        lc.copy_(_lastconv_output(gen, 3, 1088, 1920, 4.0, torch.bfloat16, dev))
        flow.copy_((torch.rand(3, 1088, 1920, 4, generator=gen, device=dev) * 24 - 12)
                   .to(torch.bfloat16))
        graph.replay()
        want = block_output(lc, 4.0, flow, (1088, 1920), backend="torch")
        for g, wt in zip(out, want):
            assert torch.equal(g, wt)


def test_rife_window_graph_writes_block_outputs_in_one_pass(dev):
    """A 1088x1920 RIFE window and its pass count every block output as
    fused (``ifnet.out_plain`` 0): one for the chain's pass (block 0), and
    six for each run of the window's body (the next pass's block 0 and the
    IFNet's five blocks), which its first call runs twice, as the warm-up
    and as the capture: 13 in all. A profiled replay of the captured window
    graph launches the kernel and no bf16 upsample_bilinear2d (the f32 ones
    left are the DRM's: its maps splat at half resolution and resized back,
    drm.py)."""
    from torch.profiler import ProfilerActivity, profile

    from drba_tpu_torch.models.rife import RIFE
    from drba_tpu_torch.utils import profiling

    m = RIFE(device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    base = torch.rand(1, 1088, 1920 + 12, 3, generator=gen, device=dev)
    I0, I1, I2 = (base[:, :, 6 * i:6 * i + 1920].contiguous().to(torch.bfloat16)
                  for i in range(3))
    with profiling.tracer() as st:
        reuse = m.reuse(I1, I0)
        _, reuse = m.inference_ts_drba(I0, I1, I2, [0.6, 1.0, 1.4], reuse, linear=True)
    assert st.counters["ifnet.out_plain"] == 0 and st.counters["ifnet.out_fused"] == 13
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m.inference_ts_drba(I0, I1, I2, [0.6, 1.0, 1.4], reuse, linear=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [k for k in names if "upsample_bilinear2d" in k and "BFloat16" in k], names
    assert [k for k in names if "block_output_kernel" in k], names
