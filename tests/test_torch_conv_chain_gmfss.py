"""The port's conv chain with the GMFSS epilogues (pre-PReLU, plain residual,
final 'input' / 'extra' residual), and the MetricNet and FeatureNet chain
sites, against drba_tpu's ``conv_backend='pallas'`` on the CPU.

drba_tpu runs its Pallas conv-chain kernel in interpret mode, as
tests/test_conv_chain.py runs it, at shapes where its TPU column packing
applies (W % 16 == 0, H % 4 == 0), so that its nets really take the chain;
the port runs its plain chain (the CUDA kernel's plain version). Both in
float32 on inputs made with numpy from a seed. GridNet's chain lattice and
the GMFSS / GMFSS_UNION windows are in test_torch_conv_chain_gridnet.py,
test_torch_conv_chain_windows.py and test_torch_conv_chain_union_window.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import drba_tpu.models.gmfss_nets as jnets
from drba_tpu.models.layers import init_from_spec as jax_init
from drba_tpu.ops import conv_chain as jcc
from drba_tpu_torch import bounds
from drba_tpu_torch.config import F32
from drba_tpu_torch.convert import from_jax_params
from drba_tpu_torch.models import gmfss_nets as nets
from drba_tpu_torch.models.layers import conv2d, prelu
from drba_tpu_torch.ops.conv_chain import ChainStep, conv_chain

# f32 sums of 9*C products in another order (interpret-mode Pallas against
# PyTorch's CPU conv), through up to five convs: measured within ~1e-5
ATOL = 2e-4
# MetricNet's occlusion masks threshold sums of flow magnitudes: a value at
# the threshold may flip, as in tests/test_torch_gmfss.py (none measured)
FLIP_SHARE = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per machine; keep this file's
    small PyTorch CPU ops on one thread instead of oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0, err_msg=what)


def _close_but_flips(got, want, atol, what=""):
    d = np.abs(_np(got).astype(np.float64) - np.asarray(want).astype(np.float64))
    assert d.shape == np.asarray(want).shape
    share = float((d > atol).mean())
    assert share <= FLIP_SHARE, f"{what}: {share:.2e} beyond {atol} (max {d.max():.3e})"


def _params(spec, seed):
    jp = jax_init(spec, seed=seed)
    return jp, from_jax_params({k: np.asarray(v) for k, v in jp.items()}, spec)


# ----------------------------------------------------------------------------- conv_chain


def _steps(rng, c, n, pre=True, plain_res=False):
    """``n`` C -> C steps for both packages: (jax steps, port steps)."""
    js, ts = [], []
    for _ in range(n):
        w = rng.normal(0, 0.1, (3, 3, c, c)).astype(np.float32)  # HWIO, as drba_tpu keeps it
        b = rng.normal(0, 0.5, (c,)).astype(np.float32)
        a = np.float32(rng.uniform(0.1, 0.4)) if pre else None
        js.append(jcc.ChainStep(w=jnp.asarray(w), b=jnp.asarray(b),
                                pre_alpha=None if a is None else jnp.float32(a),
                                plain_res=plain_res))
        ts.append(ChainStep(w=_t(w.transpose(3, 2, 0, 1)), b=_t(b),
                            pre_alpha=None if a is None else torch.tensor(a),
                            plain_res=plain_res))
    return js, ts


@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (2, 8, 16, 128)])
@pytest.mark.parametrize("epilogue", ["pre_alpha", "plain_res", "input", "extra"])
def test_conv_chain_epilogues_match_jax(shape, epilogue):
    """Two-step chains: PReLU'd inputs; with the plain residual on both
    steps; with the final residual of the chain's input or of another
    tensor."""
    rng = np.random.default_rng(sum(shape) + len(epilogue))
    x = rng.normal(0, 1, shape).astype(np.float32)
    res = rng.normal(0, 1, shape).astype(np.float32)
    js, ts = _steps(rng, shape[-1], 2, plain_res=epilogue == "plain_res")
    residual = epilogue if epilogue in ("input", "extra") else "none"
    r = res if epilogue == "extra" else None
    want = jcc.conv_chain(jnp.asarray(x), js, residual=residual,
                          res=None if r is None else jnp.asarray(r), interpret=True)
    got = conv_chain(_t(x), ts, residual, None if r is None else _t(r), backend="torch")
    assert tuple(got.shape) == shape
    _close(got, want, ATOL, epilogue)


def test_conv_chain_mixed_widths_match_jax():
    """Steps that change width with a pre-PReLU (GridNet's head1, 128 -> 64,
    then 64 -> 64 onto an extra residual), as tests/test_conv_chain.py's
    ``test_gridnet_head_f2_cin128_res_extra``."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (1, 24, 32, 128)).astype(np.float32)
    res = rng.normal(0, 1, (1, 24, 32, 64)).astype(np.float32)
    js, ts = [], []
    for cin, cout in ((128, 64), (64, 64)):
        w = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
        b = rng.normal(0, 0.5, (cout,)).astype(np.float32)
        js.append(jcc.ChainStep(w=jnp.asarray(w), b=jnp.asarray(b), pre_alpha=jnp.float32(0.25)))
        ts.append(ChainStep(w=_t(w.transpose(3, 2, 0, 1)), b=_t(b), pre_alpha=torch.tensor(0.25)))
    want = jcc.conv_chain(jnp.asarray(x), js, residual="extra", res=jnp.asarray(res), hb=8,
                          interpret=True)
    _close(conv_chain(_t(x), ts, "extra", _t(res), backend="torch"), want, ATOL, "128 -> 64")


def _step(cin, cout, **kw):
    return ChainStep(w=torch.zeros(cout, cin, 3, 3), b=torch.zeros(cout), **kw)


@pytest.mark.parametrize("case", ["beta+pre", "beta+plain_res", "plain_res widths",
                                  "input widths", "extra shape", "plain_res+final",
                                  "unknown residual"])
def test_conv_chain_refuses_what_drba_tpu_asserts(case):
    """drba_tpu's conv_chain asserts, raised as ValueErrors by both backends;
    and the one combination the kernel does not take (a last step's plain
    residual with a final residual: one residual tensor a launch)."""
    x = torch.zeros(1, 4, 4, 8)
    one = torch.tensor(0.25)
    steps, residual, res = {
        "beta+pre": ([_step(8, 8, beta=torch.ones(8), pre_alpha=one)], "none", None),
        "beta+plain_res": ([_step(8, 8, beta=torch.ones(8), plain_res=True)], "none", None),
        "plain_res widths": ([_step(8, 16, plain_res=True)], "none", None),
        "input widths": ([_step(8, 16)], "input", None),
        "extra shape": ([_step(8, 16)], "extra", torch.zeros(1, 4, 4, 8)),
        "plain_res+final": ([_step(8, 8, plain_res=True)], "input", None),
        "unknown residual": ([_step(8, 8)], "both", None),
    }[case]
    for backend in ("torch", "auto"):
        with pytest.raises(ValueError):
            conv_chain(x, steps, residual, res, backend=backend)


def test_conv_chain_narrow_and_wide_widths_match_the_plain_convs():
    """The widths drba_tpu pads for its packing and the port's kernel takes
    as they are: Cin 14 / 12 / 9 (MetricNet in, the GridNet heads), Cout 2
    (MetricNet out) and 256 (the tail's upsample), against F.conv2d with the
    PReLU and the residual written out."""
    rng = np.random.default_rng(3)
    conv = torch.nn.functional.conv2d
    for cin, cout, pre, residual in ((14, 64, False, "none"), (12, 64, True, "none"),
                                     (9, 64, True, "none"), (64, 2, True, "none"),
                                     (64, 256, True, "none"), (256, 128, True, "extra")):
        x = _t(rng.normal(0, 1, (2, 8, 12, cin)).astype(np.float32))
        w = _t(rng.normal(0, 0.1, (cout, cin, 3, 3)).astype(np.float32))
        b = _t(rng.normal(0, 0.5, (cout,)).astype(np.float32))
        res = _t(rng.normal(0, 1, (2, 8, 12, cout)).astype(np.float32))
        a = torch.tensor(0.2)
        got = conv_chain(x, [ChainStep(w=w, b=b, pre_alpha=a if pre else None)], residual,
                         res if residual == "extra" else None, backend="torch")
        inp = torch.where(x >= 0, x, x * a) if pre else x
        want = conv(inp.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)
        if residual == "extra":
            want = want + res
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_conv3x3_work_counts_alpha_and_residual():
    """A GridNet L0 step (3, 544, 960, 64 -> 64) in bf16 with a pre-PReLU
    and an extra residual: the residual's bytes once more, one slope, no
    beta; the operations are the conv's."""
    px = 3 * 544 * 960
    w = bounds.conv3x3_work(3, 544, 960, 64, 64, 2, beta=False, alpha=True, res=True)
    assert w.bytes == px * (64 + 2 * 64) * 2 + (64 * 64 * 9 + 64 + 1) * 2
    assert w.ops == {"bf16": 2.0 * 9 * 64 * 64 * px}
    # an input residual is the step's input: nothing more read
    assert bounds.conv3x3_work(3, 544, 960, 64, 64, 2, beta=False).bytes == \
        px * 128 * 2 + (64 * 64 * 9 + 64) * 2


# ------------------------------------------------------------------------- MetricNet, FeatureNet


@pytest.mark.parametrize("union", [False, True])
def test_metricnet_chain_matches_jax_pallas(union):
    """MetricNet's five convs as one chain (14 -> 64, three PReLU + plain
    residual steps, 64 -> 2) against drba_tpu's ``conv_backend='pallas'``
    (which pads 14 and 2 to 64 channels), plain and union (tanh * 10)."""
    jp, p = _params(nets.METRICNET_SPEC, 1)
    rng = np.random.default_rng(12)
    img0, img1 = (rng.uniform(0, 1, (1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    f01, f10 = (rng.normal(size=(1, 32, 64, 2)).astype(np.float32) * 2 for _ in range(2))
    want = jnets.metricnet_apply(jp, *map(jnp.asarray, (img0, img1, f01, f10)), union=union,
                                 conv_backend="pallas")
    got = nets.metricnet_apply(p, *map(_t, (img0, img1, f01, f10)), union=union,
                               conv_backend="torch")
    for g, w in zip(got, want):
        # union: tanh * 10 scales the conv's error by at most 10
        _close_but_flips(g, w, ATOL * (10 if union else 1), f"metricnet union={union}")


def test_featurenet_chain_matches_jax_pallas():
    jp, p = _params(nets.FEATURENET_SPEC, 2)
    x = np.random.default_rng(13).uniform(0, 1, (1, 64, 128, 3)).astype(np.float32)
    want = jnets.featurenet_apply(jp, jnp.asarray(x), conv_backend="pallas")
    got = nets.featurenet_apply(p, _t(x), conv_backend="torch")
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape
        _close(g, w, ATOL, f"level {i + 1}")


def _eager(p, conv, x, pre=None):
    """``conv(prelu(x))`` with the nets' eager layers, NHWC."""
    return conv2d(p, conv, x if pre is None else prelu(p, pre, x), padding=1)


def test_chain_sites_equal_the_eager_nets(monkeypatch):
    """MetricNet's chain and FeatureNet's level 1 against the same nets
    spelled with eager layers as MetricNet.py and FeatureNet.py write them
    (conv, PReLU, add), f32 on the CPU: the chain rounds where those ops do,
    in the same order, so they agree to the last bit in practice (held at
    1e-5). MetricNet's conv input is taken from its chain call."""
    rng = np.random.default_rng(14)
    _, pm = _params(nets.METRICNET_SPEC, 1)
    _, pf = _params(nets.FEATURENET_SPEC, 2)
    img0, img1 = (_t(rng.uniform(0, 1, (1, 24, 40, 3)).astype(np.float32)) for _ in range(2))
    f01, f10 = (_t(rng.normal(size=(1, 24, 40, 2)).astype(np.float32) * 2) for _ in range(2))
    inputs = []
    run = nets.run_chain
    monkeypatch.setattr(nets, "run_chain", lambda x, *a, **k: inputs.append(x) or run(x, *a, **k))
    for union in (False, True):
        got = nets.metricnet_apply(pm, img0, img1, f01, f10, union)
        feat = _eager(pm, "metric_in", inputs.pop())
        for i in (1, 2, 3):
            feat = _eager(pm, f"metric_net{i}.1", feat, f"metric_net{i}.0") + feat
        out = _eager(pm, "metric_out.1", feat, "metric_out.0")
        if union:
            out = torch.tanh(out) * 10
        for g, w in zip(got, (out[..., 0:1], out[..., 1:2])):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    x = _t(rng.uniform(0, 1, (1, 48, 80, 3)).astype(np.float32))
    y = x
    for i, g in zip((1, 2, 3), nets.featurenet_apply(pf, x)):
        y = conv2d(pf, f"block{i}.1", prelu(pf, f"block{i}.0", y), stride=2, padding=1)
        y = _eager(pf, f"block{i}.3", y, f"block{i}.2")
        torch.testing.assert_close(g, y, atol=1e-5, rtol=0)


# ------------------------------------------------------------------------------ the models


def _frames(n, h, w, step=3):
    base = np.random.default_rng(0).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [_t(base[:, :, step * i:step * i + w]) for i in range(n)]


@pytest.mark.parametrize("union", [False, True])
def test_models_pack_exactly_the_convs_the_chain_sites_read(union, monkeypatch):
    """GMFSS and GMFSS_UNION hold the conv kernel's packed weights (``.wp``)
    of the chain sites' convs and of no other conv: a window reads every one
    of them, each with its packed weights, and each unpacks to its conv's
    weights. The models compute in f32, so the sites include FeatureNet's
    levels 2-3 and GridNet's L2, and the weights are split
    (``pack_weights_tf32``)."""
    from drba_tpu_torch.models.gmfss import GMFSS
    from drba_tpu_torch.models.gmfss_union import GMFSS_UNION
    from drba_tpu_torch.ops.conv_chain import unpack_weights

    read = []
    step = nets._step
    monkeypatch.setattr(nets, "_step", lambda p, conv, *a, **k: read.append(
        (conv, p.get(f"{conv}.wp") is not None)) or step(p, conv, *a, **k))
    m = (GMFSS_UNION if union else GMFSS)(config=F32, device="cpu")
    m.inference_ts_drba(*_frames(3, 128, 128), [0.5, 1.3], None, linear=True)
    tables = (nets.METRICNET_CHAIN, nets.featurenet_chain_convs(f32=True),
              nets.gridnet_chain_convs(union, f32=True))
    assert {c for c, _ in read} == set().union(*tables)
    assert all(packed for _, packed in read)
    for p, convs in zip(m.params[1:], tables):
        assert {k for k in p if k.endswith(".wp")} == {f"{c}.wp" for c in convs}
        for c in convs:
            w = p[f"{c}.weight"]
            assert p[f"{c}.wp"].dim() == 5, c  # split, in fragment order
            assert torch.equal(unpack_weights(p[f"{c}.wp"], w.shape[1], w.shape[0]), w), c


def test_cuda_conv_backend_on_cpu_raises():
    """``conv_backend='cuda'`` never falls back to the plain chain or to
    cuDNN: on a CPU tensor the first chain site (FeatureNet's level 1)
    raises, before any kernel launch."""
    from drba_tpu_torch import _build
    from drba_tpu_torch.models.gmfss import GMFSS
    from drba_tpu_torch.models.gmfss_union import GMFSS_UNION

    rng = np.random.default_rng(15)
    img0, img1 = (_t(rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)) for _ in range(2))
    for cls in (GMFSS, GMFSS_UNION):
        m = cls(config=F32.replace(conv_backend="cuda"), device="cpu")
        launches = _build.counts()
        with pytest.raises(ValueError, match="CUDA tensor"):
            m.reuse(img0, img1)
        assert _build.counts() == launches
