"""The port's GMFSS slice (layers, GMFlow, MetricNet, FeatureNet, GridNet, DRM,
reuse, windows) against drba_tpu on the CPU.

Both packages run the same seeded random parameters (init_from_spec draws
identically; convert.from_jax_params keeps the layouts) in float32, on inputs
made with numpy, at the geometry of tests/test_gmfss.py: 128x192 frames, so
GMFlow runs at 64x96. JAX takes its exact CPU paths (scatter splat, gather
warp, XLA convs, einsum attention).

Flows are compared in pixels with an absolute tolerance; frames and maps
with a value tolerance plus a stated largest share of values allowed beyond
it, because the DRM hole fill thresholds splat coverage at < 0.999 and a
coverage within rounding of that threshold can fall on the other side when
sums run in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import drba_tpu.models.gmflow_net as jgm
import drba_tpu.models.gmfss_nets as jnets
from drba_tpu.config import F32 as JAX_F32
from drba_tpu.models.gmfss import GMFSS as JaxGMFSS
from drba_tpu.models.layers import init_from_spec as jax_init
from drba_tpu_torch.config import F32
from drba_tpu_torch.convert import from_jax_params, from_torch_state_dict
from drba_tpu_torch.models import gmflow_net as gm
from drba_tpu_torch.models import gmfss_nets as nets
from drba_tpu_torch.models.gmfss import GMFSS
from drba_tpu_torch.models.layers import init_from_spec

H, W = 128, 192
# at most this share of map or frame values may sit on the other side of a
# coverage < 0.999 threshold (measured: none at these inputs)
FLIP_SHARE = 5e-3
# flows in pixels (up to ~45 px here) after two scales of f32 transformer
# layers and correlation softmaxes: measured within 2.2e-4
FLOW_TOL = 2e-3

SPECS = {"gmflow": (gm.GMFLOW_SPEC, jgm.GMFLOW_SPEC),
         "metricnet": (nets.METRICNET_SPEC, jnets.METRICNET_SPEC),
         "featurenet": (nets.FEATURENET_SPEC, jnets.FEATURENET_SPEC),
         "gridnet": (nets.GRIDNET_SPEC, jnets.GRIDNET_SPEC)}


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


def assert_close_but_flips(got, want, atol, flip_share=FLIP_SHARE, what=""):
    d = np.abs(_np(got).astype(np.float64) - np.asarray(want).astype(np.float64))
    share = float((d > atol).mean())
    assert share <= flip_share, f"{what}: {share:.2e} of values beyond {atol} (max {d.max():.3e})"


def _frames(n, h=H, w=W, step=3):
    base = np.random.default_rng(0).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [np.ascontiguousarray(base[:, :, step * i:step * i + w]) for i in range(n)]


def _params(name, seed):
    spec, jspec = SPECS[name]
    jp = jax_init(jspec, seed=seed)
    return jp, from_jax_params({k: np.asarray(v) for k, v in jp.items()}, spec)


@pytest.fixture(scope="module")
def models():
    return JaxGMFSS(weights=None, config=JAX_F32), GMFSS(config=F32, device="cpu")


# ------------------------------------------------------------------------- specs and weights


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_init_and_layouts_match_jax(name):
    """Equal specs, the same arrays draw for draw, linear weights kept (in, out)."""
    spec, jspec = SPECS[name]
    assert spec == jspec
    got, want = init_from_spec(spec, seed=5), jax_init(jspec, seed=5)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    p = from_jax_params(got, spec)
    for k, desc in spec.items():
        if desc[0] == "linear":
            np.testing.assert_array_equal(_np(p[k]), got[k], err_msg=k)


def test_state_dict_linear_weights_are_transposed():
    """nn.Linear keeps (out, in); the port stores (in, out) like the JAX package."""
    spec = {"a.weight": ("linear", 3, 5), "a.bias": ("bias", 5)}
    w = torch.arange(15.0).reshape(5, 3)
    p = from_torch_state_dict({"module.a.weight": w, "a.bias": torch.ones(5)}, spec)
    torch.testing.assert_close(p["a.weight"], w.t())


# ----------------------------------------------------------------------------- layers and ops


def test_layers_match_jax():
    from drba_tpu.models import layers as jl
    from drba_tpu_torch.models import layers as tl

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    p = {"l.weight": rng.normal(size=(16, 8)).astype(np.float32),
         "l.bias": rng.normal(size=(8,)).astype(np.float32),
         "n.weight": rng.normal(size=(16,)).astype(np.float32),
         "n.bias": rng.normal(size=(16,)).astype(np.float32),
         "a.weight": np.float32(0.25)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(np.asarray(v)) for k, v in p.items()}
    xj, xt = jnp.asarray(x), _t(x)
    # f32 ops of unit-scale values: a few ulps
    _close(tl.linear(tp, "l", xt), jl.linear(jp, "l", xj), 1e-5, "linear")
    _close(tl.layer_norm(tp, "n", xt), jl.layer_norm(jp, "n", xj), 1e-5, "layer_norm")
    _close(tl.instance_norm(xt), jl.instance_norm(xj), 1e-5, "instance_norm")
    _close(tl.prelu(tp, "a", xt), jl.prelu(jp, "a", xj), 0, "prelu")
    _close(tl.relu(xt), jl.relu(xj), 0, "relu")
    _close(tl.gelu(xt * 3), jl.gelu(xj * 3), 1e-6, "gelu")


def test_gelu_bf16_within_one_ulp_of_jax():
    """Every finite bf16 value: jax.nn.gelu's rounding points, erfc in f32 by
    another library, so a result may sit one bf16 ulp away (in practice
    almost never). XLA's CPU flushes subnormals to zero and PyTorch keeps
    them, so subnormal inputs are left out, and results below 1e-37 in size
    (where XLA flushes the intermediate values) count as zero."""
    from drba_tpu_torch.models.layers import gelu

    tiny = np.finfo(np.float32).tiny
    f32 = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    f32 = f32[np.isfinite(f32) & ((np.abs(f32) >= tiny) | (f32 == 0))]
    want = np.asarray(jax.nn.gelu(jnp.asarray(f32).astype(jnp.bfloat16), approximate=False)
                      .astype(jnp.float32))
    got = gelu(_t(f32).to(torch.bfloat16)).float().numpy()
    got, want = (np.where(np.abs(a) < 1e-37, np.float32(0), a) for a in (got, want))
    ulp = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64)) >> 16
    same = (want == got) | (np.isnan(want) & np.isnan(got))
    assert (same | (ulp <= 1)).all()
    assert same.mean() > 0.999


def test_shuffle_and_resize_helpers_match_jax():
    from drba_tpu.ops.resize import scale_by as jax_scale_by
    from drba_tpu.ops.shuffle import fold_conv_after_shuffle as jax_fold
    from drba_tpu.ops.shuffle import unfold3x3 as jax_unfold
    from drba_tpu_torch.ops.resize import scale_by
    from drba_tpu_torch.ops.shuffle import fold_conv_after_shuffle, pixel_shuffle, unfold3x3

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 10, 5)).astype(np.float32)
    _close(unfold3x3(_t(x)), jax_unfold(jnp.asarray(x)), 0, "unfold3x3")
    _close(scale_by(_t(x), 0.5), jax_scale_by(jnp.asarray(x), 0.5), 1e-6, "scale_by")
    w = rng.normal(size=(3, 3, 8, 3)).astype(np.float32)  # HWIO, as the JAX package stores it
    b = rng.normal(size=(3,)).astype(np.float32)
    jw, jb = jax_fold(jnp.asarray(w), jnp.asarray(b), 2)
    tw, tb = fold_conv_after_shuffle(_t(w.transpose(3, 2, 0, 1)), _t(b), 2)
    _close(tw.permute(2, 3, 1, 0), jw, 0, "w_lo")
    _close(tb, jb, 0, "b_lo")
    # the identity itself: conv after the shuffle == shuffle after the folded conv
    u = _t(rng.normal(size=(1, 5, 7, 32)).astype(np.float32))
    conv = torch.nn.functional.conv2d
    full = conv(pixel_shuffle(u, 2).permute(0, 3, 1, 2), _t(w.transpose(3, 2, 0, 1)), _t(b),
                padding=1).permute(0, 2, 3, 1)
    lo = pixel_shuffle(conv(u.permute(0, 3, 1, 2), tw, tb, padding=1).permute(0, 2, 3, 1), 2)
    _close(lo, _np(full), 1e-5, "polyphase identity")


# ------------------------------------------------------------------------------------- GMFlow


def test_gmflow_parts_match_jax():
    """Backbone (instance norm, trident conv), position embedding, local
    correlation, local propagation and convex upsampling."""
    jp, p = _params("gmflow", 0)
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    for g, w in zip(gm.backbone_apply(p, _t(img)), jgm.backbone_apply(jp, jnp.asarray(img))):
        _close(g, w, 1e-4, "backbone")  # instance-normalised features of size ~3
    f0, f1 = (rng.normal(size=(2, 8, 12, 128)).astype(np.float32) for _ in range(2))
    for g, w in zip(gm.add_position(_t(f0), _t(f1), 2),
                    jgm.add_position(jnp.asarray(f0), jnp.asarray(f1), 2)):
        _close(g, w, 1e-6, "add_position")
    _close(gm.local_correlation_flow(_t(f0), _t(f1), 4),
           jgm.local_correlation_flow(jnp.asarray(f0), jnp.asarray(f1), 4), 1e-5, "local corr")
    flow = rng.normal(size=(2, 8, 12, 2)).astype(np.float32) * 3
    _close(gm.flow_prop_local(p, _t(f0), _t(flow)),
           jgm.flow_prop_local(jp, jnp.asarray(f0), jnp.asarray(flow)), 1e-5, "prop local")
    _close(gm.convex_upsample(p, _t(flow), _t(f0)),
           jgm.convex_upsample(jp, jnp.asarray(flow), jnp.asarray(f0)), 1e-5, "upsample")


def test_gmflow_apply_bidir_matches_jax():
    jp, p = _params("gmflow", 0)
    fr = _frames(2, H // 2, W // 2)
    want = jax.jit(jgm.gmflow_apply, static_argnames=("pred_bidir",))(
        jp, jnp.asarray(fr[0]), jnp.asarray(fr[1]), pred_bidir=True)
    got = gm.gmflow_apply(p, _t(fr[0]), _t(fr[1]), pred_bidir=True)
    assert tuple(got.shape) == (2, H // 2, W // 2, 2)
    _close(got, want, FLOW_TOL, "flow")


# --------------------------------------------------------------------------------- GMFSS nets


def test_metricnet_featurenet_gridnet_match_jax():
    rng = np.random.default_rng(4)
    jp, p = _params("featurenet", 2)
    x = rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    for g, w in zip(nets.featurenet_apply(p, _t(x)), jnets.featurenet_apply(jp, jnp.asarray(x))):
        _close(g, w, 1e-5, "featurenet")

    jp, p = _params("metricnet", 1)
    img0, img1 = (rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32) for _ in range(2))
    f01, f10 = (rng.normal(size=(1, 32, 48, 2)).astype(np.float32) * 4 for _ in range(2))
    got = nets.metricnet_apply(p, *map(_t, (img0, img1, f01, f10)))
    want = jnets.metricnet_apply(jp, *map(jnp.asarray, (img0, img1, f01, f10)))
    for g, w in zip(got, want):
        # the occlusion masks threshold |flow| sums; a value at the threshold may flip
        assert_close_but_flips(g, w, 1e-5, what="metricnet")

    jp, p = _params("gridnet", 3)
    xs = [rng.uniform(0, 1, (1, 32 // s, 48 // s, c)).astype(np.float32)
          for s, c in ((1, 12), (1, 128), (2, 256), (4, 384))]
    _close(nets.gridnet_apply(p, *map(_t, xs)), jnets.gridnet_apply(jp, *map(jnp.asarray, xs)),
           1e-4, "gridnet")


# ----------------------------------------------------------------------------------- DRM, core


def _smooth_flow(rng, n, h, w, mag, cell=16):
    import cv2

    coarse = rng.uniform(-mag, mag, (n, h // cell, w // cell, 2)).astype(np.float32)
    return np.stack([cv2.resize(c, (w, h), interpolation=cv2.INTER_LINEAR) for c in coarse])


@pytest.mark.parametrize("linear", [True, False])
@pytest.mark.parametrize("splat_scale", [0.5, 1.0])
@pytest.mark.parametrize("metric", [True, False])
def test_calc_drm_gmfss_matches_jax(linear, splat_scale, metric):
    """Ratio maps, retiming, the soft (metric) or avg alignment splats at half
    and full resolution and the hole fill, for a (T,) vector of timesteps."""
    from drba_tpu.drm import calc_drm_gmfss as jax_drm
    from drba_tpu_torch.drm import calc_drm_gmfss

    rng = np.random.default_rng(5)
    flow10, flow12 = (_smooth_flow(rng, 1, 64, 96, 10.0) for _ in range(2))
    m10, m12 = (rng.normal(size=(1, 64, 96, 1)).astype(np.float32) if metric else None
                for _ in range(2))
    t = np.asarray([0.5, 0.3, 0.1], np.float32)
    want = jax_drm(jnp.asarray(t), jnp.asarray(flow10), jnp.asarray(flow12),
                   None if m10 is None else jnp.asarray(m10),
                   None if m12 is None else jnp.asarray(m12), linear=linear,
                   backend="scatter", splat_scale=splat_scale)
    got = calc_drm_gmfss(_t(t), _t(flow10), _t(flow12), None if m10 is None else _t(m10),
                         None if m12 is None else _t(m12), linear=linear, backend="torch",
                         splat_scale=splat_scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close_but_flips(g, w, 1e-5, what=f"linear={linear} scale={splat_scale}")


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_gmfss_reuse_matches_jax(models, scale):
    """Flows, metrics and feature pyramids, with img0's features passed in
    (the chained reuse), and with GMFlow at half the flow resolution
    (``-scale 0.5``, on frames twice as large so that its windows split)."""
    from drba_tpu.models.gmfss_core import gmfss_reuse as jax_reuse
    from drba_tpu_torch.models.gmfss_core import gmfss_reuse

    jm, m = models
    fr = _frames(2, int(H / scale), int(W / scale))
    feat0 = m.reuse(_t(fr[1]), _t(fr[0])).feat1  # featurenet(fr[0]) from a chained pass
    want = jax.jit(jax_reuse, static_argnames=("scale",))(
        jm.params, jnp.asarray(fr[0]), jnp.asarray(fr[1]), scale=scale)
    got = gmfss_reuse(m.params, _t(fr[0]), _t(fr[1]), scale, feat0=feat0)
    for i, (g, w) in enumerate(zip(got[:4], want[:4])):
        _close(g, w, FLOW_TOL if i < 2 else 1e-4, f"reuse field {i}")
    for g, w in zip(got.feat0 + got.feat1, want.feat0 + want.feat1):
        _close(g, w, 1e-5, "features")
    sw = got.swapped()
    assert sw.flow01 is got.flow10 and sw.feat0 is got.feat1


def test_gmfss_windows_and_reuse_chain_match_jax(models):
    """The head's plain interpolation, then three windows chained through
    reuse, each with a source-frame timestep."""
    jm, m = models
    fr = _frames(5)
    for g, w in zip(m.inference_ts(_t(fr[0]), _t(fr[1]), [0.4, 0.8]),
                    jm.inference_ts(jnp.asarray(fr[0]), jnp.asarray(fr[1]), [0.4, 0.8])):
        # frames in [0, 1] through the f32 networks: measured within 4.4e-5
        assert_close_but_flips(g, w, 1e-3, what="inference_ts")
    jr = tr = None
    ts = [0.5, 1.0, 1.3]
    for k in range(3):
        jo, jr = jm.inference_ts_drba(*(jnp.asarray(f) for f in fr[k:k + 3]), ts, jr,
                                      linear=True)
        to, tr = m.inference_ts_drba(*(_t(f) for f in fr[k:k + 3]), ts, tr, linear=True)
        assert len(to) == len(jo) == len(ts)
        for i, (g, w) in enumerate(zip(to, jo)):
            assert tuple(g.shape) == (1, H, W, 3)
            assert_close_but_flips(g, w, 1e-3, what=f"window {k} t={ts[i]}")
        for i, (g, w) in enumerate(zip(tr[:4], jr[:4])):
            _close(g, w, FLOW_TOL if i < 2 else 1e-4, f"window {k} reuse field {i}")


def test_cli_builds_gmfss_and_refuses_the_rest(tmp_path):
    from drba_tpu.models.gmfss_union import GMFSS_UNION as JaxUnion
    from drba_tpu_torch import cli
    from drba_tpu_torch.models.gmfss_union import GMFSS_UNION

    m = cli.load_model("gmfss", str(tmp_path), 1.0, F32, "cpu")
    assert isinstance(m, GMFSS) and m.pad_size == 64
    # the layer kernels' packed copies of GMFlow's weights are no parameters of their own
    assert sum(v.numel() for p in m.params for k, v in p.items()
               if not k.endswith(".wp")) == 13_496_106
    u = cli.load_model("gmfss_union", str(tmp_path), 1.0, F32, "cpu")
    assert isinstance(u, GMFSS_UNION) and u.pad_size == 128
    # the four union nets and the auxiliary IFNet, without the packed copies
    # (.wp) and the JAX package's folded lastconvs (.fold4)
    ju = JaxUnion(weights=None, config=JAX_F32)
    n_jax = sum(int(np.prod(v.shape)) for p in list(ju.params) + [ju.rife_params]
                for k, v in p.items() if ".fold4." not in k)
    assert sum(v.numel() for p in list(u.params) + [u.rife_params] for k, v in p.items()
               if not k.endswith(".wp")) == n_jax
    with pytest.raises(ValueError, match="gmfss_union"):
        cli.main(["-m", "gmfss_plus", "-i", str(tmp_path / "none.mp4")])


def test_gmfss_cuda_attention_on_cpu_tensors_raises():
    """``attn_backend='cuda'`` never falls back to the plain attention."""
    from drba_tpu_torch import _build

    m = GMFSS(config=F32.replace(attn_backend="cuda"), device="cpu")
    launches = _build.counts()
    fr = _frames(2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        m.reuse(_t(fr[0]), _t(fr[1]))
    assert _build.counts() == launches
