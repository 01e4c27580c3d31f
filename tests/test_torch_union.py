"""The port's GMFSS_UNION slice (union MetricNet and GridNet, the auxiliary
RIFE's DRM, the union inference with its timestep-swap mask, windows, the
frame loop) against drba_tpu on the CPU.

Both packages run the same seeded random parameters in float32 on inputs
made with numpy, at 128x256 (divisible by union's pad of 128, so GMFlow runs
at 64x128 and the auxiliary IFNet at 64x128). JAX takes its exact CPU paths.

Union thresholds warped timesteps at a ratio of 25 and splat coverage at
0.999, so a value within rounding of either threshold can fall on the other
side when sums run in another order and flip a pixel. Frames are therefore
held to a value tolerance plus a largest share of values beyond it; the share
measured at these inputs is stated beside each bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import drba_tpu.models.gmflow_net as jgm
import drba_tpu.models.gmfss_nets as jnets
import drba_tpu.models.ifnet as jifnet
from drba_tpu.config import F32 as JAX_F32
from drba_tpu.models.layers import init_from_spec as jax_init
from drba_tpu_torch.config import F32
from drba_tpu_torch.convert import from_jax_params
from drba_tpu_torch.models import gmflow_net as gm
from drba_tpu_torch.models import gmfss_nets as nets
from drba_tpu_torch.models import ifnet
from drba_tpu_torch.models.gmfss_union import GMFSS_UNION
from drba_tpu_torch.models.layers import init_from_spec

H, W = 128, 256
# largest share of frame values beyond the tolerance: measured at most 5.7e-4
# at these inputs (the first chained window; the uint8 pipeline frames: none
# off by more than one level), bounded here at 5e-3, a margin of ~9x
FLIP_SHARE = 5e-3
# flows in pixels after GMFlow's f32 transformer layers and softmaxes
FLOW_TOL = 2e-3

SPECS = {"gmflow": (gm.GMFLOW_SPEC, jgm.GMFLOW_SPEC),
         "metricnet": (nets.METRICNET_SPEC, jnets.METRICNET_SPEC),
         "featurenet": (nets.FEATURENET_SPEC, jnets.FEATURENET_SPEC),
         "gridnet_union": (nets.GRIDNET_UNION_SPEC, jnets.GRIDNET_UNION_SPEC),
         "ifnet": (ifnet.IFNET_SPEC, jifnet.IFNET_SPEC)}


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
    assert d.shape == np.asarray(want).shape
    share = float((d > atol).mean())
    assert share <= flip_share, f"{what}: {share:.2e} of values beyond {atol} (max {d.max():.3e})"


def _frames(n, h=H, w=W, step=3):
    base = np.random.default_rng(0).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [np.ascontiguousarray(base[:, :, step * i:step * i + w]) for i in range(n)]


def _params(name, seed):
    spec, jspec = SPECS[name]
    jp = jax_init(jspec, seed=seed)
    return jp, from_jax_params({k: np.asarray(v) for k, v in jp.items()}, spec)


def _n_params(params):
    """Parameters of a param dict, without the kernels' packed copies (.wp)
    and the JAX package's folded lastconvs (.fold4)."""
    return sum(int(np.prod(v.shape)) for k, v in params.items()
               if not k.endswith(".wp") and ".fold4." not in k)


@pytest.fixture(scope="module")
def models():
    from drba_tpu.models.gmfss_union import GMFSS_UNION as JaxUnion

    return JaxUnion(weights=None, config=JAX_F32), GMFSS_UNION(config=F32, device="cpu")


# ------------------------------------------------------------------------- specs and weights


@pytest.mark.parametrize("name", list(SPECS))
def test_union_specs_match_jax(name):
    """Equal specs, and the same arrays drawn for each, seed for seed."""
    spec, jspec = SPECS[name]
    assert spec == jspec
    got, want = init_from_spec(spec, seed=4), jax_init(jspec, seed=4)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_union_model_parameters_match_jax(models):
    """The four GMFSS nets at seeds 0-3 and the auxiliary IFNet at seed 4:
    the same parameter count and the same values as the JAX model's."""
    jm, m = models
    jnets_ = list(jm.params) + [jm.rife_params]
    tnets = list(m.params) + [m.rife_params]
    assert sum(map(_n_params, tnets)) == sum(map(_n_params, jnets_))
    specs = [SPECS[n][0] for n in ("gmflow", "metricnet", "featurenet", "gridnet_union",
                                   "ifnet")]
    for jp, tp, spec in zip(jnets_, tnets, specs):
        want = from_jax_params({k: np.asarray(jp[k]) for k in spec}, spec)
        for k in spec:
            np.testing.assert_array_equal(_np(tp[k]), _np(want[k]), err_msg=k)
    assert m.pad_size == jm.pad_size == 128
    assert m.scale_list == jm.scale_list


# ----------------------------------------------------------------------------------- union nets


def test_union_metricnet_matches_jax():
    """The union tail ``tanh(out) * 10`` in f32: metrics within (-10, 10)."""
    rng = np.random.default_rng(4)
    jp, p = _params("metricnet", 1)
    img0, img1 = (rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32) for _ in range(2))
    f01, f10 = (rng.normal(size=(1, 32, 48, 2)).astype(np.float32) * 4 for _ in range(2))
    got = nets.metricnet_apply(p, *map(_t, (img0, img1, f01, f10)), union=True)
    want = jnets.metricnet_apply(jp, *map(jnp.asarray, (img0, img1, f01, f10)), union=True)
    plain = nets.metricnet_apply(p, *map(_t, (img0, img1, f01, f10)))
    for g, w, q in zip(got, want, plain):
        # the occlusion masks threshold |flow| sums; a value at the threshold may flip
        assert_close_but_flips(g, w, 1e-5, what="union metricnet")
        assert float(g.abs().max()) < 10
        _close(g, np.tanh(_np(q)) * 10, 1e-5, "tanh tail")


def test_union_gridnet_matches_jax():
    rng = np.random.default_rng(5)
    jp, p = _params("gridnet_union", 3)
    xs = [rng.uniform(0, 1, (1, 32 // s, 48 // s, c)).astype(np.float32)
          for s, c in ((1, 9), (1, 128), (2, 256), (4, 384))]
    _close(nets.gridnet_apply(p, *map(_t, xs), union=True),
           jnets.gridnet_apply(jp, *map(jnp.asarray, xs), union=True), 1e-4, "union gridnet")


def _smooth_flow(rng, n, h, w, mag, cell=16):
    import cv2

    coarse = rng.uniform(-mag, mag, (n, h // cell, w // cell, 2)).astype(np.float32)
    return np.stack([cv2.resize(c, (w, h), interpolation=cv2.INTER_LINEAR) for c in coarse])


@pytest.mark.parametrize("splat_scale", [0.5, 1.0])
@pytest.mark.parametrize("metric", [True, False])
def test_calc_drm_rife_auxiliary_matches_jax(splat_scale, metric):
    """Linear retiming, the metric-weighted ('soft') or plain alignment
    splats at half and full resolution and the hole fill, for a (T,) vector
    of timesteps."""
    from drba_tpu.drm import calc_drm_rife_auxiliary as jax_drm
    from drba_tpu_torch.drm import calc_drm_rife_auxiliary

    rng = np.random.default_rng(6)
    flow10, flow12 = (_smooth_flow(rng, 1, 64, 96, 10.0) for _ in range(2))
    # bounded as the union MetricNet bounds them
    m10, m12 = ((np.tanh(rng.normal(size=(1, 64, 96, 1))) * 10).astype(np.float32)
                if metric else None for _ in range(2))
    t = np.asarray([0.5, 0.3, 0.1], np.float32)
    want = jax_drm(jnp.asarray(t), jnp.asarray(flow10), jnp.asarray(flow12),
                   None if m10 is None else jnp.asarray(m10),
                   None if m12 is None else jnp.asarray(m12), linear=True,
                   backend="scatter", splat_scale=splat_scale)
    got = calc_drm_rife_auxiliary(_t(t), _t(flow10), _t(flow12),
                                  None if m10 is None else _t(m10),
                                  None if m12 is None else _t(m12), linear=True,
                                  backend="torch", splat_scale=splat_scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # coverage within rounding of 0.999 may flip a pixel of the hole fill
        assert_close_but_flips(g, w, 1e-5, what=f"scale={splat_scale} metric={metric}")


@pytest.mark.parametrize("mask", [True, False])
def test_gmfss_union_inference_matches_jax(models, mask):
    """The union inference on a chained reuse: per-pixel timestep maps with the
    mask (splatted with the image, hole-filled, the 25x swap at three
    levels), and plain timestep columns without it."""
    from drba_tpu.models.gmfss_core import gmfss_union_inference as jax_inf
    from drba_tpu_torch.models.gmfss_core import gmfss_union_inference

    jm, m = models
    fr = _frames(2)
    rng = np.random.default_rng(7)
    reuse = m.reuse(_t(fr[0]), _t(fr[1]))
    jreuse = jm.reuse(jnp.asarray(fr[0]), jnp.asarray(fr[1]))
    if mask:
        # maps that swing across the 25x ratio between the two directions
        t0 = rng.uniform(0.01, 1.0, (1, H // 2, W // 2, 1)).astype(np.float32)
        t1 = rng.uniform(0.01, 1.0, (1, H // 2, W // 2, 1)).astype(np.float32)
    else:
        t0 = np.full((1, 1, 1, 1), 0.3, np.float32)
        t1 = 1 - t0
    rife = rng.uniform(0, 1, (1, H // 2, W // 2, 3)).astype(np.float32)
    # the same reuse on both sides: the port's own, fed to JAX
    jr = type(jreuse)(*[jnp.asarray(_np(x)) for x in reuse[:4]],
                      tuple(jnp.asarray(_np(x)) for x in reuse.feat0),
                      tuple(jnp.asarray(_np(x)) for x in reuse.feat1))
    got = gmfss_union_inference(m.params, _t(fr[0]), _t(fr[1]), reuse, _t(t0), _t(t1), _t(rife),
                                enable_mask=mask)
    want = jax.jit(jax_inf, static_argnames=("enable_mask",))(
        jm.params, jnp.asarray(fr[0]), jnp.asarray(fr[1]), jr, jnp.asarray(t0),
        jnp.asarray(t1), jnp.asarray(rife), enable_mask=mask)
    assert tuple(got.shape) == tuple(want.shape) == (1, H, W, 3)
    # frames in [0, 1] through f32 networks; flips where a ratio lands near 25
    assert_close_but_flips(got, want, 1e-3, what=f"mask={mask}")


# ---------------------------------------------------------------------------- windows, pipeline


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_union_windows_and_reuse_chain_match_jax(models, scale):
    """The head's plain interpolation, then three windows chained through
    reuse, each with a source-frame timestep; also at ``-scale 0.5`` (the 4K
    path's flow scale), on frames twice as large."""
    from drba_tpu.models.gmfss_union import GMFSS_UNION as JaxUnion

    jm, m = models if scale == 1.0 else (
        JaxUnion(weights=None, scale=scale, config=JAX_F32),
        GMFSS_UNION(scale=scale, config=F32, device="cpu"))
    size = (int(H / scale), int(W / scale))
    fr = _frames(5, *size)
    for g, w in zip(m.inference_ts(_t(fr[0]), _t(fr[1]), [0.4, 0.8]),
                    jm.inference_ts(jnp.asarray(fr[0]), jnp.asarray(fr[1]), [0.4, 0.8])):
        assert tuple(g.shape) == (1, *size, 3)
        assert_close_but_flips(g, w, 1e-3, what="inference_ts")
    jr = tr = None
    ts = [0.5, 1.0, 1.3]
    for k in range(3):
        jo, jr = jm.inference_ts_drba(*(jnp.asarray(f) for f in fr[k:k + 3]), ts, jr,
                                      linear=True)
        to, tr = m.inference_ts_drba(*(_t(f) for f in fr[k:k + 3]), ts, tr, linear=True)
        assert len(to) == len(jo) == len(ts)
        for i, (g, w) in enumerate(zip(to, jo)):
            assert tuple(g.shape) == (1, *size, 3)
            assert_close_but_flips(g, w, 1e-3, what=f"window {k} t={ts[i]}")
        _close(to[1], fr[k + 1], 0, "the source frame at t = 1")
        for i, (g, w) in enumerate(zip(tr[:4], jr[:4])):
            # metrics: the union tail multiplies tanh by 10, so 10x the plain
            # GMFSS test's 1e-4 (measured within 1.2e-4)
            _close(g, w, FLOW_TOL if i < 2 else 1e-3, f"window {k} reuse field {i}")
        assert float(tr.metric0.abs().max()) < 10


class _FakeIO:
    src_fps, dst_fps = 24.0, 60.0
    total_frames_count = 0

    def __init__(self, frames):
        self._frames = list(frames)
        self.written = []

    def read_frame(self):
        return self._frames.pop(0) if self._frames else None

    def write_frame(self, frame):
        self.written.append(frame)

    def finish_writing(self):
        return True


def test_run_pipeline_union_matches_jax(models):
    """uint8 frames of 120x250 (padded to 128x256 and cropped back), 24 -> 60,
    with scene detection; a colour inversion at frame 4 cuts the stream on
    both of its sides, so two drba windows, a right-cut and a left-cut window
    run before the tail."""
    from drba_tpu.pipeline import run_pipeline as jax_run
    from drba_tpu_torch.pipeline import planned_outputs, run_pipeline

    jm, m = models
    # smooth content panning 3 px a frame: SSIM ~1 between neighbours
    x = np.linspace(0, 8 * np.pi, 268)[None, :, None]
    y = np.linspace(0, 4 * np.pi, 120)[:, None, None]
    p = np.arange(3)[None, None, :]
    base = ((np.sin(x + p) * np.cos(y - p) * 0.5 + 0.5) * 255).astype(np.uint8)
    u8 = [np.ascontiguousarray(base[:, 3 * i:3 * i + 250]) for i in range(6)]
    u8[4] = 255 - u8[4]
    jio, tio = _FakeIO(u8), _FakeIO(u8)
    jstats = jax_run(jm, jio, enable_scdet=True, scdet_threshold=0.3)
    stats = run_pipeline(m, tio, enable_scdet=True, scdet_threshold=0.3)
    assert stats.frames_out == jstats.frames_out == planned_outputs(6, 24.0, 60.0)
    assert stats.scene_cuts == jstats.scene_cuts == 2
    for g, w in zip(tio.written, jio.written):
        assert g.shape == w.shape == (120, 250, 3) and g.dtype == np.uint8
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        # one uint8 level anywhere (truncation), more only on flipped pixels
        assert d.max() <= 1 or (d > 1).mean() <= FLIP_SHARE, d.max()
