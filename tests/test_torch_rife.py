"""The port's RIFE slice (drm, ifnet, rife, pipeline, host utils) against drba_tpu.

Both packages run seed-0 random parameters (the same arrays: init_from_spec
draws identically and convert.from_jax_params maps the layouts) in float32 on
the CPU, on inputs made with numpy, at the ``__graft_entry__`` geometry
64x128. JAX takes its exact CPU paths (scatter splat, gather warp, XLA convs).

Maps and frames are compared with a value tolerance plus a stated largest
share of pixels allowed beyond it: the DRM hole fill and the flow-inversion
sentinel threshold coverage at < 0.999, and a coverage within rounding of
that threshold can fall on the other side when sums run in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drba_tpu.config import F32 as JAX_F32
from drba_tpu.models.rife import RIFE as JaxRIFE
from drba_tpu_torch.config import F32
from drba_tpu_torch.models.rife import RIFE

H, W = 64, 128
# at most this share of map pixels may sit on the other side of a
# coverage < 0.999 threshold (measured: none at these inputs)
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


def assert_close_but_flips(got, want, atol, flip_share=FLIP_SHARE, what=""):
    d = np.abs(_np(got).astype(np.float64) - _np(want).astype(np.float64))
    share = float((d > atol).mean())
    assert share <= flip_share, f"{what}: {share:.2e} of values beyond {atol} (max {d.max():.3e})"


def _smooth_flow(rng, n, mag, cell=16):
    import cv2

    coarse = rng.uniform(-mag, mag, (n, H // cell, W // cell, 2)).astype(np.float32)
    return np.stack([cv2.resize(c, (W, H), interpolation=cv2.INTER_LINEAR) for c in coarse])


def _frames(n, h=H, w=W, step=3):
    base = np.random.default_rng(0).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [np.ascontiguousarray(base[:, :, step * i:step * i + w]) for i in range(n)]


@pytest.fixture(scope="module")
def models():
    return JaxRIFE(weights=None, scale=1.0, config=JAX_F32), RIFE(weights=None, config=F32, device="cpu")


# ---------------------------------------------------------------------------------------- drm


@pytest.mark.parametrize("linear", [True, False])
@pytest.mark.parametrize("splat_scale", [0.5, 1.0])
@pytest.mark.parametrize("batched", [True, False])
def test_calc_drm_rife_matches_jax(linear, splat_scale, batched):
    """Ratio maps, linear / bisection retiming, the avg splats at half and full
    resolution and the hole fill. Flows of up to 10 px leave holes to fill."""
    from drba_tpu.drm import calc_drm_rife as jax_drm
    from drba_tpu_torch.drm import calc_drm_rife

    rng = np.random.default_rng(1)
    flow10 = _smooth_flow(rng, 1, 10.0)
    flow12 = _smooth_flow(rng, 1, 10.0)
    t_np = np.asarray([0.5, 0.3, 0.1], np.float32)
    tj = jnp.asarray(t_np) if batched else 0.3
    tt = torch.from_numpy(t_np) if batched else 0.3
    want = jax_drm(tj, jnp.asarray(flow10), jnp.asarray(flow12), linear=linear,
                   backend="scatter", splat_scale=splat_scale)
    got = calc_drm_rife(tt, torch.from_numpy(flow10), torch.from_numpy(flow12), linear=linear,
                        backend="torch", splat_scale=splat_scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # f32 maps in [0, 1]: sum-order differences only (a few ulps)
        assert_close_but_flips(g, w, 1e-5, what=f"linear={linear} scale={splat_scale}")


# -------------------------------------------------------------------------------------- ifnet


def test_ifnet_stages_match_jax(models):
    """Encoder, IFBlock 0 and every stage's flow of ifnet_apply, then the merge."""
    from drba_tpu.models.ifnet import ifnet_apply as jax_apply
    from drba_tpu.models.ifnet import ifnet_block as jax_block
    from drba_tpu.models.ifnet import ifnet_encode as jax_encode
    from drba_tpu_torch.models.ifnet import ifnet_apply, ifnet_block, ifnet_encode

    jm, m = models
    rng = np.random.default_rng(2)
    img0, img1 = (rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32) for _ in range(2))
    img1 = np.roll(img0, 4, axis=2) * 0.7 + img1 * 0.3
    tmap = rng.uniform(0.2, 0.8, (2, H, W, 1)).astype(np.float32)
    j = [jnp.asarray(a) for a in (img0, img1, tmap)]
    t = [torch.from_numpy(a) for a in (img0, img1, tmap)]

    # encoder features feed every stage: f32 convs, a few ulps apart
    np.testing.assert_allclose(_np(ifnet_encode(m.params, t[0])),
                               np.asarray(jax_encode(jm.params, j[0])), atol=1e-5, rtol=0)
    x = np.concatenate([img0, img1, rng.normal(size=(2, H, W, 32)).astype(np.float32), tmap], -1)
    for g, w in zip(ifnet_block(m.params, 0, torch.from_numpy(x), None, 4.0),
                    jax_block(jm.params, 0, jnp.asarray(x), None, 4.0, conv_backend="xla")):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4, rtol=1e-4)

    scales = (16.0, 8.0, 4.0, 2.0, 1.0)
    merged, flows = ifnet_apply(m.params, *t, scales, warp_backend="torch",
                                conv_backend="torch")
    jmerged, jflows = jax.jit(jax_apply, static_argnums=(4,), static_argnames=(
        "warp_backend", "conv_backend"))(jm.params, *j, scales, warp_backend="gather",
                                         conv_backend="xla")
    for i, (g, w) in enumerate(zip(flows, jflows)):
        # flows in pixels, through up to five stages of f32 convs and warps
        assert_close_but_flips(g, w, 1e-4, what=f"stage {i} flow")
    assert_close_but_flips(merged, jmerged, 1e-5, what="merged")


def test_ifnet_apply_matches_jax_at_a_non_integer_scale(models):
    """Every stage's flow and the merge of ifnet_apply's plain path at
    ``-scale 0.75``'s pyramid (16 / 0.75 ... 1 / 0.75): each block's output
    resized from a block resolution that divides no axis evenly, and at the
    last block upsampled by 4 / 3 (the test above holds a ratio of 1)."""
    from drba_tpu.models.ifnet import ifnet_apply as jax_apply
    from drba_tpu_torch.models.ifnet import ifnet_apply

    jm, m = models
    rng = np.random.default_rng(3)
    img0, img1 = (rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32) for _ in range(2))
    img1 = np.roll(img0, 3, axis=2) * 0.7 + img1 * 0.3
    tmap = rng.uniform(0.2, 0.8, (2, H, W, 1)).astype(np.float32)
    scales = tuple(s / 0.75 for s in (16.0, 8.0, 4.0, 2.0, 1.0))
    merged, flows = ifnet_apply(m.params, *(torch.from_numpy(a) for a in (img0, img1, tmap)),
                                scales, warp_backend="torch", conv_backend="torch")
    jmerged, jflows = jax.jit(jax_apply, static_argnums=(4,), static_argnames=(
        "warp_backend", "conv_backend"))(jm.params, *(jnp.asarray(a) for a in (
            img0, img1, tmap)), scales, warp_backend="gather", conv_backend="xla")
    for i, (g, w) in enumerate(zip(flows, jflows)):
        assert g.shape == w.shape
        assert_close_but_flips(g, w, 1e-4, what=f"stage {i} flow")
    assert_close_but_flips(merged, jmerged, 1e-5, what="merged")


# --------------------------------------------------------------------------------------- rife


def test_calc_flow_matches_jax(models):
    """Flow inversion with the max(H, W) sentinel where coverage < 0.999."""
    jm, m = models
    fr = _frames(2)
    want = jm._calc_flow(jnp.asarray(fr[1]), jnp.asarray(fr[0]))
    got = m.reuse(torch.from_numpy(fr[1]), torch.from_numpy(fr[0]))
    for i, (g, w) in enumerate(zip(got, want)):
        # sentinel pixels hold 128: a flip there is a large, counted difference
        assert_close_but_flips(g, w, 1e-4, what=f"calc_flow output {i}")


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_rife_window_and_reuse_chain_match_jax(models, scale):
    """The head's plain interpolation, then three windows chained through
    reuse; also at ``-scale 0.5`` (the 4K path's flow scale), on frames
    twice as large."""
    jm, m = models if scale == 1.0 else (
        JaxRIFE(weights=None, scale=scale, config=JAX_F32),
        RIFE(weights=None, scale=scale, config=F32, device="cpu"))
    fr = _frames(5, int(H / scale), int(W / scale))
    ts_head = [0.4, 0.8]
    for g, w in zip(m.inference_ts(*(torch.from_numpy(f) for f in fr[:2]), ts_head),
                    jm.inference_ts(*(jnp.asarray(f) for f in fr[:2]), ts_head)):
        # frames in [0, 1] through the f32 network: measured ~4e-6 apart
        assert_close_but_flips(g, w, 1e-3, what="inference_ts")
    jr = tr = None
    ts = [0.5, 1.0, 1.3]
    for k in range(3):
        jo, jr = jm.inference_ts_drba(*(jnp.asarray(f) for f in fr[k:k + 3]), ts, jr,
                                      linear=True)
        to, tr = m.inference_ts_drba(*(torch.from_numpy(f) for f in fr[k:k + 3]), ts, tr,
                                     linear=True)
        assert len(to) == len(jo) == len(ts)
        for i, (g, w) in enumerate(zip(to, jo)):
            assert_close_but_flips(g, w, 1e-3, what=f"window {k} t={ts[i]}")
        for g, w in zip(tr, jr):  # the reuse chain: flows (pixels) and features
            assert_close_but_flips(g, w, 1e-4, what=f"window {k} reuse")


# ----------------------------------------------------------------------------------- pipeline


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


def _u8_frames(n):
    # 60x120 frames: the pipeline resizes them to the network's 64x128 and back
    return [(f[0, :60, :120] * 255).astype(np.uint8) for f in _frames(n, step=2)]


def test_run_pipeline_matches_jax(models):
    from drba_tpu.pipeline import run_pipeline as jax_run
    from drba_tpu_torch.pipeline import planned_outputs, run_pipeline

    jm, m = models
    jio, tio = _FakeIO(_u8_frames(6)), _FakeIO(_u8_frames(6))
    jstats = jax_run(jm, jio)
    stats = run_pipeline(m, tio)
    assert stats.frames_out == jstats.frames_out == planned_outputs(6, 24.0, 60.0) == 16
    assert (stats.frames_in, stats.windows) == (jstats.frames_in, jstats.windows)
    for g, w in zip(tio.written, jio.written):
        assert g.shape == w.shape == (60, 120, 3) and g.dtype == np.uint8
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        # uint8 truncation: a value ~4e-6 from a level boundary can land on
        # either side, so one level is allowed everywhere, more only on flips
        assert d.max() <= 1 or (d > 1).mean() <= FLIP_SHARE, d.max()


class _StubModel:
    """The pipeline's model interface without a network: source frames out."""

    scale, pad_size, config, device = 1.0, 64, F32, torch.device("cpu")

    def inference_ts(self, I0, I1, ts, reuse=None, return_reuse=False):
        return [I0 for _ in ts]

    def inference_ts_drba(self, I0, I1, I2, ts, reuse=None, linear=False):
        return [I1 for _ in ts], None


def test_emitter_failure_raises_instead_of_hanging():
    """A failing sink surfaces as an error in the frame loop (the emitter's
    slot wait has a timeout and re-checks the worker errors)."""
    from drba_tpu_torch.pipeline import run_pipeline

    class _Broken(_FakeIO):
        def write_frame(self, frame):
            raise OSError("disk full")

    with pytest.raises(RuntimeError, match="download/encode") as e:
        run_pipeline(_StubModel(), _Broken(_u8_frames(4)))
    assert isinstance(e.value.__cause__, OSError)


# -------------------------------------------------------------------------------- host utils


@pytest.mark.parametrize("src,dst,times", [(24.0, 60.0, -1), (23.976, 59.94, -1),
                                           (25.0, 50.0, -1), (30.0, 144.0, -1),
                                           (24.0, 48.0, 2), (24.0, 72.0, 3), (24.0, 96.0, 4)])
def test_calc_ts_and_tmapper_bit_identical(src, dst, times):
    from drba_tpu.pipeline import calc_ts as jax_calc_ts
    from drba_tpu.utils.tmapper import TMapper as JaxTMapper
    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils.tmapper import TMapper

    tm, jtm = TMapper(src, dst, times), JaxTMapper(src, dst, times)
    for idx in range(40):
        np.testing.assert_array_equal(calc_ts(idx, tm, times), jax_calc_ts(idx, jtm, times))
        assert tm.get_range_timestamps(idx, idx + 1) == jtm.get_range_timestamps(idx, idx + 1)


def test_imageproc_matches_jax():
    from drba_tpu.utils import imageproc as jip
    from drba_tpu_torch.utils import imageproc as ip

    for dim in range(1, 2200, 7):
        for scale in (1.0, 0.5):
            assert ip._net_dim(dim, scale, 64) == jip._net_dim(dim, scale, 64)
    img = np.random.default_rng(3).integers(0, 256, (60, 120, 3), dtype=np.uint8)
    x = ip.to_inp(img, (64, 128))
    np.testing.assert_allclose(_np(x), np.asarray(jip.to_inp(img, (64, 128))), atol=1e-6, rtol=0)
    # round trip through the network size; truncation may differ by one level
    d = np.abs(ip.to_out(x, (60, 120)).astype(int) - jip.to_out(jnp.asarray(_np(x)),
                                                                 (60, 120)).astype(int))
    assert d.max() <= 1
