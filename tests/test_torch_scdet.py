"""The port's scene detection (SSIM, the scene score, the frame loop's cut
branches) against drba_tpu on the CPU.

Inputs are made with numpy seeds. SSIM runs in float32 on both sides; its
Gaussian sums run in another order, so scores agree within 1e-5. The frame
loops run seed-0 random-weight RIFE and GMFSS in float32 on 64x128 frames at
24 -> 60 fps, on streams with a hard cut (colour inversion) at the head, in
mid-stream and twice in a row, so that every branch (left cut, right cut,
cuts on both sides) runs; they must give drba_tpu's scene cuts, frame counts
and uint8 frames, with the flip-share rule of test_torch_gmfss_pipeline.py.

The prefetch thread's frames and scores are held bitwise to ``to_inp`` and
``scene_ssim`` on the same frames, on the CPU and, marked ``gpu``, on a CUDA
device, where the thread must make no synchronising call. JAX is imported
inside the tests that compare with it, so that the card's test runs where
JAX is not installed:

    python -m pytest tests/test_torch_scdet.py --noconftest -q -m gpu
"""

import numpy as np
import pytest
import torch

from drba_tpu_torch.config import F32

H, W = 64, 128
# at most this share of output values may differ by more than one uint8
# level: a coverage within rounding of the DRM's 0.999 threshold can flip
FLIP_SHARE = 5e-3
SSIM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per machine; keep this file's
    small PyTorch CPU ops on one thread instead of oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, cut_at=()):
    """Smooth content panning 2 px per frame (SSIM ~1, no spurious cuts);
    the frames in ``cut_at`` invert the colours, a hard cut (as in
    tests/test_reuse_chaining.py)."""
    x = np.linspace(0, 6 * np.pi, W)[None, :, None]
    y = np.linspace(0, 4 * np.pi, H)[:, None, None]
    p = np.arange(3)[None, None, :]
    base = ((np.sin(x + p) * np.cos(y - p) * 0.5 + 0.5) * 255).astype(np.uint8)
    out = []
    for i in range(n):
        if i in cut_at:
            base = 255 - base
        else:
            base = np.roll(base, 2, axis=1)
        out.append(base.copy())
    return out


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


# ------------------------------------------------------------------------------------- SSIM


def _image_pairs():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(0, 1, (1, 40, 56, 3)).astype(np.float32) for _ in range(2))
    near = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    return {"random": (a, b), "identical": (a, a), "near": (a, near),
            "0-255 range": (a * 255, near * 255)}


@pytest.mark.parametrize("pair", list(_image_pairs()))
@pytest.mark.parametrize("fn", ["ssim_matlab", "ssim", "msssim"])
def test_ssim_matches_jax(fn, pair):
    import jax.numpy as jnp

    from drba_tpu.ops import ssim as jssim
    from drba_tpu_torch.ops import ssim as tssim

    a, b = _image_pairs()[pair]
    got = float(getattr(tssim, fn)(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(getattr(jssim, fn)(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= SSIM_TOL, (got, want)
    if pair == "identical":
        assert abs(got - 1.0) <= SSIM_TOL


def test_ssim_wrappers_match_jax():
    import jax.numpy as jnp

    from drba_tpu.ops.ssim import MSSSIM as JMSSSIM
    from drba_tpu.ops.ssim import SSIM as JSSIM
    from drba_tpu_torch.ops.ssim import MSSSIM, SSIM

    a, b = _image_pairs()["near"]
    for cls, jcls in ((SSIM, JSSIM), (MSSSIM, JMSSSIM)):
        got = float(cls()(torch.from_numpy(a), torch.from_numpy(b)))
        assert abs(got - float(jcls()(jnp.asarray(a), jnp.asarray(b)))) <= SSIM_TOL


@pytest.mark.parametrize("cut", [False, True])
def test_scene_ssim_matches_jax(cut):
    """Both frames at the pipeline's size, to 32x32, then the volumetric SSIM;
    and the flag at the default threshold."""
    import jax.numpy as jnp

    from drba_tpu.utils.scdet import check_scene as jax_check
    from drba_tpu.utils.scdet import scene_ssim as jax_scene
    from drba_tpu_torch.utils.scdet import check_scene, scene_ssim

    fr = [f[None].astype(np.float32) / 255 for f in _frames(3, cut_at=(2,) if cut else ())]
    a, b = fr[1], fr[2]
    got = float(scene_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - float(jax_scene(jnp.asarray(a), jnp.asarray(b)))) <= SSIM_TOL
    assert check_scene(torch.from_numpy(a), torch.from_numpy(b)) == cut
    assert jax_check(jnp.asarray(a), jnp.asarray(b)) == cut
    same = float(scene_ssim(torch.from_numpy(a), torch.from_numpy(a)))
    assert abs(same - 1.0) <= SSIM_TOL


def test_gaussian_is_made_once_per_device():
    """The SSIM Gaussian is one tensor per device, with ``_kernel_np``'s
    values."""
    from drba_tpu_torch.ops.ssim import _kernel, _kernel_np

    k = _kernel(torch.device("cpu"))
    assert _kernel(torch.device("cpu")) is k
    assert torch.equal(k, torch.from_numpy(_kernel_np()))


# ------------------------------------------------------------------------------- frame loop


@pytest.fixture(scope="module")
def models():
    from drba_tpu.config import F32 as JAX_F32
    from drba_tpu.models.gmfss import GMFSS as JaxGMFSS
    from drba_tpu.models.rife import RIFE as JaxRIFE
    from drba_tpu_torch.models.gmfss import GMFSS
    from drba_tpu_torch.models.rife import RIFE

    return {"rife": (JaxRIFE(weights=None, config=JAX_F32), RIFE(config=F32, device="cpu")),
            "gmfss": (JaxGMFSS(weights=None, config=JAX_F32), GMFSS(config=F32, device="cpu"))}


# (frames, the frames that cut, the cuts the loop counts)
STREAMS = {"head": (5, (1,), 1), "mid": (7, (3,), 1), "two in a row": (7, (3, 4), 2)}


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_prefetcher_frames_and_scores(device, stream):
    """The prefetch thread's frames and scene scores are bitwise those of
    ``to_inp`` and ``scene_ssim`` on the same frames. On a CUDA device the
    thread, while it alone runs, makes no synchronising call; its stream has
    the device's greatest priority, and every frame it reads goes up through
    pinned memory. On the CPU there is no stream and nothing is pinned."""
    from drba_tpu_torch.pipeline import _Prefetcher
    from drba_tpu_torch.utils import to_inp
    from drba_tpu_torch.utils.profiling import StageTimes
    from drba_tpu_torch.utils.scdet import scene_ssim

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    n, cut_at, _ = STREAMS[stream]
    frames = _frames(n, cut_at)
    dst, dtype = (H + 8, W + 8), torch.bfloat16  # a resize, at the benchmark's dtype
    want = [to_inp(f, dst, dtype, device) for f in frames]
    want_scores = [scene_ssim(a, b) for a, b in zip(want, want[1:])]
    # as run_pipeline: the loop thread uploads frames 0-1 and scores them first
    prev = to_inp(frames[1], dst, dtype, device)
    scene_ssim(to_inp(frames[0], dst, dtype, device), prev)
    st = StageTimes()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        pf = _Prefetcher(_FakeIO(frames[2:]), dst, dtype, device, prev=prev, depth=n, tracer=st)
        pf._t.join(timeout=60)
        assert not pf._t.is_alive()
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    items = []
    while (item := pf.next()) is not None:
        items.append(item)
    assert len(items) == n - 2
    for k, item in enumerate(items, start=2):
        assert torch.equal(item.take(), want[k]), k
        item.cut(0.3)  # waits for the score
        assert torch.equal(item._score.cpu(), want_scores[k - 1].cpu()), k
    if cuda:
        assert pf._stream.priority == torch.cuda.Stream.priority_range()[1]
        assert st.counters["prefetch.staged"] == n - 2
    else:
        assert pf._stream is None and "prefetch.staged" not in st.counters


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("name", ["rife", "gmfss"])
def test_scdet_pipeline_matches_jax(models, name, stream):
    from drba_tpu.pipeline import run_pipeline as jax_run
    from drba_tpu_torch.pipeline import planned_outputs, run_pipeline

    n, cut_at, cuts = STREAMS[stream]
    jm, tm = models[name]
    jio, tio = _FakeIO(_frames(n, cut_at)), _FakeIO(_frames(n, cut_at))
    jstats = jax_run(jm, jio, enable_scdet=True, scdet_threshold=0.3)
    stats = run_pipeline(tm, tio, enable_scdet=True, scdet_threshold=0.3)
    assert stats.scene_cuts == jstats.scene_cuts == cuts
    assert stats.frames_out == jstats.frames_out == planned_outputs(n, 24.0, 60.0)
    assert (stats.frames_in, stats.windows) == (jstats.frames_in, jstats.windows)
    assert len(tio.written) == len(jio.written) == stats.frames_out
    for g, w in zip(tio.written, jio.written):
        assert g.shape == w.shape == (H, W, 3) and g.dtype == np.uint8
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        # uint8 truncation: a value a few 1e-5 from a level boundary can land on
        # either side, so one level is allowed everywhere, more only on flips
        assert d.max() <= 1 or (d > 1).mean() <= FLIP_SHARE, d.max()


def test_scdet_off_ignores_cuts(models):
    """Without scene detection a cut is interpolated across like any pair."""
    from drba_tpu_torch.pipeline import run_pipeline

    stats = run_pipeline(models["rife"][1], _FakeIO(_frames(5, (3,))))
    assert stats.scene_cuts == 0 and stats.frames_out == 13


def test_cut_windows_chain_the_reuse(models):
    """6 frames with one cut cost 3 GMFlow passes through ``model.reuse``: the
    head, the first window (its I1 -> I0 pass) and the left-cut window
    (whose pass seeds the chain); the right-cut window, the window after the
    cut and the tail ride the chain (tests/test_reuse_chaining.py)."""
    from drba_tpu_torch.pipeline import run_pipeline

    model = models["gmfss"][1]
    calls = {"n": 0}
    orig = model.reuse

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    model.reuse = counting
    try:
        stats = run_pipeline(model, _FakeIO(_frames(6, cut_at=(3,))), enable_scdet=True,
                             scdet_threshold=0.3)
    finally:
        del model.reuse
    assert stats.scene_cuts == 1
    assert calls["n"] == 3, calls["n"]
    assert stats.frames_out == 16


def test_tail_hands_the_chain_on(models):
    """Without cuts the tail interpolates on the last window's pass, swapped:
    one ``model.reuse`` call (the first window's) for a whole stream."""
    from drba_tpu_torch.pipeline import run_pipeline

    model = models["gmfss"][1]
    calls = {"n": 0, "tail_reuse": None}
    orig_reuse, orig_ts = model.reuse, model.inference_ts

    def counting(*a, **k):
        calls["n"] += 1
        return orig_reuse(*a, **k)

    def ts(*a, **k):
        calls["tail_reuse"] = k.get("reuse")
        return orig_ts(*a, **k)

    model.reuse, model.inference_ts = counting, ts
    try:
        run_pipeline(model, _FakeIO(_frames(4)))
    finally:
        del model.reuse, model.inference_ts
    # the head's pass, the first window's I1 -> I0 pass; the tail reuses
    assert calls["n"] == 2, calls["n"]
    assert calls["tail_reuse"] is not None
