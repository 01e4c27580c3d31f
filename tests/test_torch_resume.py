"""Exact resume, segmented output, stage profiling and the encoder probe of
the port, on the CPU.

A resumed run (``run_pipeline(skip_outputs=k)``) writes the uninterrupted
run's frames from k on, bitwise: blocks wholly before k run no model call,
and the first block computed gets the reuse the uninterrupted run would hand
it (the last skipped window's pass, recomputed). Seed-0 random-weight RIFE
and GMFSS in float32 on 64x128 frames at 24 -> 60 fps, one torch thread.
Against drba_tpu, the resumed tail equals its *uninterrupted* run within
1e-4; drba_tpu's own resume restarts the chain at the first computed window,
so its resumed tail is not its uninterrupted run's (a documented gap of the
reference). The segmented writer, the manifest and ``--resume`` run through
``cli.main`` with cv2 (no ffmpeg here), and so does the folder batch of
``drba_tpu_torch.demo``.
"""

import json
import os

import numpy as np
import pytest
import torch

from drba_tpu_torch.config import F32

H, W = 64, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this file's small PyTorch CPU ops on one thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, cut_at=()):
    """Smooth content panning 2 px per frame; the frames in ``cut_at``
    invert the colours (a hard cut), as in tests/test_torch_scdet.py."""
    x = np.linspace(0, 6 * np.pi, W)[None, :, None]
    y = np.linspace(0, 4 * np.pi, H)[:, None, None]
    p = np.arange(3)[None, None, :]
    base = ((np.sin(x + p) * np.cos(y - p) * 0.5 + 0.5) * 255).astype(np.uint8)
    out = []
    for i in range(n):
        base = 255 - base if i in cut_at else np.roll(base, 2, axis=1)
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


def _block_ends(n, times=-1):
    """Cumulative output counts at the end of the head, each window and the
    tail of an ``n``-frame stream at 24 -> 60 (or ``times`` x)."""
    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper

    tm = TMapper(24.0, 60.0, times)
    # the head and the first window both take calc_ts(0); window i calc_ts(i)
    return np.cumsum([len(calc_ts(i, tm, times)) for i in [0, *range(n - 1)]]).tolist()


@pytest.fixture(scope="module")
def rife():
    from drba_tpu_torch.models.rife import RIFE

    return RIFE(config=F32, device="cpu")


@pytest.fixture(scope="module")
def gmfss():
    from drba_tpu_torch.models.gmfss import GMFSS

    return GMFSS(config=F32, device="cpu")


_FULL = {}


def _uninterrupted(model, n, cut_at):
    """The uninterrupted run's written frames, once per model and stream."""
    from drba_tpu_torch.pipeline import run_pipeline

    key = (type(model).__name__, n, cut_at)
    if key not in _FULL:
        io = _FakeIO(_frames(n, cut_at))
        run_pipeline(model, io, enable_scdet=bool(cut_at), scdet_threshold=0.3)
        _FULL[key] = io.written
    return _FULL[key]


def _resumed(model, n, cut_at, k, monkeypatch):
    """The written frames of a run resumed at ``k``, and its window calls."""
    from drba_tpu_torch.pipeline import run_pipeline

    calls = {"inference_ts_drba": 0, "inference_ts": 0}
    for name in calls:
        orig = getattr(model, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(model, name, counted)
    io = _FakeIO(_frames(n, cut_at))
    stats = run_pipeline(model, io, enable_scdet=bool(cut_at), scdet_threshold=0.3,
                         skip_outputs=k)
    monkeypatch.undo()
    assert stats.frames_out == len(io.written)
    return io.written, calls


def _assert_tail_equal(got, full, k):
    assert len(got) == len(full) - k
    for i, (g, w) in enumerate(zip(got, full[k:])):
        assert np.array_equal(g, w), f"output {k + i} differs: max {np.abs(g.astype(int) - w).max()}"


# 8 frames: head 2 frames, six windows, tail; plan 21
_RIFE_N = 8
_E = _block_ends(_RIFE_N)
RIFE_POINTS = {"zero": 0, "inside the head": 1, "window boundary": _E[2],
               "inside a window": _E[3] + 1, "inside the tail": _E[-1] - 1, "the plan": _E[-1]}


@pytest.mark.parametrize("where", list(RIFE_POINTS))
def test_resume_equals_uninterrupted_run(rife, where, monkeypatch):
    """RIFE at k = 0, inside the head, at a window boundary, inside a window,
    inside the tail and at the plan (nothing left): the written frames from k
    on, bitwise; a block wholly before k runs no model call."""
    k = RIFE_POINTS[where]
    full = _uninterrupted(rife, _RIFE_N, ())
    assert len(full) == _E[-1] == 21
    got, calls = _resumed(rife, _RIFE_N, (), k, monkeypatch)
    _assert_tail_equal(got, full, k)
    # window i's block ends at _E[i + 1]; windows ending at or before k are skipped
    windows = sum(1 for end in _E[1:-1] if end > k)
    assert calls["inference_ts_drba"] == windows
    assert calls["inference_ts"] == (k < _E[0]) + (k < _E[-1])  # the head and the tail


def test_max_frames_stops_reading(rife):
    """``max_frames`` ends the stream after that many input frames: the
    tail follows the last window read, as for a stream of that length."""
    from drba_tpu_torch.pipeline import planned_outputs, run_pipeline

    io = _FakeIO(_frames(_RIFE_N))
    stats = run_pipeline(rife, io, max_frames=5)
    assert (stats.frames_in, stats.windows) == (5, 3)
    assert stats.frames_out == len(io.written) == planned_outputs(5, 24.0, 60.0)
    _assert_tail_equal(io.written[:_E[3]], _uninterrupted(rife, _RIFE_N, ())[:_E[3]], 0)


# 7 frames, frames 3 and 4 inverted: window 0 clean, window 1 a cut between
# I1 and I2, window 2 cuts on both sides, window 3 a cut between I0 and I1,
# window 4 clean (its chain is window 3's plain pass in GMFSS)
_CUT_N, _CUTS = 7, (3, 4)
_EC = _block_ends(_CUT_N)
BRANCH_WINDOW = {"clean": 0, "right cut": 1, "both cuts": 2, "left cut": 3}


@pytest.mark.parametrize("branch", list(BRANCH_WINDOW))
def test_resume_just_after_each_branch(rife, branch, monkeypatch):
    """k at the end of a window of each branch kind, and one frame into the
    next block: the next block gets the chain the uninterrupted run hands it."""
    full = _uninterrupted(rife, _CUT_N, _CUTS)
    end = _EC[BRANCH_WINDOW[branch] + 1]
    for k in (end, end + 1):
        got, _ = _resumed(rife, _CUT_N, _CUTS, k, monkeypatch)
        _assert_tail_equal(got, full, k)


@pytest.mark.parametrize("where", ["inside a window", "just after a left cut"])
def test_gmfss_resume_equals_uninterrupted_run(gmfss, where, monkeypatch):
    """GMFSS chains its plain windows too: after a cut between I0 and I1 the
    window's own GMFlow pass is the next window's reuse, recomputed on
    resume."""
    full = _uninterrupted(gmfss, _CUT_N, _CUTS)
    k = _EC[1] + 1 if where == "inside a window" else _EC[BRANCH_WINDOW["left cut"] + 1] + 1
    got, _ = _resumed(gmfss, _CUT_N, _CUTS, k, monkeypatch)
    _assert_tail_equal(got, full, k)


# --------------------------------------------------------------------------- against drba_tpu


@pytest.fixture(scope="module")
def float_runs(rife):
    """Output frames as f32 (the emitters' quantisation bypassed; frames are
    at the network size) of drba_tpu's uninterrupted and resumed runs and
    the port's resumed run, RIFE at 2x (one window length: fewer JAX
    programs to compile), k inside the window after a clean one."""
    import drba_tpu.pipeline as jpipe
    import drba_tpu_torch.pipeline as tpipe
    from drba_tpu.config import F32 as JAX_F32
    from drba_tpu.models.rife import RIFE as JaxRIFE

    jm = JaxRIFE(weights=None, config=JAX_F32)
    ends = _block_ends(_RIFE_N, times=2)
    k = ends[3] + 1
    mp = pytest.MonkeyPatch()
    mp.setattr(jpipe, "to_out", lambda x, size: np.asarray(x[0], np.float32))
    mp.setattr(tpipe, "to_out", lambda x, size: x[0].float().numpy())
    try:
        runs = {}
        for name, run, model, skip in (("jax", jpipe.run_pipeline, jm, 0),
                                       ("jax resumed", jpipe.run_pipeline, jm, k),
                                       ("port resumed", tpipe.run_pipeline, rife, k)):
            io = _FakeIO(_frames(_RIFE_N))
            run(model, io, times=2, skip_outputs=skip)
            runs[name] = io.written
    finally:
        mp.undo()
    return ends, k, runs


def test_resumed_tail_equals_jax_uninterrupted_run(float_runs):
    _, k, runs = float_runs
    want = runs["jax"][k:]
    assert len(runs["port resumed"]) == len(want)
    for g, w in zip(runs["port resumed"], want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_jax_resume_restarts_the_chain_and_the_port_does_not(float_runs):
    """The reference's gap: drba_tpu's resume leaves ``reuse`` None after a
    skip (drba_tpu/pipeline.py:324-338), so the first window computed starts
    the chain afresh with the I1 -> I0 pass, which RIFE's block 0 does not
    give as the reversed I0 -> I1 pass; its boundary window moves by more
    than 1e-3. The port's stays within 1e-4 of drba_tpu's uninterrupted
    run (and is the port's own uninterrupted run's, bitwise: above)."""
    ends, k, runs = float_runs
    end = ends[4]  # the boundary window: the one k lies in
    jax_gap = max(float(np.abs(g - w).max())
                  for g, w in zip(runs["jax resumed"][:end - k], runs["jax"][k:end]))
    assert jax_gap > 1e-3, jax_gap
    port_gap = max(float(np.abs(g - w).max())
                   for g, w in zip(runs["port resumed"][:end - k], runs["jax"][k:end]))
    assert port_gap <= 1e-4, port_gap


# ------------------------------------------------------------------------ segments and the CLI


def _make_video(path, n_frames=10, fps=12):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    rng = np.random.default_rng(0)
    # smooth content: the codec's noise on random noise would swamp the checks
    base = cv2.GaussianBlur(rng.uniform(0, 255, (H, W, 3)).astype(np.uint8), (11, 11), 4)
    for i in range(n_frames):
        vw.write(np.roll(base, 4 * i, axis=1))
    vw.release()


def _read_video(path):
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    ok, f = cap.read()
    while ok:
        out.append(f)
        ok, f = cap.read()
    cap.release()
    return out


def _cli(inp, out, *extra):
    from drba_tpu_torch.cli import main

    return main(["-m", "rife", "-i", inp, "-o", out, "-t", "2", "--fp32", "--device", "cpu",
                 "--weights", os.path.join(os.path.dirname(out), "none"), *extra])


def test_segmented_run_resumes_a_crashed_run(tmp_path):
    """As tests/test_resume.py does for drba_tpu: an uninterrupted segmented
    run, then a crashed run (two segments committed, nothing concatenated)
    resumed with ``--resume``; the output has the uninterrupted frame count,
    and the freshly computed tail matches within the codec's noise."""
    from drba_tpu_torch.utils.segmented_io import SegmentedVideoIO

    inp = str(tmp_path / "in.mp4")
    _make_video(inp)
    gold = str(tmp_path / "gold.mp4")
    stats = _cli(inp, gold, "--seg-frames", "6")
    assert stats.frames_out == 20
    assert not os.path.exists(gold + ".segments")  # removed once concatenated
    gold_frames = _read_video(gold)
    assert len(gold_frames) == 20

    out = str(tmp_path / "out.mp4")
    vio = SegmentedVideoIO(inp, out, times=2, seg_frames=6)
    for f in gold_frames[:12]:
        vio.write_frame(f)
    vio.write_buffer.put(None)  # the crash: segments committed, no concatenation
    vio._writer_t.join(timeout=60)
    with open(out + ".segments/manifest.json") as f:
        done = sum(s["frames"] for s in json.load(f)["segments"])
    assert done == 12 and not os.path.exists(out)

    stats = _cli(inp, out, "--seg-frames", "6", "--resume")
    assert stats.frames_out == 20 - done
    frames = _read_video(out)
    assert len(frames) == 20
    tail = max(float(np.abs(a.astype(np.int16) - b).mean())
               for a, b in zip(frames[done:], gold_frames[done:]))
    assert tail < 1.5, tail


def test_manifest_drops_stale_segments_and_refuses_other_settings(tmp_path):
    from drba_tpu_torch.utils.segmented_io import SegmentedVideoIO

    inp = str(tmp_path / "in.mp4")
    _make_video(inp)
    out = str(tmp_path / "out.mp4")
    work = out + ".segments"
    os.makedirs(work)
    with open(os.path.join(work, "manifest.json"), "w") as f:
        json.dump({"dst_fps": 24.0, "size": [W, H],
                   "segments": [{"file": "seg_00000.mp4", "frames": 6}]}, f)
    for name in ("seg_00000.mp4", "seg_00001.mp4"):  # the second was in flight
        open(os.path.join(work, name), "wb").close()
    vio = SegmentedVideoIO(inp, out, times=2, seg_frames=6)
    assert vio.completed_frames == 6
    assert sorted(os.listdir(work)) == ["manifest.json", "seg_00000.mp4"]
    vio.write_buffer.put(None)
    vio._writer_t.join(timeout=60)
    with pytest.raises(ValueError, match="other output settings"):
        SegmentedVideoIO(inp, out, times=3, seg_frames=6)


def test_segment_writer_failure_reraises_on_the_producer(tmp_path, monkeypatch):
    from drba_tpu_torch.utils.segmented_io import SegmentedVideoIO

    inp = str(tmp_path / "in.mp4")
    _make_video(inp)
    vio = SegmentedVideoIO(inp, str(tmp_path / "out.mp4"), times=2, seg_frames=6)

    def broken(index):
        raise OSError("disk full")

    monkeypatch.setattr(vio, "_open_segment", broken)
    frame = np.zeros((H, W, 3), np.uint8)
    with pytest.raises(RuntimeError, match="encode failed") as e:
        for _ in range(1000):
            vio.write_frame(frame)
    assert isinstance(e.value.__cause__, OSError)
    with pytest.raises(RuntimeError, match="encode failed"):
        vio.finish_writing()


def test_resume_without_seg_frames_raises(tmp_path):
    inp = str(tmp_path / "in.mp4")
    _make_video(inp, n_frames=3)
    with pytest.raises(ValueError, match="--seg-frames"):
        _cli(inp, str(tmp_path / "out.mp4"), "--resume")


def test_profile_prints_the_stage_report(tmp_path, capsys):
    inp = str(tmp_path / "in.mp4")
    _make_video(inp, n_frames=5)
    stats = _cli(inp, str(tmp_path / "out.mp4"), "--profile", "--splat-backend", "torch")
    assert stats.frames_out == 10
    printed = capsys.readouterr().out
    for stage in ("stage timings:", "window", "emit-wait", "prefetch-wait", "finish"):
        assert stage in printed and stage in stats.stage_report


@pytest.mark.parametrize("listing,want", [
    (" V....D h264_nvenc           NVIDIA NVENC H.264 encoder\n", "h264_nvenc"),
    (" V....D libx264              libx264 H.264\n", "libx264"),
    ("", "libx264")])
def test_select_encoder_probes_ffmpeg(listing, want, monkeypatch):
    """``-hw`` takes NVENC only where this ffmpeg has it, else libx264 with a
    fast preset; plain mode is libx264 medium."""
    from drba_tpu_torch.utils import video_io

    monkeypatch.setattr(video_io, "_ffmpeg_encoders", lambda: listing)
    args = video_io.select_encoder(True)
    assert args[args.index("-c:v") + 1] == want
    if want == "libx264":
        assert args[args.index("-preset") + 1] == "fast"
    assert video_io.select_encoder(False) == ["-c:v", "libx264", "-qp", "16", "-preset",
                                              "medium"]


def test_hw_flag_writes_a_file(tmp_path):
    inp = str(tmp_path / "in.mp4")
    _make_video(inp, n_frames=5)
    out = str(tmp_path / "hw.mp4")
    assert _cli(inp, out, "-hw").frames_out == 10
    assert len(_read_video(out)) == 10


def test_demo_interpolates_every_clip_of_a_folder(tmp_path):
    """``python -m drba_tpu_torch.demo``: each video of the folder through
    ``cli.main`` (times mode), written as ``<name>_2x.mp4``; other files
    are left alone."""
    from drba_tpu_torch import demo

    inp, out = tmp_path / "clips", tmp_path / "out"
    inp.mkdir()
    _make_video(str(inp / "a.mp4"), n_frames=6)
    _make_video(str(inp / "b.avi"), n_frames=4)
    (inp / "notes.txt").write_text("not a clip")
    stats = demo.main(["--input_dir", str(inp), "--output_dir", str(out), "-m", "rife",
                       "-t", "2", "--device", "cpu", "--weights", str(tmp_path / "none")])
    assert [s.frames_out for s in stats] == [12, 8]
    assert sorted(os.listdir(out)) == ["a_2x.mp4", "b_2x.mp4"]
    assert len(_read_video(str(out / "a_2x.mp4"))) == 12
    assert len(_read_video(str(out / "b_2x.mp4"))) == 8


# ------------------------------------------------------------------------------- debug helpers


def test_mark_tensor_burns_text_in():
    from drba_tpu_torch.utils.debug import mark_tensor

    frame = torch.zeros(1, 48, 160, 3, dtype=torch.float64)
    out = mark_tensor(frame, "t=0.40")
    assert out.shape == frame.shape and out.dtype == frame.dtype
    assert float(out.max()) > 0.9 and float(out[:, :, :80].max()) == 0.0  # top-right only
