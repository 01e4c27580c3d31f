"""The port's host runtime (``csrc/host.cpp`` through ``utils/native.py``)
against drba_tpu's (``native/drba_host.cpp``) and the plain numpy versions,
and the writers' rgb24 flip through it.

The library builds with this machine's C++ compiler; the tests skip only
where there is none on PATH, as tests/test_native.py does. The writers run
against a stand-in ``ffmpeg`` on PATH that copies its standard input to its
last argument (and, for the segments' concat, the listed files), so the bytes
that reach ffmpeg's pipe are read back.
"""

import os
import shutil
import sys
import threading

import numpy as np
import pytest

from drba_tpu.utils import native as drba_tpu_native
from drba_tpu_torch import _build
from drba_tpu_torch.utils import native

H, W = 64, 128  # the clip of the writer tests (as tests/test_torch_resume.py)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def require_cxx():
    if shutil.which(os.environ.get("CXX") or "c++") is None:
        pytest.skip("no C++ compiler on PATH")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """drba_tpu's library, built from a copy of ``native/`` in a temporary
    directory, so that this file never races tests/test_native.py (another
    pytest worker) building ``native/libdrba_host.so`` in place."""
    d = tmp_path_factory.mktemp("native")
    for f in ("Makefile", "drba_host.cpp"):
        shutil.copy(os.path.join(ROOT, "native", f), d)
    mp = pytest.MonkeyPatch()
    mp.setattr(drba_tpu_native, "_NATIVE_DIR", str(d))
    mp.setattr(drba_tpu_native, "_LIB_PATH", str(d / "libdrba_host.so"))
    mp.setattr(drba_tpu_native, "_lib", None)
    mp.setattr(drba_tpu_native, "_build_failed", False)
    yield drba_tpu_native
    mp.undo()


def _bgr(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


# ------------------------------------------------------------------------------ converters


@pytest.mark.parametrize("threads", [0, 1, 3])
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (270, 480)])
def test_converters_match_drba_tpu_and_numpy(shape, threads, jax_native):
    frame = _bgr(*shape)
    rgb = native.bgr8_to_rgb8(frame, threads=threads)
    np.testing.assert_array_equal(rgb, native.bgr8_to_rgb8_plain(frame))
    np.testing.assert_array_equal(rgb, jax_native.bgr8_to_rgb8(frame, threads=threads))

    # times 1/255 against numpy's division: within an f32 ulp of 1
    f = native.bgr8_to_rgbf32(frame, threads=threads)
    assert f.dtype == np.float32 and f.shape == frame.shape
    np.testing.assert_allclose(f, native.bgr8_to_rgbf32_plain(frame), rtol=0, atol=1e-7)
    np.testing.assert_allclose(f, jax_native.bgr8_to_rgbf32(frame, threads=threads),
                               rtol=0, atol=1e-7)

    x = np.random.default_rng(1).uniform(-0.1, 1.1, shape + (3,)).astype(np.float32)
    b = native.rgbf32_to_bgr8(x, threads=threads)
    np.testing.assert_array_equal(b, native.rgbf32_to_bgr8_plain(x))
    np.testing.assert_array_equal(b, jax_native.rgbf32_to_bgr8(x, threads=threads))


def test_flip_into_a_reused_buffer_and_from_a_strided_view():
    frame = _bgr(40, 96)
    out = np.empty((40, 48, 3), np.uint8)
    view = frame[:, ::2]  # not contiguous
    assert native.bgr8_to_rgb8(view, out=out) is out
    np.testing.assert_array_equal(out, view[:, :, ::-1])
    with pytest.raises(ValueError, match="out must be"):
        native.bgr8_to_rgb8(frame, out=out)
    with pytest.raises(TypeError):
        native.bgr8_to_rgb8(frame.astype(np.float32))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        native.bgr8_to_rgb8(frame[:, :, :2])


def test_a_failed_build_raises_and_returns_no_numpy_output(tmp_path, monkeypatch):
    """No fallback: with a compiler that fails (``CXX=false``) a fresh build
    raises, where drba_tpu warns and flips in numpy."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.HOST, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed for host.cpp"):
        native.bgr8_to_rgb8(_bgr(4, 4))
    with pytest.raises(RuntimeError):
        native.FrameRing(16, 2)
    assert not native.available()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


# ------------------------------------------------------------------------------------ ring


def test_ring_order_capacity_and_codes():
    slot = 64
    ring = native.FrameRing(slot, 5)  # rounds up to 8
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, slot, dtype=np.uint8) for _ in range(10)]
    out = np.empty(slot, np.uint8)
    assert ring.pop(out) == 0  # empty, not closed
    for f in frames[:8]:
        assert ring.push(f) == 1
    assert len(ring) == 8
    assert ring.push(frames[8]) == 0  # full
    assert ring.pop(out) == slot
    np.testing.assert_array_equal(out, frames[0])
    assert ring.push(frames[8]) == 1
    short = frames[9][:10]  # a frame shorter than the slot keeps its length
    for want in frames[1:9]:
        assert ring.pop(out) == slot
        np.testing.assert_array_equal(out, want)
    assert ring.push(short) == 1
    assert ring.pop(out) == 10
    np.testing.assert_array_equal(out[:10], short)
    ring.close()
    assert ring.push(frames[0]) == -1
    assert ring.pop(out) == -1  # closed and drained


def test_ring_refuses_an_oversize_push_and_a_small_pop():
    ring = native.FrameRing(32, 2)
    with pytest.raises(ValueError, match="> slot"):
        ring.push(np.zeros(33, np.uint8))
    assert ring.push(np.arange(32, dtype=np.uint8)) == 1
    with pytest.raises(ValueError, match="< slot"):
        ring.pop(np.empty(31, np.uint8))
    with pytest.raises(ValueError, match="writeable"):
        ring.pop(np.empty(64, np.uint8)[::2])
    out = np.empty(32, np.uint8)
    assert ring.pop(out) == 32  # the refused pops left the frame queued
    np.testing.assert_array_equal(out, np.arange(32))
    with pytest.raises(ValueError):
        native.FrameRing(0, 4)


def test_ring_across_two_threads():
    """A producer and a consumer thread; the consumer sees every frame in
    order, and the closed code only after the last."""
    slot, n = 4096, 300
    ring = native.FrameRing(slot, 4)
    received = []

    def consumer():
        out = np.empty(slot, np.uint8)
        while True:
            rc = ring.pop(out)
            if rc == -1:
                return
            if rc > 0:
                received.append(out[:rc].copy())

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=consumer, daemon=True)
        t.start()
        sent = []
        for i in range(n):
            f = np.full(slot - i % 7, i % 251, np.uint8)
            while (rc := ring.push(f)) == 0:
                pass
            assert rc == 1
            sent.append(f)
        ring.close()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    assert len(received) == n
    for a, b in zip(received, sent):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------------- writers

_STUB = """#!{python}
import shutil, sys
args = sys.argv[1:]
with open(args[-1], "wb") as out:
    if "concat" in args:  # the segments' concat: the listed files, in order
        with open(args[args.index("-i") + 1]) as lst:
            for line in lst:
                with open(line.strip()[len("file '"):-1], "rb") as seg:
                    shutil.copyfileobj(seg, out)
    else:
        shutil.copyfileobj(sys.stdin.buffer, out)
"""


@pytest.fixture
def stub_ffmpeg(tmp_path, monkeypatch):
    """A stand-in ``ffmpeg`` first on PATH, no encoder probe, and a count of
    the native flips (``flips``: the frames each was given)."""
    from drba_tpu_torch.utils import video_io

    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "ffmpeg"
    exe.write_text(_STUB.format(python=sys.executable))
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setattr(video_io, "_ffmpeg_encoders", lambda: "")
    flips = []
    flip = native.bgr8_to_rgb8

    def counted(frame, *a, **k):
        flips.append(frame.shape)
        return flip(frame, *a, **k)

    monkeypatch.setattr(native, "bgr8_to_rgb8", counted)
    assert shutil.which("ffmpeg") == str(exe)
    return flips


def _make_video(path, n_frames=5, fps=12):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    base = cv2.GaussianBlur(_bgr(H, W), (11, 11), 4)
    for i in range(n_frames):
        vw.write(np.roll(base, 4 * i, axis=1))
    vw.release()


def _frames(n):
    """Frames as a pipeline hands them over; every other one a strided view."""
    out = []
    for i in range(n):
        f = _bgr(H, 2 * W, seed=10 + i)
        out.append(f[:, ::2] if i % 2 else np.ascontiguousarray(f[:, :W]))
    return out


def _flipped(frames) -> bytes:
    return b"".join(np.ascontiguousarray(f[:, :, ::-1]).tobytes() for f in frames)


def test_video_writer_flips_through_the_native_library(tmp_path, stub_ffmpeg):
    from drba_tpu_torch.utils.video_io import VideoFI_IO

    inp, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    _make_video(inp)
    io = VideoFI_IO(inp, out, times=2)
    frames = _frames(7)
    for f in frames:
        io.write_frame(f)
    assert io.finish_writing()
    with open(out, "rb") as fh:
        assert fh.read() == _flipped(frames)
    assert len(stub_ffmpeg) == len(frames)


def test_segmented_writer_flips_through_the_native_library(tmp_path, stub_ffmpeg):
    """Segments of 3 frames, the frame shape changing between segments (the
    reused buffer follows it); the concat of the segments is every frame
    flipped, in order."""
    from drba_tpu_torch.utils.segmented_io import SegmentedVideoIO

    inp, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    _make_video(inp)
    io = SegmentedVideoIO(inp, out, times=2, seg_frames=3)
    frames = _frames(4) + [np.ascontiguousarray(f[: H // 2]) for f in _frames(3)]
    for f in frames:
        io.write_frame(f)
    assert io.finish_writing()
    with open(out, "rb") as fh:
        assert fh.read() == _flipped(frames)
    assert stub_ffmpeg == [f.shape for f in frames]


def test_cli_writes_every_frame_through_the_native_flip(tmp_path, stub_ffmpeg, monkeypatch):
    """``cli.main -m rife -t 2 --device cpu`` with ffmpeg on PATH: the pipe
    gets the plan's frame count times h·w·3 bytes, each frame the pipeline
    wrote flipped to rgb24, one native flip a frame."""
    from drba_tpu_torch.cli import main
    from drba_tpu_torch.utils import video_io

    written = []
    write = video_io.VideoFI_IO.write_frame

    def recorded(self, frame):
        written.append(np.array(frame))
        write(self, frame)

    monkeypatch.setattr(video_io.VideoFI_IO, "write_frame", recorded)
    inp, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    _make_video(inp, n_frames=5)
    stats = main(["-m", "rife", "-i", inp, "-o", out, "-t", "2", "--device", "cpu",
                  "--weights", str(tmp_path / "none")])
    assert stats.frames_out == 10
    with open(out, "rb") as fh:
        data = fh.read()
    assert len(data) == stats.frames_out * H * W * 3
    assert data == _flipped(written)
    assert len(stub_ffmpeg) == len(written) == stats.frames_out
