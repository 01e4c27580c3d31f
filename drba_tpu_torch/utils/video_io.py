"""Threaded video decode/encode (counterpart of drba_tpu/utils/video_io.py).

A decoder thread (``cv2.VideoCapture`` into a bounded queue) and an encoder
thread draining a bounded queue into an ``ffmpeg`` rawvideo pipe when an
``ffmpeg`` binary exists (keeping the source's audio; each frame flipped to
rgb24 by the host library, ``utils/native.py``, into a reused buffer), else
a ``cv2.VideoWriter``. ``cv2`` is imported where it is used, so the package
imports without it.
"""

from __future__ import annotations

import functools
import os
import queue
import shutil
import subprocess
import threading

import numpy as np

from drba_tpu_torch.utils import native
from drba_tpu_torch.utils.log import get_logger


@functools.lru_cache(maxsize=1)
def _ffmpeg_encoders() -> str:
    """The host ffmpeg's encoder list (probed once per process; empty when
    ffmpeg cannot be run)."""
    try:
        out = subprocess.run(["ffmpeg", "-hide_banner", "-encoders"], capture_output=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.decode("utf-8", "replace")


def select_encoder(hwaccel: bool) -> list[str]:
    """ffmpeg video-encoder args for the ``-hw`` flag.

    The reference hard-codes ``h264_nvenc`` behind ``-hw``
    (models/utils/tools.py:176-178), which fails on an ffmpeg built without
    NVENC. The encoder list is probed once, and the first hardware encoder
    present is taken (nvenc, videotoolbox, vaapi); else libx264 with a fast
    preset and a warning, so ``-hw`` never fails where plain mode works.
    """
    if not hwaccel:
        return ["-c:v", "libx264", "-qp", "16", "-preset", "medium"]
    enc = _ffmpeg_encoders()
    if " h264_nvenc " in enc:
        return ["-c:v", "h264_nvenc", "-qp", "16", "-preset", "p7"]
    if " h264_videotoolbox " in enc:
        return ["-c:v", "h264_videotoolbox", "-q:v", "65"]
    if " h264_vaapi " in enc and os.path.exists("/dev/dri/renderD128"):
        return ["-vf", "format=nv12,hwupload", "-vaapi_device", "/dev/dri/renderD128",
                "-c:v", "h264_vaapi", "-qp", "16"]
    get_logger("drba_tpu_torch.video_io").warning(
        "no hardware h264 encoder in this ffmpeg; -hw falls back to libx264 -preset fast")
    return ["-c:v", "libx264", "-qp", "16", "-preset", "fast"]


class VideoFI_IO:
    """Frame source and sink: ``read_frame`` / ``write_frame`` /
    ``finish_writing`` / ``src_fps`` / ``dst_fps`` (the pipeline's interface)."""

    def __init__(self, input_path: str, output_path: str, dst_fps: float = 60,
                 times: int = -1, hwaccel: bool = False, read_queue: int = 100,
                 write_queue: int = 256):
        import cv2

        self.capture = cv2.VideoCapture(input_path)
        if not self.capture.isOpened():
            raise FileNotFoundError(f"cannot open video {input_path}")
        self.src_fps = self.capture.get(cv2.CAP_PROP_FPS)
        self.dst_fps = times * self.src_fps if times != -1 else dst_fps
        self.total_frames_count = int(self.capture.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self.capture.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.capture.get(cv2.CAP_PROP_FRAME_HEIGHT))

        self._ffmpeg = None
        self._writer = None
        if shutil.which("ffmpeg"):
            native.load()  # the rgb24 flip's library: build it (or raise) before ffmpeg starts
            cmd = ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                   "-r", f"{self.dst_fps}", "-s", f"{self.width}x{self.height}",
                   "-i", "pipe:0", "-i", input_path, "-map", "0:v", "-map", "1:a?",
                   *select_encoder(hwaccel), "-movflags", "+faststart", "-pix_fmt", "yuv420p",
                   "-c:a", "aac", "-b:a", "320k", output_path]
            self._ffmpeg = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        else:
            self._writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                           self.dst_fps, (self.width, self.height))
            if not self._writer.isOpened():
                raise RuntimeError(f"cannot open encoder for {output_path}")

        self.read_buffer: queue.Queue = queue.Queue(maxsize=read_queue)
        self.write_buffer: queue.Queue = queue.Queue(maxsize=write_queue)
        self._reader_exc: BaseException | None = None
        self._writer_exc: BaseException | None = None
        self._closed = False
        self._reader_t = threading.Thread(target=self._read_loop, daemon=True)
        self._writer_t = threading.Thread(target=self._write_loop, daemon=True)
        self._reader_t.start()
        self._writer_t.start()

    def _read_loop(self):
        try:
            ok, frame = self.capture.read()
            while ok:
                self.read_buffer.put(frame)
                ok, frame = self.capture.read()
        except Exception as e:  # surfaced by read_frame
            self._reader_exc = e
        finally:
            self.read_buffer.put(None)
            self.capture.release()

    def _write_loop(self):
        rgb = None  # the flip's buffer, reused while the frame shape holds
        while True:
            item = self.write_buffer.get()
            if item is None:
                break
            if self._writer_exc is not None:
                continue  # drain: unblock producers, drop frames
            try:
                if self._ffmpeg is not None:
                    if rgb is None or rgb.shape != item.shape:
                        rgb = np.empty(item.shape, np.uint8)
                    self._ffmpeg.stdin.write(native.bgr8_to_rgb8(item, out=rgb))  # BGR -> rgb24
                else:
                    self._writer.write(item)
            except Exception as e:  # surfaced by write_frame / finish_writing
                if self._ffmpeg is not None and self._ffmpeg.poll() is not None:
                    e = RuntimeError(f"ffmpeg exited with code {self._ffmpeg.returncode} "
                                     "while frames were still being written")
                self._writer_exc = e
        try:
            if self._ffmpeg is not None:
                self._ffmpeg.stdin.close()
                self._ffmpeg.wait()
            else:
                self._writer.release()
        except Exception as e:
            self._writer_exc = self._writer_exc or e

    def write_frame(self, frame) -> None:
        if self._writer_exc is not None:
            raise RuntimeError("video encode failed") from self._writer_exc
        self.write_buffer.put(frame)

    def read_frame(self):
        item = self.read_buffer.get()
        if item is None and self._reader_exc is not None:
            raise RuntimeError("video decode failed") from self._reader_exc
        return item

    def finish_writing(self) -> bool:
        if not self._closed:
            self._closed = True
            self.write_buffer.put(None)
        self._writer_t.join(timeout=600)
        if self._writer_exc is not None:
            raise RuntimeError("video encode failed") from self._writer_exc
        return not self._writer_t.is_alive()
