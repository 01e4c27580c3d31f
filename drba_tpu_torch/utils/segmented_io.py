"""Segmented output with a manifest: crash-safe encoding and resume
(counterpart of drba_tpu/utils/segmented_io.py, same manifest format).

* Output goes into fixed-length segments ``<out>.segments/seg_00000.mp4``. A
  segment enters ``manifest.json`` only after its encoder exited cleanly, and
  the manifest is replaced atomically (written to a tmp file, then renamed),
  so a crash costs at most the segment in flight.
* On load, segment files the manifest does not list (a crashed run's segment
  in flight) are removed, and a manifest written for other output settings
  raises.
* ``completed_frames`` tells ``run_pipeline`` how many output frames exist
  (its ``skip_outputs``); the run goes on into the next segment.
* Each frame goes to a segment's ffmpeg as rgb24, flipped by the host
  library (``utils/native.py``) into a reused buffer; without ffmpeg, to a
  ``cv2.VideoWriter``.
* ``finish_writing`` stream-concatenates the segments with ffmpeg (no
  re-encode) and muxes the source's audio in; without ffmpeg it re-muxes by
  decoding the segments with cv2.
* A writer failure re-raises on the producer, at ``write_frame`` and
  ``finish_writing``.

The surface is ``VideoFI_IO``'s (``read_frame`` / ``write_frame`` /
``finish_writing`` / ``src_fps`` / ``dst_fps`` / ``total_frames_count``), so
both pipelines take it unchanged. ``cv2`` is imported where it is used.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import subprocess
import threading

import numpy as np

from drba_tpu_torch.utils import native
from drba_tpu_torch.utils.video_io import select_encoder


class SegmentedVideoIO:
    def __init__(self, input_path: str, output_path: str, dst_fps: float = 60, times: int = -1,
                 hwaccel: bool = False, seg_frames: int = 600, read_queue: int = 100,
                 write_queue: int = 256):
        import cv2

        if seg_frames < 1:
            raise ValueError(f"seg_frames must be >= 1, got {seg_frames}")
        self.capture = cv2.VideoCapture(input_path)
        if not self.capture.isOpened():
            raise FileNotFoundError(f"cannot open video {input_path}")
        self.src_fps = self.capture.get(cv2.CAP_PROP_FPS)
        self.dst_fps = times * self.src_fps if times != -1 else dst_fps
        self.total_frames_count = int(self.capture.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self.capture.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.capture.get(cv2.CAP_PROP_FRAME_HEIGHT))

        self.input_path = input_path
        self.output_path = output_path
        self.hwaccel = hwaccel
        self.seg_frames = int(seg_frames)
        self.work_dir = output_path + ".segments"
        os.makedirs(self.work_dir, exist_ok=True)
        self.manifest_path = os.path.join(self.work_dir, "manifest.json")
        self._manifest = self._load_manifest()
        self.completed_frames = sum(s["frames"] for s in self._manifest["segments"])
        if shutil.which("ffmpeg"):
            native.load()  # the rgb24 flip's library: build it (or raise) before any frame

        self.read_buffer: queue.Queue = queue.Queue(maxsize=read_queue)
        self.write_buffer: queue.Queue = queue.Queue(maxsize=write_queue)
        self._reader_exc: BaseException | None = None
        self._writer_exc: BaseException | None = None
        self._closed = False
        self._reader_t = threading.Thread(target=self._read_loop, daemon=True)
        self._writer_t = threading.Thread(target=self._write_loop, daemon=True)
        self._reader_t.start()
        self._writer_t.start()

    # -- manifest ---------------------------------------------------------------------
    def _load_manifest(self) -> dict:
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                m = json.load(f)
            if m.get("dst_fps") != self.dst_fps or m.get("size") != [self.width, self.height]:
                raise ValueError(f"manifest at {self.manifest_path} was written for other output "
                                 f"settings; delete {self.work_dir} to start over")
            known = {s["file"] for s in m["segments"]}
            for f in os.listdir(self.work_dir):
                if f.startswith("seg_") and f not in known:  # a crashed run's segment in flight
                    os.remove(os.path.join(self.work_dir, f))
            return m
        return {"dst_fps": self.dst_fps, "size": [self.width, self.height], "segments": []}

    def _commit_segment(self, fname: str, frames: int) -> None:
        self._manifest["segments"].append({"file": fname, "frames": frames})
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=1)
        os.replace(tmp, self.manifest_path)

    # -- decode -------------------------------------------------------------------------
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

    def read_frame(self):
        item = self.read_buffer.get()
        if item is None and self._reader_exc is not None:
            raise RuntimeError("video decode failed") from self._reader_exc
        return item

    # -- segmented encode ---------------------------------------------------------------
    def _open_segment(self, index: int):
        fname = f"seg_{index:05d}.mp4"
        path = os.path.join(self.work_dir, fname)
        if shutil.which("ffmpeg"):
            proc = subprocess.Popen(
                ["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo", "-pix_fmt", "rgb24",
                 "-r", f"{self.dst_fps}", "-s", f"{self.width}x{self.height}", "-i", "pipe:0",
                 *select_encoder(self.hwaccel), "-pix_fmt", "yuv420p", path],
                stdin=subprocess.PIPE)
            return fname, proc, None
        import cv2

        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), self.dst_fps,
                                 (self.width, self.height))
        if not writer.isOpened():
            raise RuntimeError(f"cannot open encoder for {path}")
        return fname, None, writer

    @staticmethod
    def _close_segment(proc, writer):
        if proc is not None:
            proc.stdin.close()
            if proc.wait() != 0:
                raise RuntimeError(f"segment encoder exited with code {proc.returncode}")
        if writer is not None:
            writer.release()

    def _write_loop(self):
        index = len(self._manifest["segments"])
        fname = proc = writer = None
        n = 0
        rgb = None  # the flip's buffer, reused while the frame shape holds
        while True:
            item = self.write_buffer.get()
            if item is None:
                break
            if self._writer_exc is not None:
                continue  # drain: unblock the producer, drop frames
            try:
                if fname is None:
                    fname, proc, writer = self._open_segment(index)
                    n = 0
                if proc is not None:
                    if rgb is None or rgb.shape != item.shape:
                        rgb = np.empty(item.shape, np.uint8)
                    proc.stdin.write(native.bgr8_to_rgb8(item, out=rgb))  # BGR -> rgb24
                else:
                    writer.write(item)
                n += 1
                if n >= self.seg_frames:
                    self._close_segment(proc, writer)
                    self._commit_segment(fname, n)
                    index += 1
                    fname = proc = writer = None
            except Exception as e:  # re-raised on the producer; committed segments stay
                if proc is not None and proc.poll() is not None:
                    e = RuntimeError(f"segment encoder exited with code {proc.returncode}")
                self._writer_exc = e
        if fname is not None and self._writer_exc is None:
            try:
                self._close_segment(proc, writer)
                self._commit_segment(fname, n)
            except Exception as e:
                self._writer_exc = e

    def write_frame(self, frame: np.ndarray) -> None:
        if self._writer_exc is not None:
            raise RuntimeError("video encode failed") from self._writer_exc
        self.write_buffer.put(frame)

    # -- finalise -----------------------------------------------------------------------
    def _concat(self) -> None:
        segs = self._manifest["segments"]
        if not segs:
            raise RuntimeError("no completed segments to finalise")
        if shutil.which("ffmpeg"):
            lst = os.path.join(self.work_dir, "concat.txt")
            with open(lst, "w") as f:
                for s in segs:
                    f.write(f"file '{os.path.join(os.path.abspath(self.work_dir), s['file'])}'\n")
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-f", "concat", "-safe", "0", "-i", lst,
                 "-i", self.input_path, "-map", "0:v", "-map", "1:a?", "-c:v", "copy",
                 "-c:a", "aac", "-b:a", "320k", "-movflags", "+faststart", self.output_path],
                check=True)
            return
        import cv2

        out = cv2.VideoWriter(self.output_path, cv2.VideoWriter_fourcc(*"mp4v"), self.dst_fps,
                              (self.width, self.height))
        for s in segs:
            cap = cv2.VideoCapture(os.path.join(self.work_dir, s["file"]))
            ok, fr = cap.read()
            while ok:
                out.write(fr)
                ok, fr = cap.read()
            cap.release()
        out.release()

    def finish_writing(self) -> bool:
        if not self._closed:
            self._closed = True
            self.write_buffer.put(None)
        self._writer_t.join(timeout=600)
        if self._writer_exc is not None:
            raise RuntimeError("video encode failed") from self._writer_exc
        if self._writer_t.is_alive():
            return False
        self._concat()
        shutil.rmtree(self.work_dir, ignore_errors=True)
        return True
