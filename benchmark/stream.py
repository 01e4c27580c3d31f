"""The traffic generator: an endless seeded anime stream, served to the
program as a decoder and an encoder would be.

A traffic file (``benchmark/traffic/<name>.json``) states the parameters:

* ``src_fps`` / ``dst_fps``: the conversion (24 -> 60);
* ``scene_detection`` and ``scdet_threshold``: the program's ``-s -st``;
* ``shot_frames``: ``min``, ``max``, ``step``: the shot lengths of the
  reel, each length of the range once, in a seeded order, so that every
  seed has the same lengths and cuts per frame;
* ``pan_px_per_frame`` and ``hold_frames``: within a shot a texture pans
  (seeded direction), each drawing held for ``hold_frames`` frames ("on
  twos"), so a drawing moves ``pan * hold`` px from the one before;
* ``texture_cell_px``: each shot's texture is seeded uint8 noise drawn at
  1/cell of the frame and upsampled bicubically (a smooth texture at full
  contrast), so a shot's pairs score a high 32x32 SSIM and a cut, to an
  independent texture, a low one;
* ``warmup_shot_frames``: the shots of the short clip that set-up runs
  before the window, so that every call the window makes is captured.

The reel is its shots back to back; the stream repeats it, so its end to
its start is one more cut. Every distinct drawing is made on the device in
set-up and kept in host memory; a held frame is a view of the same memory.

The sink keeps a print of every frame written (every ``PRINT_STRIDE``-th
row and column), from which the check reads each frame's kind.
"""

from __future__ import annotations

import collections
import json
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

PRINT_STRIDE = 16


def load(path: str) -> dict:
    with open(path) as f:
        t = json.load(f)
    for key in ("src_fps", "dst_fps", "scene_detection", "scdet_threshold", "shot_frames",
                "pan_px_per_frame", "hold_frames", "texture_cell_px", "warmup_shot_frames"):
        if key not in t:
            raise ValueError(f"{path}: traffic key {key!r} missing")
    return t


def shot_lengths(traffic: dict, seed: int) -> list:
    s = traffic["shot_frames"]
    lengths = list(range(int(s["min"]), int(s["max"]) + 1, int(s.get("step", 1))))
    order = np.random.default_rng([seed, 1]).permutation(len(lengths))
    return [lengths[i] for i in order]


class Reel:
    """Shots of ``lengths`` frames at (h, w), textures and pan directions
    from ``seed``, made on ``device`` and kept on the host."""

    def __init__(self, traffic: dict, lengths, h: int, w: int, seed: int, device):
        if len(lengths) < 2:
            raise ValueError("a reel needs two shots or more (its wrap is a cut)")
        hold = int(traffic["hold_frames"])
        step = int(traffic["pan_px_per_frame"]) * hold
        cell = int(traffic["texture_cell_px"])
        self.lengths = list(lengths)
        self.hold = hold
        self.starts = np.concatenate([[0], np.cumsum(self.lengths)])
        drawings = [math.ceil(n / hold) for n in self.lengths]
        self.first_drawing = np.concatenate([[0], np.cumsum(drawings)])
        self.frames = np.empty((int(self.first_drawing[-1]), h, w, 3), np.uint8)
        host = torch.from_numpy(self.frames)
        gen = torch.Generator(device=device).manual_seed(seed)
        dirs = np.random.default_rng([seed, 2]).integers(0, 2, len(self.lengths))
        for s, d in enumerate(drawings):
            width = w + step * (d - 1)
            small = torch.randint(0, 256, (1, 3, h // cell + 2, width // cell + 2),
                                  generator=gen, device=device).float()
            tex = F.interpolate(small, scale_factor=cell, mode="bicubic", align_corners=False)
            tex = tex[0, :, :h, :width].round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0)
            offs = [step * k if dirs[s] else step * (d - 1 - k) for k in range(d)]
            stack = torch.stack([tex[:, o:o + w] for o in offs])
            host[self.first_drawing[s]:self.first_drawing[s + 1]].copy_(stack)

    def __len__(self) -> int:
        return int(self.starts[-1])

    def frame(self, j: int) -> np.ndarray:
        """Frame ``j`` of the endless stream (HWC uint8, BGR as decoded)."""
        r = j % len(self)
        s = int(np.searchsorted(self.starts, r, side="right")) - 1
        return self.frames[self.first_drawing[s] + (r - self.starts[s]) // self.hold]

    def cuts(self, n: int) -> np.ndarray:
        """``cuts[k]``: frames k and k + 1 lie in different shots, k < n - 1."""
        k = np.arange(max(n - 1, 0)) + 1
        return np.isin(k % len(self), self.starts[:-1])


class Source:
    """The video I/O ``run_pipeline`` drives (``read_frame``, ``write_frame``,
    ``finish_writing``, ``src_fps``, ``dst_fps``), over ``reel``.

    It hands out frames until ``limit`` frames or, once :meth:`start` set
    it, the deadline, then None. It dates each frame it hands out and each
    one written, counts them, and keeps the written frames that ``keep``
    (output index -> bool) selects and the last ``tail`` ones, and a print
    of every one (``prints``).
    """

    def __init__(self, reel: Reel, traffic: dict, limit: int | None = None, keep=None,
                 tail: int = 4):
        self.reel = reel
        self.src_fps = float(traffic["src_fps"])
        self.dst_fps = float(traffic["dst_fps"])
        self.limit = limit
        self.deadline = None
        self.keep = keep
        self.read_at: list = []
        self.written_at: list = []
        self.kept: dict = {}
        self.prints: list = []
        self.last = collections.deque(maxlen=tail)

    def start(self, seconds: float) -> float:
        """Stop handing out frames ``seconds`` from now; returns now."""
        now = time.perf_counter()
        self.deadline = now + seconds
        return now

    def read_frame(self):
        n = len(self.read_at)
        if self.limit is not None and n >= self.limit:
            return None
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            return None
        img = self.reel.frame(n)
        self.read_at.append(time.perf_counter())
        return img

    def write_frame(self, arr: np.ndarray) -> None:
        j = len(self.written_at)
        self.written_at.append(time.perf_counter())
        self.prints.append(arr[::PRINT_STRIDE, ::PRINT_STRIDE].copy())
        if self.keep is not None and self.keep(j):
            self.kept[j] = arr
        self.last.append((j, arr))

    def finish_writing(self) -> None:
        pass

    def frames_kept(self) -> dict:
        return {**self.kept, **dict(self.last)}
