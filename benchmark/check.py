"""Whether the timed path's output is correct, judged by the frozen reference.

While the window runs, :class:`Sampler` keeps the written frames of a
seeded share of the body windows (a higher share beside the cuts), the
head's and the last few. Once the window has closed and the program's
state is freed, ``harness.Run.judge`` compares:

* ``frames_off_plan``: output frames, input frames read and body windows
  against the benchmark's own plan for the frames read (exact);
* ``cuts_off_reference``: the number of the program's scene cuts against
  the number of pairs the reference's 32x32 SSIM scores below the
  threshold (exact);
* ``copy_bad_px``: every written frame that the plan makes a copy of a
  source frame (the head's and tail's outer frames, and the scene-cut
  branches' repeated frames), read from its print (every
  ``stream.PRINT_STRIDE``-th row and column), against the reference's copy
  of that source frame: the largest share, in %, of the print's values
  more than ``frame_bad_levels`` 8-bit levels apart. A cut the program
  misses or places at another pair turns planned copies into frames
  interpolated across it, so with ``cuts_off_reference`` (which catches a
  cut too many) the program's cut pairs must be the reference's;
* ``frame_bad_px``: over a seeded sample of the blocks kept (the head, the
  tail, up to two windows of each cut branch, a chain start and four
  chained DRM windows), frame by frame, how much further the program's
  frame lies from the f32 reference than the same reference computed in
  bf16 (the configuration's precision) does: the share, in %, of the
  written frame's values more than ``frame_bad_levels`` 8-bit levels from
  the f32 reference's frame at the same output index, less that share of
  the bf16 reference's frame, in percentage points; the largest over the
  frames. Both references are recomputed from the source frames and the
  weights. The bf16 term makes the limit hold across seeds: how far bf16
  arithmetic strays on a net of random weights depends on the weights
  (GMFSS_UNION's hard thresholds flip on rounding, more on some seeds and
  frames than others), and the program strays about as far as the bf16
  reference does on the same frame.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import plan, stream
from benchmark.reference import scene

# per window: the chance its frames are kept, by class
KEEP_RATE = {"cut": 0.5, "fused": 1 / 12}
# blocks compared per class
SAMPLE = {"head": 1, "tail": 1, "right": 2, "left": 2, "start": 1, "fused": 4}


def window_class(b: plan.Block) -> str:
    if b.kind != "window":
        return b.kind
    if b.left_cut and b.right_cut:
        return "both"
    if b.left_cut:
        return "left"
    if b.right_cut:
        return "right"
    return "start" if b.chain_start else "fused"


class Sampler:
    """Which written frames a run keeps (``keep``), from the seed and the
    stream's cuts."""

    def __init__(self, seed: int, reel, traffic: dict, windows: int = 100_000):
        self.index = plan.OutputIndex(traffic["src_fps"], traffic["dst_fps"], windows)
        cuts = reel.cuts(windows + 3)
        near_cut = cuts[:windows] | cuts[1:windows + 1] | cuts[np.maximum(np.arange(windows) - 1, 0)]
        rate = np.where(near_cut, KEEP_RATE["cut"], KEEP_RATE["fused"])
        self.windows = np.random.default_rng([seed, 3]).random(windows) < rate

    def keep(self, j: int) -> bool:
        w = self.index.window_of(j)
        return w < 0 or bool(self.windows[w])


def choose(blocks: list, kept: dict, seed: int) -> list:
    """The blocks compared: per class up to ``SAMPLE`` of those whose frames
    were all kept, in a seeded order."""
    rng = np.random.default_rng([seed, 5])
    by_class: dict = {}
    for b in blocks:
        if all(j in kept for j in b.outputs):
            by_class.setdefault(window_class(b), []).append(b)
    out = []
    for cls, n in SAMPLE.items():
        cand = by_class.get(cls, [])
        out += [cand[i] for i in sorted(rng.permutation(len(cand))[:n])]
    return sorted(out, key=lambda b: b.first_output)


class Frames:
    """Source frames as the reference's f32 network inputs, made once each."""

    def __init__(self, reel, size, device, dtype=torch.float32):
        self.reel, self.size, self.device, self.dtype = reel, size, device, dtype
        self._cache: dict = {}

    def __call__(self, j: int) -> torch.Tensor:
        if j not in self._cache:
            self._cache[j] = scene.to_input(self.reel.frame(j), self.size, self.dtype, self.device)
        return self._cache[j]


def reference_frames(ref, block: plan.Block, frames: Frames, src_size) -> list:
    """The reference's uint8 frames of ``block``."""
    with torch.no_grad():
        out = ref.block(block.kind, [frames(i) for i in block.inputs], block.ts, block.left_cut,
                        block.right_cut, block.chain_start)
    return [scene.to_output(x, src_size) for x in out]


def block_frames(ref, blocks, reel, size, src_size, device, dtype=torch.float32):
    """[(class, output index, uint8 frame)] of ``blocks`` by ``ref`` on the
    source frames taken in ``dtype``."""
    frames = Frames(reel, size, device, dtype)
    return [(window_class(b), j, r) for b in blocks
            for j, r in zip(b.outputs, reference_frames(ref, b, frames, src_size))]


def in_bf16(cfg: dict, params: dict):
    """The reference on ``params`` cast to bf16: the configuration's own
    precision, spelled in plain PyTorch."""
    from benchmark.reference import models

    return models.Reference(cfg, {n: {k: v.to(torch.bfloat16) for k, v in d.items()}
                                  for n, d in params.items()})


def mae(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute difference, in 8-bit levels."""
    return float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())


def bad_share(a: np.ndarray, b: np.ndarray, levels: int) -> float:
    """% of values more than ``levels`` levels apart."""
    return float((np.abs(a.astype(np.int16) - b.astype(np.int16)) > levels).mean() * 100)


def reference_cuts(reel, n: int, size, threshold: float, device) -> int:
    """Pairs among the first ``n`` frames that the reference scores as cuts."""
    prev, cuts = None, 0
    for j in range(n):
        x = scene.to_input(reel.frame(j), size, torch.float32, device)
        if prev is not None:
            cuts += scene.scene_score(prev, x) < threshold
        prev = x
    return int(cuts)


def planned_copies(b: plan.Block) -> list:
    """(output index, input index) of each frame of ``b`` that the plan
    makes a copy of a source frame (``models.Reference.block``'s branches)."""
    ts = b.ts
    if b.kind == "head":
        src, mask = b.inputs[0], np.ones(len(ts), bool) if b.left_cut else ts < 1
    elif b.kind == "tail":
        src, mask = b.inputs[1], ts > 1
    else:
        src = b.inputs[1]
        if b.left_cut and b.right_cut:
            mask = np.ones(len(ts), bool)
        elif b.left_cut:
            mask = ts < 1
        elif b.right_cut:
            mask = ts > 1
        else:
            mask = np.zeros(len(ts), bool)
    return [(j, src) for j, m in zip(b.outputs, mask) if m]


def copy_bad_px(blocks, prints: list, reel, size, src_size, levels: int, device) -> float:
    """The largest % of a planned copy's printed values more than ``levels``
    from the reference's copy of its source frame (0 with no copy written)."""
    s = stream.PRINT_STRIDE
    copies: dict = {}
    worst = 0.0
    for b in blocks:
        for j, k in planned_copies(b):
            if j >= len(prints):
                continue  # not written: frames_off_plan counts it
            if k not in copies:
                x = scene.to_input(reel.frame(k), size, torch.float32, device)
                copies[k] = scene.to_output(x, src_size)[::s, ::s]
            worst = max(worst, bad_share(prints[j], copies[k], levels))
    return worst
