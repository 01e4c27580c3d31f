"""The benchmark's own plan of a run's output: its blocks, in order.

For ``n`` input frames and the cut flags of their ``n - 1`` pairs, the
frame loop writes the head, ``n - 2`` body windows and the tail, each
``len(window_ts(i))`` frames. Each block records the inputs it reads (its
newest one dates the block's frames for latency), its cut flags and, for a
DRM window, whether it starts the reuse chain.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference.scene import window_ts


@dataclass(frozen=True)
class Block:
    kind: str  # head | window | tail
    index: int  # the timestep grid's window index
    inputs: tuple  # input frame indices, oldest first
    ts: np.ndarray
    left_cut: bool = False
    right_cut: bool = False
    chain_start: bool = False
    first_output: int = 0

    @property
    def newest(self) -> int:
        return self.inputs[-1]

    @property
    def outputs(self) -> range:
        return range(self.first_output, self.first_output + len(self.ts))


def blocks(n: int, cuts, src_fps: float, dst_fps: float, union: bool) -> list:
    """The plan for ``n`` >= 2 inputs; ``cuts[k]``: pair (k, k+1) is a cut.

    The chain: a DRM window hands its (I1, I2) pass on; a window with a cut
    left of I1 hands its plain pass on only in GMFSS_UNION (RIFE's plain
    call has none); any other block breaks the chain.
    """
    if n < 2:
        raise ValueError("a run reads at least two frames")
    out, at = [], 0

    def add(b):
        nonlocal at
        out.append(Block(**{**b.__dict__, "first_output": at}))
        at += len(b.ts)

    add(Block("head", 0, (0, 1), window_ts(0, src_fps, dst_fps), left_cut=bool(cuts[0])))
    chained = False
    for i in range(n - 2):
        ts = window_ts(i, src_fps, dst_fps)
        ls, rs = bool(cuts[i]), bool(cuts[i + 1])
        fused = not (ls or rs)
        add(Block("window", i, (i, i + 1, i + 2), ts, ls, rs, chain_start=fused and not chained))
        chained = fused or (ls and not rs and union and bool((ts >= 1).any()))
    add(Block("tail", n - 2, (n - 2, n - 1), window_ts(n - 2, src_fps, dst_fps)))
    return out


class OutputIndex:
    """Maps an output frame's index to its body window, for any run length,
    before the run's end is known: the head's frames come first, then window
    0's, 1's, ...; only the tail (the last block) is not known in advance."""

    def __init__(self, src_fps: float, dst_fps: float, windows: int = 100_000):
        lens = [len(window_ts(i, src_fps, dst_fps)) for i in range(windows)]
        self.head = len(window_ts(0, src_fps, dst_fps))
        self.starts = np.concatenate([[0], np.cumsum(lens)]) + self.head

    def window_of(self, j: int) -> int:
        """The body window output ``j`` belongs to (-1: the head)."""
        if j < self.head:
            return -1
        w = int(np.searchsorted(self.starts, j, side="right")) - 1
        if w >= len(self.starts) - 1:
            raise ValueError(f"output {j} lies beyond the indexed windows")
        return w
