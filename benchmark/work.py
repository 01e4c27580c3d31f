"""The yardstick's arithmetic: what a call's kernels must move and compute,
and the least time an H100 could take for it.

Bytes and operations follow the program's ``bounds.py`` at the time this
benchmark was written, copied here so that a later change to the program
cannot move the yardstick: each input read once, each output written once,
intermediates not at all; the larger of bytes over the memory rate and
operations over their unit's peak. Peaks: NVIDIA's H100 SXM data sheet,
dense, at the full 700 W power limit (a card set lower runs slower, so the
result line carries the card's limit beside every share).

:func:`call_work` runs one of the program's calls on the frozen reference
on the ``meta`` device (shapes only, nothing computed) and returns its
model FLOPs (``torch.utils.flop_counter``) and the bytes of its softsplat
and backward-warp calls, at the program's precision.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils.flop_counter import FlopCounterMode

MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32x3": 494.7e12 / 3, "f32": 67e12}
PEAK_BF16_FLOPS = PEAK_OPS_PER_S["bf16"]


@dataclass(frozen=True)
class Work:
    bytes: float = 0.0
    ops: dict = field(default_factory=dict)

    def __add__(self, other: "Work") -> "Work":
        ops = dict(self.ops)
        for k, n in other.ops.items():
            ops[k] = ops.get(k, 0.0) + n
        return Work(self.bytes + other.bytes, ops)


def bound_s(w: Work) -> float:
    """The least seconds: bytes over the memory rate or operations over
    their peak, whichever is longer."""
    t_ops = max((n / PEAK_OPS_PER_S[k] for k, n in w.ops.items()), default=0.0)
    return max(w.bytes / MEM_BYTES_PER_S, t_ops)


def splat_work(n, h, w, c, itemsize, flow_itemsize, metric_itemsize=0, coverage=False) -> Work:
    """One softsplat: values, flow and metric read once, the result (and the
    coverage) written once in the values' type; 4 corners x (c + 1) f32
    multiply-adds per source pixel. The f32 accumulator is not counted."""
    pixels = n * h * w
    read = c * itemsize + 2 * flow_itemsize + metric_itemsize
    written = (c + (1 if coverage else 0)) * itemsize
    return Work(pixels * (read + written), {"f32": 2.0 * 4 * (c + 1) * pixels})


def warp_work(n, h, w, c, k, itemsize) -> Work:
    """A bilinear backward warp of (n, h, w, c) by a flow of the same type:
    k = 1 samples every pixel, an even k the 2x2 taps of each k x k cell;
    every image pixel read once (or 4 per sample if fewer), the flow at the
    samples, the output written; 4 corners x c f32 multiply-adds a sample."""
    samples = n * h * w if k == 1 else 4 * n * (h // k) * (w // k)
    touched = min(n * h * w, 4 * samples)
    out = n * (h // k) * (w // k) * c * itemsize
    return Work(touched * c * itemsize + samples * 2 * itemsize + out,
                {"f32": 2.0 * 4 * c * samples})


@dataclass(frozen=True)
class CallWork:
    flops: float
    splat: Work
    warp: Work
    splats: int
    warps: int


def _meta_params(specs: dict, dtype) -> dict:
    from benchmark.reference.weights import _shape

    return {net: {k: torch.empty(_shape(d), device="meta", dtype=dtype) for k, d in s.items()}
            for net, s in specs.items()}


def call_work(cfg: dict, kind: str, T: int, size, dtype=torch.bfloat16) -> CallWork:
    """The work of one program call of ``kind`` with T timesteps on (H, W) =
    ``size`` frames, counted on the frozen reference in ``dtype``:

    * ``window``: a chained DRM window: the (I1, I2) pass, its features of
      I1 given, and the window;
    * ``window_start``: a chain start: the (I1, I0) pass first;
    * ``plain``: plain interpolation (GMFSS_UNION on a given reuse);
    * ``plain_pass``: GMFSS_UNION's plain interpolation with its (I0, I1) pass.
    """
    from benchmark.reference import models
    from benchmark.reference.nn import recording

    ref = models.Reference(cfg, _meta_params(models.specs(cfg["model_type"]), dtype))
    frames = [torch.empty((1, *size, 3), device="meta", dtype=dtype) for _ in range(3)]
    I0, I1, I2 = frames
    ts = torch.empty(T, device="meta", dtype=torch.float32)
    if kind not in ("window", "window_start", "plain", "plain_pass"):
        raise ValueError(f"call kind {kind!r}")
    # what a call is given (the chain's reuse, the union's plain reuse) is
    # made outside the count
    reuse01 = ref.flow_pass(I0, I1) if ref.union and kind == "plain" else None
    reuse10 = ref.chain_reuse(I0, I1, chain_start=False) if kind == "window" else None
    with FlopCounterMode(display=False) as fc, recording() as (warps, splats):
        if kind.startswith("window"):
            if reuse10 is None:
                reuse10 = ref.chain_reuse(I0, I1, chain_start=True)
            pass12 = ref.flow_pass(I1, I2, reuse10.feat0 if ref.union else reuse10[2])
            ref.window(I0, I1, I2, ts, reuse10, pass12)
        else:
            ref.plain(I0, I1, ts, reuse01)
    splat = sum((splat_work(**s) for s in splats), Work())
    warp = sum((warp_work(**w) for w in warps), Work())
    return CallWork(float(fc.get_total_flops()), splat, warp, len(splats), len(warps))


def kinds(cfg: dict) -> tuple:
    return (("window", "window_start", "plain", "plain_pass") if cfg["model_type"] == "gmfss_union"
            else ("window", "window_start", "plain"))


def work_table(cfg: dict, size, ts_lengths) -> dict:
    """{(kind, T): CallWork} for every call kind at the window lengths
    ``ts_lengths`` and the plain calls' 1 .. max(T) timesteps."""
    table = {}
    for kind in kinds(cfg):
        lengths = ts_lengths if kind.startswith("window") else range(1, max(ts_lengths) + 1)
        for T in sorted(set(lengths)):
            table[(kind, T)] = call_work(cfg, kind, T, size)
    return table

