"""The least time an NVIDIA H100 could take for each kernel's work (roofline bounds).

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once, intermediates not at all) over the
memory rate, and its operations over the peak rate of their type. Where the
work depends on the data (masked attention, the pixels a warp samples), the
caller passes what this run's data needs. Rates are NVIDIA's H100 SXM data
sheet (dense, at the full 700 W power limit): 3.35 TB/s, 989 TFLOP/s in bf16
on the tensor cores, 494.7 TFLOP/s in TF32 on the tensor cores, 67 TFLOP/s
in f32 on the FMA pipes. Operations on different units may overlap, so the
operation time is the largest of the per-type times.

An f32 matrix product (attention's products, the transformer layer, the
3x3 conv) counts as ``"tf32x3"``: three TF32 tensor-core products per f32
product (each operand split into a TF32 hi and lo part, a b = ah bh + ah bl +
al bh), the least time the card takes for products that keep f32's accuracy:
3 x 2 MACs / 494.7 TFLOP/s, about 2.5x faster than the 67 TFLOP/s FMA pipes,
where one TF32 product alone would lose three decimal digits. The ``"f32"``
FMA pipes stay for the splat's and warp's arithmetic and flash's 2-wide
P v, which no matrix unit runs. Softmax exponentials, norms and other elementwise work are
not counted (their units' rates are not in the data sheet).

Every function is pure in its arguments; ``chip_smoke.py`` sums them over the
path shapes it times.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12
TF32_OPS_PER_S = 494.7e12
# "tf32x3" counts f32 operations; each costs three TF32 operations
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32x3": TF32_OPS_PER_S / 3, "f32": 67e12}
C = 128  # the attention kernels' head width


@dataclass(frozen=True)
class Work:
    """Bytes moved and operations by type ("bf16" and "tf32x3" tensor-core,
    "f32" FMA)."""

    bytes: float
    ops: dict = field(default_factory=dict)

    def __add__(self, other: "Work") -> "Work":
        ops = dict(self.ops)
        for k, n in other.ops.items():
            ops[k] = ops.get(k, 0.0) + n
        return Work(self.bytes + other.bytes, ops)


def bound_ms(w: Work) -> tuple[float, str]:
    """(least ms, "bytes" | "operations": which of the two sets it)."""
    t_mem = w.bytes / MEM_BYTES_PER_S
    t_ops = max((n / PEAK_OPS_PER_S[k] for k, n in w.ops.items()), default=0.0)
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def _mma(itemsize: int) -> str:
    """The operation type of a matrix product in ``itemsize``-byte values."""
    return "bf16" if itemsize == 2 else "tf32x3"


def live_pairs(labels) -> int:
    """Sum over windows of the (query, key) pairs with equal region ids:
    labels (windows, L) int."""
    lab = np.asarray(labels).reshape(len(labels), -1)
    total = 0
    for row in lab:
        _, n = np.unique(row, return_counts=True)
        total += int((n.astype(np.int64) ** 2).sum())
    return total


def attention_work(n_windows: int, L: int, itemsize: int, value_width: int = C,
                   pairs: int | None = None, labels: int = 0,
                   qkv_bytes: float | None = None) -> Work:
    """``softmax(q k^T / sqrt(128)) v`` over ``n_windows`` windows of L tokens.

    q, k and out are 128 wide in ``itemsize`` bytes; the value is 128 wide
    in the same type, or (``value_width`` 2, flash) f32 in and out, with
    P v on the FMA pipes. The products are tensor-core work in bf16 and
    ``"tf32x3"`` in f32. ``pairs``: live (query, key) pairs (default every
    pair); each costs 2 * 128 operations for q k^T and 2 * value_width for
    P v. ``labels``: the int32 region ids read. ``qkv_bytes`` replaces the
    q, k, v bytes where they are read from a wider map.
    """
    tokens = n_windows * L
    pairs = n_windows * L * L if pairs is None else pairs
    if value_width == C:
        v_bytes = out_bytes = tokens * C * itemsize
        ops = {_mma(itemsize): 2.0 * pairs * (C + C)}
    else:
        v_bytes = out_bytes = tokens * value_width * 4
        ops = {_mma(itemsize): 2.0 * pairs * C}
        ops["f32"] = ops.get("f32", 0.0) + 2.0 * pairs * value_width
    if qkv_bytes is None:
        qkv_bytes = 2 * tokens * C * itemsize + v_bytes
    return Work(qkv_bytes + out_bytes + 4 * labels, ops)


def layer_work(b: int, h: int, w: int, k_splits: int, itemsize: int, hidden: int = 0,
               cross: bool = False, pairs: int | None = None, labels: int = 0) -> Work:
    """One transformer layer over (b, h, w, 128): reads x (and the cross
    target), the weights (q|k|v 128 x 384, merge 128 x 128, with the FFN
    256 x hidden and hidden x 128), the norms' f32 parameters and
    ``labels`` int32 region ids; writes the output. Products: the
    projection, attention (``pairs`` live pairs), the merge and the FFN."""
    tokens = b * h * w
    L = (h // k_splits) * (w // k_splits)
    pairs = b * k_splits ** 2 * L * L if pairs is None else pairs
    weights = (C * 3 * C + C * C + (2 * C * hidden + hidden * C)) * itemsize
    norms = (2 + (2 if hidden else 0)) * C * 4
    moved = tokens * C * itemsize * (3 if cross else 2) + weights + norms
    macs = tokens * (C * 3 * C + C * C + 2 * C * hidden + hidden * C) + pairs * 2 * C
    return Work(moved + 4 * labels, {_mma(itemsize): 2.0 * macs})


def warp_work(n: int, h: int, w: int, c: int, k: int, itemsize: int,
              touched: int | None = None) -> Work:
    """Bilinear backward warp of (n, h, w, c) by an (n, h, w, 2) flow of
    the same type; k = 1 samples every pixel, an even k the 2 x 2 taps of
    each k x k cell (4 n h w / k^2 samples, flow read at the taps) and
    averages them. ``touched``: the distinct image pixels the samples read
    (default: all, or 4 per sample if fewer). 4 corners x c multiply-adds
    per sample, in f32."""
    samples = n * h * w if k == 1 else 4 * n * (h // k) * (w // k)
    touched = min(n * h * w, 4 * samples) if touched is None else touched
    out = n * (h // k) * (w // k) * c * itemsize
    return Work(touched * c * itemsize + samples * 2 * itemsize + out,
                {"f32": 2.0 * 4 * c * samples})


def warp_touched(px, py, h: int, w: int, frames=None) -> int:
    """Distinct pixels of an (n, h, w) image that bilinear samples at pixel
    coordinates px/py (n, ...) read with border clamping (numpy or torch
    arrays). ``frames``: the frame each of the n planes reads, where planes
    share frames (a batch stride of 0, a per-plane choice of two); by
    default each plane its own."""
    px, py = torch.as_tensor(px).float(), torch.as_tensor(py).float()
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    batch = (torch.arange(px.shape[0]) if frames is None else torch.as_tensor(frames))
    batch = batch.to(px.device).long().reshape(-1, *[1] * (px.dim() - 1))
    ids = [((batch * h + (y0 + dy).clamp(0, h - 1)) * w + (x0 + dx).clamp(0, w - 1)).reshape(-1)
           for dy in (0, 1) for dx in (0, 1)]
    return int(torch.unique(torch.cat(ids)).numel())


def conv3x3_work(n: int, h: int, w: int, cin: int, cout: int, itemsize: int,
                 beta: bool = True, alpha: bool = False, res: bool = False) -> Work:
    """One 3x3 / pad-1 conv step (n, h, w, cin) -> (n, h, w, cout) with bias
    and, where given, the ResConv epilogue's beta, a pre-PReLU's one slope
    and a residual tensor ``res`` that is not the step's input (an input
    residual reads nothing more), all in one type. The PReLU and the adds do
    no tensor-core work: the operations are the conv's."""
    params = (cout * cin * 9 + cout * (2 if beta else 1) + (1 if alpha else 0)) * itemsize
    moved = n * h * w * (cin + cout * (2 if res else 1)) * itemsize + params
    return Work(moved, {_mma(itemsize): 2.0 * 9 * cin * cout * n * h * w})


def splat_work(n: int, h: int, w: int, c: int, itemsize: int, flow_itemsize: int,
               metric_itemsize: int = 0, coverage: bool = False) -> Work:
    """One softsplat of (n, h, w, c) values in ``itemsize`` bytes along an
    (n, h, w, 2) flow in ``flow_itemsize``.

    Counts, once each: the values, the flow and the (n, h, w, 1) metric
    (``metric_itemsize``, 0 without one) read; the (n, h, w, c) result and,
    with ``coverage``, the (n, h, w, 1) coverage written in the values'
    type. The f32 accumulator is an intermediate and not counted.
    Operations: 4 corners x (c + 1) multiply-adds per source pixel in f32
    (the c values and the weight channel).
    """
    pixels = n * h * w
    read = c * itemsize + 2 * flow_itemsize + metric_itemsize
    written = (c + (1 if coverage else 0)) * itemsize
    return Work(pixels * (read + written), {"f32": 2.0 * 4 * (c + 1) * pixels})


def block_input_work(n: int, ho: int, wo: int, cout: int, first: int, itemsize: int,
                     parts) -> Work:
    """One IFBlock input assembly (csrc/block_input.cu): channels ``first``
    to ``cout`` of an (n, ho, wo, cout) output in ``itemsize`` bytes written
    once, and for each part ``(frames, h, w, c, part_itemsize)`` the values
    it reads, once each: ``frames`` distinct (h, w, c) frames (a frame the
    planes share is read once), each at every source pixel, or at the 2 x 2
    taps of each output pixel where fewer. The handful of f32 operations
    per value are not counted."""
    read = sum(frames * min(h * w, 4 * ho * wo) * c * isz for frames, h, w, c, isz in parts)
    return Work(read + n * ho * wo * (cout - first) * itemsize)


def block_output_work(n: int, hl: int, wl: int, c: int, ho: int, wo: int, itemsize: int,
                      flow: bool) -> Work:
    """One IFBlock output (csrc/block_output.cu) in ``itemsize`` bytes: the
    lastconv's (n, hl, wl, c) output read once (or, where the output has
    fewer pixels, the 2 x 2 taps of each), the 13 channels of the (n, ho,
    wo) output written once (flow 4, mask 1, features 8) and, with
    ``flow``, the running (n, ho, wo, 4) flow read once. The handful of f32
    operations per value are not counted."""
    read = n * min(hl * wl, 4 * ho * wo) * c * itemsize
    return Work(read + n * ho * wo * (13 + (4 if flow else 0)) * itemsize)
