"""An IFBlock's input written once (csrc/block_input.cu).

``assemble(out, parts, first=0)`` writes the channels ``first`` onwards of
``out`` (N, ho, wo, C), the block's input at its working resolution (the
warps write the channels below, at an even scale): each part's operand
(ops/planes.py: read where it lies, in ``out``'s dtype or f32) converted to
``out``'s dtype, resized to (ho, wo) with ``F.interpolate``'s
align_corners=False bilinear from the IFNet's full resolution (placed as it
is where it already lies at (ho, wo)) and multiplied by the part's factor,
side by side, then zeros up to C (the channels the first conv's zero
weights read; ``models/ifnet.py`` pads them to a multiple of 8).

The plain version is the eager expression (``resize_bilinear`` of each
operand, then a slice assignment); the wrapper launches the kernel for CUDA
tensors or raises (``backend``: ``auto | torch | cuda``, as
``_build.use_kernel`` resolves it). The kernel replaces no TPU kernel: on
the TPU, XLA fused IFNet's concatenations into the first conv.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from drba_tpu_torch._build import BLOCK_INPUT, check_cuda_input, dtype_code, stream_of, use_kernel
from drba_tpu_torch.ops.planes import Src, dense, src
from drba_tpu_torch.ops.resize import resize_bilinear

MAX_PARTS = 8   # csrc/block_input.cu:kMaxSrc
MAX_CHANNELS = 64  # csrc/block_input.cu:kMaxC


class AssembleArgs(ctypes.Structure):
    """csrc/block_input.cu:AssembleArgs, field for field."""

    _fields_ = [("src", Src * MAX_PARTS), ("at_out", ctypes.c_ubyte * MAX_PARTS),
                ("src_of", ctypes.c_byte * MAX_CHANNELS),
                ("ch_of", ctypes.c_ubyte * MAX_CHANNELS), ("out", ctypes.c_void_p),
                *[(f, ctypes.c_int) for f in ("n", "h", "w", "ho", "wo", "cout", "first")],
                ("sh", ctypes.c_float), ("sw", ctypes.c_float)]


def _assemble_plain(out: torch.Tensor, parts, first: int) -> torch.Tensor:
    size = tuple(out.shape[1:3])
    c = first
    for x, mult in parts:
        v = resize_bilinear(dense(x).to(out.dtype), size)
        if mult != 1.0:
            v = v * mult
        out[..., c:c + v.shape[-1]] = v
        c += v.shape[-1]
    out[..., c:] = 0
    return out


def assemble(out: torch.Tensor, parts, backend: str = "auto", first: int = 0) -> torch.Tensor:
    """Write ``parts``, a sequence of (operand, factor), side by side into
    the channels ``first`` onwards of ``out`` (N, ho, wo, C), each resized
    from the IFNet's full resolution (H, W), the same for every part, or
    placed as it is where it lies at (ho, wo), and multiplied by its factor;
    zeros in the channels left; returns ``out``. Channels below ``first``
    are left as they are (the warps write them)."""
    shapes = [tuple(x.shape) for x, _ in parts]
    n, ho, wo, cout = out.shape
    full = {s[1:3] for s in shapes} - {(ho, wo)}
    if (len(full) > 1 or any(s[0] != n for s in shapes)
            or first + sum(s[-1] for s in shapes) > cout):
        raise ValueError(f"parts {shapes} do not fit out {tuple(out.shape)} from channel "
                         f"{first}")
    if not use_kernel(backend, out):
        return _assemble_plain(out, parts, first)
    check_cuda_input("out", out, ndim=4)
    if len(parts) > MAX_PARTS or cout > MAX_CHANNELS or n * ho * wo * cout >= 2 ** 31:
        raise ValueError(f"the kernel takes at most {MAX_PARTS} parts, {MAX_CHANNELS} channels "
                         f"and 2^31 elements, got {len(parts)} into {tuple(out.shape)}")
    h, w = full.pop() if full else (ho, wo)
    a = AssembleArgs()
    j = 0
    for i, (x, mult) in enumerate(parts):
        a.src[i] = src(x, out.device, mult)
        a.at_out[i] = shapes[i][1:3] == (ho, wo)
        for ch in range(shapes[i][-1]):
            a.src_of[j], a.ch_of[j] = i, ch
            j += 1
    for jj in range(j, cout - first):
        a.src_of[jj] = -1
    a.out = out.data_ptr()
    a.n, a.h, a.w, a.ho, a.wo, a.cout, a.first = n, h, w, ho, wo, cout, first
    # F.interpolate's scales: in / out in f32
    a.sh, a.sw = float(np.float32(h) / np.float32(ho)), float(np.float32(w) / np.float32(wo))
    BLOCK_INPUT.launch(ctypes.byref(a), dtype_code(out), stream_of(out), device=out.device)
    return out
