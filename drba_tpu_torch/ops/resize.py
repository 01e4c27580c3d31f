"""Bilinear resize of NHWC tensors with ``F.interpolate`` semantics.

Counterpart of drba_tpu/ops/resize.py, which reproduces these coordinate
rules with separable gathers: ``align_corners=False`` maps output ``i`` to
``(i + 0.5) * in/out - 0.5`` clamped at 0, ``align_corners=True`` to
``i * (in - 1)/(out - 1)``. PyTorch computes the same taps in one 2-D pass,
so the two agree to rounding (bit-for-bit for integer factors in f32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize an NHWC (or HWC) tensor to (H, W) = ``size``."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-3:-1]) == size:
        return x
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=align_corners)
    y = y.permute(0, 2, 3, 1)
    return y[0] if squeeze else y


def resize_to(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """align_corners=False resize (reference ``resize``)."""
    return resize_bilinear(x, size, align_corners=False)


def scale_by(x: torch.Tensor, factor: float, align_corners: bool = False) -> torch.Tensor:
    """Resize by ``factor`` with PyTorch's floor rule for the output size."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, (int(h * factor), int(w * factor)), align_corners)
