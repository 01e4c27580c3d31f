"""Scene-change detection: volumetric SSIM of both frames at 32x32
(counterpart of drba_tpu/utils/scdet.py; reference tools.py:27-30).

``scene_ssim`` returns the score as a device scalar, so that a caller can
resolve it when it needs the flag (``pipeline._Prefetcher`` copies it to the
host on its own stream).
"""

from __future__ import annotations

import torch

from drba_tpu_torch.ops.resize import resize_to
from drba_tpu_torch.ops.ssim import ssim_matlab


def scene_ssim(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """SSIM of two (1, H, W, 3) frames, both resized to 32x32 in float32."""
    return ssim_matlab(resize_to(x1.float(), (32, 32)), resize_to(x2.float(), (32, 32)))


def check_scene(x1: torch.Tensor, x2: torch.Tensor, threshold: float = 0.3) -> bool:
    """Whether the pair is a scene cut (its SSIM below ``threshold``)."""
    return bool(scene_ssim(x1, x2) < threshold)
