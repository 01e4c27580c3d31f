"""Frame conversion, the window timesteps and the scene score, plain
PyTorch and numpy (frozen reference; DRBA ``infer.py`` and
``models/utils/tools.py``).

* :func:`to_input` / :func:`to_output`: a decoded uint8 frame to the
  network's padded float frame and back (bilinear resize both ways; the
  output truncates ``x * 255`` to uint8);
* :func:`window_ts`: a window's timesteps in [0.5, 1.5) around I1, from the
  destination grid (``TMapper``);
* :func:`scene_score`: the volumetric SSIM (an 11x11x11 Gaussian, sigma 1.5,
  replicate padding) of two frames resized to 32x32; a pair below the
  threshold is a cut.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.nn import resize


def net_size(h: int, w: int, scale: float, div: int) -> tuple:
    """The padded (H, W) the network runs at: each side the smallest size
    whose scaled extent is a multiple of ``div``."""
    def dim(d):
        s = d * scale
        return d if s % div == 0 else int((s // div + 1) * div / scale)

    return dim(h), dim(w)


def to_input(img: np.ndarray, size, dtype=torch.float32, device="cpu") -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device).to(dtype)[None] / 255.0
    return resize(x, size)


def to_output(x: torch.Tensor, size) -> np.ndarray:
    """(1, H, W, 3) in [0, 1] -> HWC uint8 at ``size``."""
    y = resize(x.float(), size)
    return (y[0] * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()


def window_ts(idx: int, src_fps: float, dst_fps: float) -> np.ndarray:
    """Timesteps of window ``idx`` (the destination grid points in
    [idx - 0.5, idx + 0.5), as offsets from idx, rounded to 4 places, + 1)."""
    times = dst_fps / src_fps
    lo = math.ceil((idx - 0.5) * times)
    hi = math.ceil((idx + 0.5) * times)
    ts = np.arange(lo, hi, dtype=np.float64) / times if lo < hi else np.zeros(0)
    return np.round(ts - idx, 4) + 1


def _gauss1d(n: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(n, dtype=torch.float64) - n // 2
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    return (g / g.sum()).float()


def ssim_volume(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MATLAB-style SSIM of two (1, H, W, C) images taken as C x H x W
    volumes, range detected as the reference does (1 for [0, 1] images)."""
    a = x.float().permute(0, 3, 1, 2)[:, None]
    b = y.float().permute(0, 3, 1, 2)[:, None]
    L = (255.0 if float(a.max()) > 128 else 1.0) - (-1.0 if float(a.min()) < -0.5 else 0.0)
    g = _gauss1d().to(a.device)
    k3 = (g[:, None, None] * g[None, :, None] * g[None, None, :])[None, None]

    def filt(t):
        return F.conv3d(F.pad(t, (5,) * 6, mode="replicate"), k3)

    mu1, mu2 = filt(a), filt(b)
    s11 = filt(a * a) - mu1 * mu1
    s22 = filt(b * b) - mu2 * mu2
    s12 = filt(a * b) - mu1 * mu2
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def scene_score(x: torch.Tensor, y: torch.Tensor) -> float:
    return float(ssim_volume(resize(x.float(), (32, 32)), resize(y.float(), (32, 32))))
