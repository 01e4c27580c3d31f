"""MATLAB-style volumetric SSIM and the 2-D SSIM / MS-SSIM, NHWC, in PyTorch
(counterpart of drba_tpu/ops/ssim.py; reference models/pytorch_msssim).

``ssim_matlab`` treats the RGB image as a 3-D volume and filters it with an
11x11x11 Gaussian (sigma 1.5) after replicate padding of 5 on (C, H, W). The
3-D Gaussian is the outer product of a normalised 1-D one, so the filter runs
as three 1-D correlations, one per axis, by elementwise kernels and
reductions (no library convolution, so a scene score on its own stream needs
no library handle). Everything is computed in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _kernel_np(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _kernel(device: torch.device) -> torch.Tensor:
    """The 1-D Gaussian on ``device``, made once per device: a copy to a
    CUDA device from pageable memory synchronises its stream, which the
    scene score on the frame loop's prefetch stream must not do for each
    frame (the loop thread's first score makes it). Callers only read it."""
    return torch.from_numpy(_kernel_np()).to(device)


def _gauss(x: torch.Tensor, k: torch.Tensor, volume: bool) -> torch.Tensor:
    """Separable Gaussian of (N, C, H, W) with replicate padding of 5: over
    (C, H, W) for a ``volume``, else over (H, W) per channel. Each axis is a
    'valid' correlation by unfold, product and sum: elementwise kernels and
    reductions only, no library convolution."""
    pad = k.shape[0] // 2
    if volume:
        v, dims = F.pad(x[:, None], (pad,) * 6, mode="replicate"), (2, 3, 4)
    else:
        v, dims = F.pad(x, (pad,) * 4, mode="replicate"), (2, 3)
    for d in dims:
        v = (v.unfold(d, k.shape[0], 1) * k).sum(-1)
    return v[:, 0] if volume else v


def _range(x: torch.Tensor, val_range) -> torch.Tensor | float:
    """The dynamic range L: ``val_range``, or the reference's detection
    (255 if max > 128 else 1; a min below -0.5 widens it by 1)."""
    if val_range is not None:
        return float(val_range)
    max_val = torch.where(x.max() > 128.0, 255.0, 1.0)
    min_val = torch.where(x.min() < -0.5, -1.0, 0.0)
    return max_val - min_val


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.float().permute(0, 3, 1, 2)


def _ssim_terms(x, y, L, volume: bool):
    """The SSIM map and the contrast-structure map of (N, C, H, W) images;
    the five filtered maps in one batch."""
    k = _kernel(x.device)
    g = _gauss(torch.cat([x, y, x * x, y * y, x * y]), k, volume)
    mu1, mu2, ex2, ey2, exy = g.chunk(5)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = ex2 - mu1_sq
    sigma2_sq = ey2 - mu2_sq
    sigma12 = exy - mu1_mu2
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    ssim_map = ((2 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return ssim_map, v1 / v2


def ssim(img1: torch.Tensor, img2: torch.Tensor, val_range: float | None = None,
         full: bool = False):
    """Per-channel 2-D SSIM of two NHWC images (pytorch_msssim/__init__.py:29-80);
    with ``full`` also the contrast-structure term."""
    x, y = _nchw(img1), _nchw(img2)
    ssim_map, cs_map = _ssim_terms(x, y, _range(x, val_range), volume=False)
    return (ssim_map.mean(), cs_map.mean()) if full else ssim_map.mean()


def msssim(img1: torch.Tensor, img2: torch.Tensor, val_range: float | None = None,
           normalize: bool = False) -> torch.Tensor:
    """Multi-scale SSIM of two NHWC images (pytorch_msssim/__init__.py:139-165)."""
    weights = torch.tensor([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], device=img1.device)
    mssim, mcs = [], []
    x, y = img1, img2
    for _ in range(5):
        s, cs = ssim(x, y, val_range=val_range, full=True)
        mssim.append(s)
        mcs.append(cs)
        n, h, w, c = x.shape  # 2x2 average pool

        def pool(t):
            return t[:, :h // 2 * 2, :w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c).mean((2, 4))

        x, y = pool(x), pool(y)
    mssim, mcs = torch.stack(mssim), torch.stack(mcs)
    if normalize:
        mssim, mcs = (mssim + 1) / 2, (mcs + 1) / 2
    return torch.prod((mcs ** weights)[:-1]) * (mssim ** weights)[-1]


def ssim_matlab(img1: torch.Tensor, img2: torch.Tensor,
                val_range: float | None = None) -> torch.Tensor:
    """Scalar volumetric SSIM of two NHWC images (pytorch_msssim/__init__.py:83-136).

    ``val_range=None`` detects the range as the reference does; the
    pipeline's [0, 1] frames give L = 1.
    """
    x, y = _nchw(img1), _nchw(img2)
    ssim_map, _ = _ssim_terms(x, y, _range(x, val_range), volume=True)
    return ssim_map.mean()


class SSIM:
    """``pytorch_msssim.SSIM`` (__init__.py:168-191): returns DSSIM ``(1 - ssim) / 2``."""

    def __init__(self, window_size: int = 11, size_average: bool = True,
                 val_range: float | None = None):
        assert window_size == 11 and size_average, "reference defaults only"
        self.window_size = window_size
        self.size_average = size_average
        self.val_range = val_range

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return (1.0 - ssim(img1, img2, val_range=self.val_range)) / 2.0

    forward = __call__


class MSSSIM:
    """``pytorch_msssim.MSSSIM`` (__init__.py:194-203)."""

    def __init__(self, window_size: int = 11, size_average: bool = True, channel: int = 3):
        assert window_size == 11 and size_average, "reference defaults only"
        self.window_size = window_size
        self.size_average = size_average
        self.channel = channel

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return msssim(img1, img2)

    forward = __call__
