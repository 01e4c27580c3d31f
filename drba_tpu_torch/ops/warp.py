"""Backward warping (counterpart of drba_tpu/ops/warp.py).

Sampling positions are computed in pixels, ``pixel + flow``, as the JAX code
does, not through ``grid_sample``'s normalised coordinates (which round
differently). Bilinear corners are summed in f32 in the order (0,0), (0,1),
(1,0), (1,1); 'border' clamps corner indices, 'zeros' zeroes the weights of
out-of-frame corners.

``backwarp``, ``warp_downsample`` and ``backwarp2`` dispatch between the
plain PyTorch version here and the hand-written kernel (ops/warp_cuda.py) by
``backend`` (``auto | torch | cuda``, see drba_tpu_torch/config.py).
"""

from __future__ import annotations

import torch

from drba_tpu_torch._build import use_kernel
from drba_tpu_torch.ops.planes import dense


def _sample_pixels(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                   padding_mode: str) -> torch.Tensor:
    """Bilinear sample of img (N,H,W,C) at pixel coords px/py (N,Ho,Wo)."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"padding_mode must be 'border' or 'zeros', got {padding_mode!r}")
    n, h, w, c = img.shape
    px = px.float()
    py = py.float()
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    # clamp before the int conversion: beyond one pixel outside the frame
    # both padding modes give the same result as the unclamped index
    x0i = x0.clamp(-2, w + 1).long()
    y0i = y0.clamp(-2, h + 1).long()
    flat = img.reshape(n, h * w, c)
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            ix = x0i + dx
            iy = y0i + dy
            wgt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            if padding_mode == "zeros":
                valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, -1, 1)
            v = torch.gather(flat, 1, idx.expand(-1, -1, c)).float()
            v = v.reshape(*px.shape, c) * wgt[..., None]
            out = v if out is None else out + v
    return out.to(img.dtype)


def sample_positions(flow: torch.Tensor, k: int = 1):
    """Pixel coordinates (px, py), f32 (N, Ho, Wo), at which a warp by
    ``flow`` (N, H, W, 2) samples: every pixel for k == 1; for an even k the
    2x2 taps ``{k*i + k/2 - 1, k*i + k/2}`` per axis of each k x k cell,
    with the flow read at the taps."""
    _, h, w, _ = flow.shape
    ty = torch.arange(h, device=flow.device)
    tx = torch.arange(w, device=flow.device)
    if k > 1:
        ty = ty.reshape(h // k, k)[:, k // 2 - 1:k // 2 + 1].reshape(-1)
        tx = tx.reshape(w // k, k)[:, k // 2 - 1:k // 2 + 1].reshape(-1)
        flow = flow[:, ty][:, :, tx]
    px = tx.float()[None, None, :] + flow[..., 0].float()
    py = ty.float()[None, :, None] + flow[..., 1].float()
    return px, py


def backwarp(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border",
             backend: str = "auto") -> torch.Tensor:
    """Backward-warp ``img`` by ``flow`` (both NHWC; flow (N,H,W,2) in pixels).

    ``out[y, x] = img[y + flow_v, x + flow_u]`` bilinearly sampled.
    """
    if use_kernel(backend, img):
        from drba_tpu_torch.ops.warp_cuda import warp_cuda

        return warp_cuda(img.contiguous(), flow.contiguous(), 1, padding_mode)
    return _sample_pixels(img, *sample_positions(flow), padding_mode)


def warp_downsample(img: torch.Tensor, flow: torch.Tensor, k: int,
                    padding_mode: str = "border", backend: str = "auto") -> torch.Tensor:
    """Exactly ``downsample_k(backwarp(img, flow))`` for an even ``k``.

    The align_corners=False bilinear downsample by an even integer ``k``
    averages the 2x2 pixels ``{k*i + k/2 - 1, k*i + k/2}`` per axis, so the
    warp is evaluated only at that tap grid (k^2/4 fewer samples) with the
    flow read at the taps (drba_tpu/models/ifnet.py:_warp_then_downsample).
    Taps are rounded to ``img.dtype`` before the f32 average, as in JAX.
    """
    n, h, w, c = img.shape
    if k < 2 or k % 2 or h % k or w % k:
        raise ValueError(f"warp_downsample needs an even k dividing H and W, got k={k} "
                         f"for {h}x{w}")
    if use_kernel(backend, img):
        from drba_tpu_torch.ops.warp_cuda import warp_cuda

        return warp_cuda(img.contiguous(), flow.contiguous(), k, padding_mode)
    taps = _sample_pixels(img, *sample_positions(flow, k), padding_mode)
    v = taps.reshape(n, h // k, 2, w // k, 2, c).float()
    return v.mean(dim=(2, 4)).to(img.dtype)


def backwarp2(a, b, flow4: torch.Tensor, k: int = 1, padding_mode: str = "border",
              backend: str = "auto", out: torch.Tensor | None = None,
              offsets: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Both directions of IFNet's warp in one call: ``a`` by ``flow4[..., 0:2]``
    and ``b`` by ``flow4[..., 2:4]`` (``backwarp`` for k == 1, else
    ``warp_downsample`` by k), stacked as (2N, H/k, W/k, C), ``a``'s first;
    with ``out`` (N, H/k, W/k, C'), written into its channels ``offsets[0]``
    and ``offsets[1]`` onwards instead (an IFBlock's input), and ``out``
    returned.

    ``a`` and ``b`` are operands (ops/planes.py) or tuples of operands side by
    side in channels (a frame's 3 channels and its features). The kernel
    reads them and the (N, H, W, 4) flow where they lie, in one launch,
    without concatenating them (the JAX package stacks the two directions
    into one launch: drba_tpu/models/ifnet.py:163-176).
    """
    if use_kernel(backend, flow4):
        from drba_tpu_torch.ops.warp_cuda import warp_cuda

        return warp_cuda(a, flow4.contiguous(), k, padding_mode, img1=b, out=out,
                         offsets=offsets)
    imgs = [torch.cat([dense(x) for x in img], dim=-1) if isinstance(img, (tuple, list))
            else dense(img) for img in (a, b)]
    if k == 1:
        halves = [backwarp(img, f, padding_mode, "torch")
                  for img, f in zip(imgs, (flow4[..., 0:2], flow4[..., 2:4]))]
    else:
        halves = [warp_downsample(img, f, k, padding_mode, "torch")
                  for img, f in zip(imgs, (flow4[..., 0:2], flow4[..., 2:4]))]
    if out is None:
        return torch.cat(halves, dim=0)
    for half, off in zip(halves, offsets):
        out[..., off:off + half.shape[-1]] = half
    return out
