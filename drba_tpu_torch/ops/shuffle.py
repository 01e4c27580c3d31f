"""NHWC pixel shuffle and transposed conv (counterpart of drba_tpu/ops/shuffle.py).

The port runs IFNet's lastconv in the reference form, ConvTranspose2d(4, s2)
followed by PixelShuffle(2); the TPU-only weight fold
(``fold_convT4s2_shuffle``) is not needed on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_shuffle(x: torch.Tensor, r: int, channels: int | None = None) -> torch.Tensor:
    """``nn.PixelShuffle`` in NHWC: out[n, h*r+i, w*r+j, c] = in[n, h, w, c*r*r + i*r + j];
    with ``channels``, only the first that many output channels."""
    n, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r)[:, :, :, :channels]
    c = x.shape[3]
    return x.permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r, c)  # N, H, i, W, j, C


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                     stride: int = 2, padding: int = 1) -> torch.Tensor:
    """``nn.ConvTranspose2d`` on NHWC; ``weight`` in PyTorch's (in, out, kh, kw) layout."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                           None if bias is None else bias.to(x.dtype),
                           stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """``F.unfold(x, 3, padding=1)`` in NHWC, returned as (N, H, W, C, 9) with
    the patch taps in (ky, kx) order on the last axis."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)],
                       dim=-1)


def fold_conv_after_shuffle(w: torch.Tensor, b: torch.Tensor | None, r: int):
    """Commute a same-padded odd-k conv through a preceding pixel shuffle.

    ``conv2d(pixel_shuffle(x, r), w, padding=k//2)`` equals
    ``pixel_shuffle(conv2d(x, w_lo, padding=1) + b_lo, r)`` (the polyphase
    identity of drba_tpu/ops/shuffle.py:fold_conv_after_shuffle): each output
    phase (py, px) reads a k x k full-resolution window that lies inside a
    3 x 3 low-resolution window, so the kernel is embedded in a (3r, 3r)
    canvas at offset (py + r - k//2, px + r - k//2) and regrouped with the
    shuffle's c-major channel order.

    w: (cout, cin, k, k) PyTorch layout, k odd and <= 2r + 1. Returns
    w_lo (cout*r*r, cin*r*r, 3, 3) and b_lo (cout*r*r,) or None. The conv
    then runs on 1/r^2 of the pixels.
    """
    cout, cin, k, _ = w.shape
    if k % 2 != 1 or k > 2 * r + 1:
        raise ValueError(f"fold_conv_after_shuffle: k={k} needs odd k <= {2 * r + 1}")
    hwio = w.permute(2, 3, 1, 0)  # (k, k, cin, cout)
    lo = torch.zeros((3, 3, cin * r * r, cout * r * r), dtype=w.dtype, device=w.device)
    for py in range(r):
        for px in range(r):
            oy, ox = py + r - k // 2, px + r - k // 2
            cv = F.pad(hwio, (0, 0, 0, 0, ox, 3 * r - ox - k, oy, 3 * r - oy - k))
            cv = cv.reshape(3, r, 3, r, cin, cout).permute(0, 2, 4, 1, 3, 5)
            lo[:, :, :, py * r + px::r * r] = cv.reshape(3, 3, cin * r * r, cout)
    b_lo = None if b is None else b.repeat_interleave(r * r)
    return lo.permute(3, 2, 0, 1).contiguous(), b_lo
