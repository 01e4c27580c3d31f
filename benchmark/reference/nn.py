"""Plain PyTorch primitives of the frozen reference, NHWC at every function.

A frozen copy of the plain (CPU) paths of the program at the time this
benchmark was written: layers, bilinear resize, pixel shuffle, the exact
backward warp (a gather of four corners) and the exact softsplat (an f32
``index_add_`` scatter). It imports nothing of the program. Weights are flat
dicts keyed by the reference checkpoints' state-dict names, in PyTorch's
layouts (conv OIHW, transposed conv (in, out, kh, kw)) except linear weights,
stored (in, out).

Every product (convolution, matrix product) takes its operands through
:func:`q`, which returns them unchanged unless a block runs under
``products("fp8")``: then each operand is rounded to float8 e4m3 with one
scale per tensor (amax / 448), as an fp8 product would consume it. That is
the benchmark's control, the step below the configurations' bf16.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Mapping

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]

_PRODUCTS = contextvars.ContextVar("reference_products", default="f32")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def products(kind: str):
    """Run the block's products in ``kind``: "f32" (as given) or "fp8"."""
    if kind not in ("f32", "fp8"):
        raise ValueError(f"products: {kind!r}; valid: f32, fp8")
    token = _PRODUCTS.set(kind)
    try:
        yield
    finally:
        _PRODUCTS.reset(token)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale per tensor, in x's dtype."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-30) / FP8_MAX
    return ((xf / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def q(x: torch.Tensor) -> torch.Tensor:
    """A product's operand in the products' precision (see the module docstring)."""
    return fp8_round(x) if _PRODUCTS.get() == "fp8" else x


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(q(a), q(b))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, q(a), q(b))


# ------------------------------------------------------------------------------------- layers


def conv2d(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    w = p[f"{name}.weight"].to(x.dtype)
    b = p.get(f"{name}.bias")
    y = F.conv2d(q(x).permute(0, 3, 1, 2), q(w), None if b is None else b.to(x.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(p: Params, name: str, x: torch.Tensor, stride: int = 2,
                     padding: int = 1) -> torch.Tensor:
    w = p[f"{name}.weight"].to(x.dtype)
    b = p.get(f"{name}.bias")
    y = F.conv_transpose2d(q(x).permute(0, 3, 1, 2), q(w), None if b is None else b.to(x.dtype),
                           stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ W (+ b)``, W stored (in, out), accumulated in f32 and cast back."""
    out = matmul(x.float(), p[f"{name}.weight"].to(x.dtype).float()).to(x.dtype)
    b = p.get(f"{name}.bias")
    return out if b is None else out + b.to(out.dtype)


def layer_norm(p: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p[f"{name}.weight"].float() + p[f"{name}.bias"].float()).to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 2), keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def prelu(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    a = p[f"{name}.weight"].to(x.dtype).reshape(())
    return torch.where(x >= 0, x, x * a)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, ``0.5 x erfc(-x / sqrt(2))``, its erfc in f32."""
    arg = -x * torch.tensor(math.sqrt(0.5), dtype=torch.float32).to(x.dtype)
    return (0.5 * x) * torch.special.erfc(arg.float()).to(x.dtype)


# ----------------------------------------------------------------------------- resize, shuffle


def resize(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to (H, W) = ``size`` (``F.interpolate``)."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[1:3]) == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def scale_by(x: torch.Tensor, factor: float) -> torch.Tensor:
    return resize(x, (int(x.shape[1] * factor), int(x.shape[2] * factor)))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    n, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c)


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 zero-padded patches of NHWC ``x`` -> (N, H, W, C, 9), taps (ky, kx)."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)],
                       dim=-1)


def flow_distance(flow: torch.Tensor) -> torch.Tensor:
    u, v = flow[..., 0:1].float(), flow[..., 1:2].float()
    return torch.sqrt(u * u + v * v).to(flow.dtype)


# ----------------------------------------------------------------------------- backward warp

# each warp call's (n, h, w, c, k, itemsize), where a recorder is installed
_WARPS = contextvars.ContextVar("reference_warps", default=None)
_SPLATS = contextvars.ContextVar("reference_splats", default=None)


@contextlib.contextmanager
def recording():
    """Record the shapes of every warp and softsplat call in the block:
    yields (warps, splats), lists of dicts (``work.py`` turns them into
    bytes)."""
    warps, splats = [], []
    t1, t2 = _WARPS.set(warps), _SPLATS.set(splats)
    try:
        yield warps, splats
    finally:
        _WARPS.reset(t1)
        _SPLATS.reset(t2)


def _sample(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor, zeros: bool) -> torch.Tensor:
    """Bilinear sample of img (N, H, W, C) at pixel coordinates (N, Ho, Wo),
    corners summed in f32 in the order (0,0), (0,1), (1,0), (1,1); border
    clamping, or zero weight outside the frame."""
    n, h, w, c = img.shape
    px, py = px.float(), py.float()
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    x0i = x0.clamp(-2, w + 1).long()
    y0i = y0.clamp(-2, h + 1).long()
    flat = img.reshape(n, h * w, c)
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            ix, iy = x0i + dx, y0i + dy
            wgt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            if zeros:
                valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, -1, 1)
            v = torch.gather(flat, 1, idx.expand(-1, -1, c)).float()
            v = v.reshape(*px.shape, c) * wgt[..., None]
            out = v if out is None else out + v
    return out.to(img.dtype)


def _positions(flow: torch.Tensor, k: int = 1):
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


def _record_warp(img: torch.Tensor, k: int) -> None:
    rec = _WARPS.get()
    if rec is not None:
        n, h, w, c = img.shape
        rec.append({"n": n, "h": h, "w": w, "c": c, "k": k, "itemsize": img.element_size()})


def backwarp(img: torch.Tensor, flow: torch.Tensor, zeros: bool = False) -> torch.Tensor:
    """``out[y, x] = img[y + v, x + u]`` bilinearly (flow (N, H, W, 2) in pixels)."""
    _record_warp(img, 1)
    return _sample(img, *_positions(flow), zeros)


def warp_downsample(img: torch.Tensor, flow: torch.Tensor, k: int) -> torch.Tensor:
    """``downsample_k(backwarp(img, flow))`` for an even k: the warp at the
    2x2 taps of each k x k cell, averaged."""
    _record_warp(img, k)
    n, h, w, c = img.shape
    taps = _sample(img, *_positions(flow, k), False)
    return taps.reshape(n, h // k, 2, w // k, 2, c).float().mean(dim=(2, 4)).to(img.dtype)


def backwarp2(a: torch.Tensor, b: torch.Tensor, flow4: torch.Tensor, k: int = 1) -> torch.Tensor:
    """``a`` by ``flow4[..., :2]`` and ``b`` by ``flow4[..., 2:]``, stacked."""
    if k == 1:
        halves = [backwarp(a, flow4[..., 0:2]), backwarp(b, flow4[..., 2:4])]
    else:
        halves = [warp_downsample(a, flow4[..., 0:2], k), warp_downsample(b, flow4[..., 2:4], k)]
    return torch.cat(halves, dim=0)


# --------------------------------------------------------------------------------- softsplat

_EPS = 1e-7


def _splat_sum(ten: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """f32 bilinear scatter-add of ten (N, H, W, C) along flow (N, H, W, 2);
    out-of-frame corners and non-finite targets are dropped."""
    n, h, w, c = ten.shape
    gx = torch.arange(w, dtype=torch.float32, device=ten.device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=ten.device)[None, :, None]
    fx = gx + flow[..., 0].float()
    fy = gy + flow[..., 1].float()
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    fx = torch.where(finite, fx, torch.full_like(fx, -2.0))
    fy = torch.where(finite, fy, torch.full_like(fy, -2.0))
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    x0i = x0.clamp(-2, w + 1).long()
    y0i = y0.clamp(-2, h + 1).long()
    batch_off = (torch.arange(n, device=ten.device) * (h * w))[:, None, None]
    src = ten.float()
    out = torch.zeros((n * h * w, c), dtype=torch.float32, device=ten.device)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ix, iy = x0i + dx, y0i + dy
        wgt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
        valid = finite & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = torch.where(valid, iy * w + ix + batch_off, 0).reshape(-1)
        val = torch.where(valid[..., None], src * wgt[..., None], 0.0)
        out.index_add_(0, idx, val.reshape(-1, c))
    return out.reshape(n, h, w, c)


def softsplat(ten: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor | None, mode: str,
              coverage: bool = False):
    """Forward-splat ``ten`` along ``flow``, normalised: 'avg' scatters
    [ten, 1], 'soft' [ten * exp(metric), exp(metric)]; the sums are divided
    by the weight channel + 1e-7. With ``coverage`` also the normalised
    weight channel."""
    rec = _SPLATS.get()
    if rec is not None:
        n, h, w, c = ten.shape
        rec.append({"n": n, "h": h, "w": w, "c": c, "itemsize": ten.element_size(),
                    "flow_itemsize": flow.element_size(),
                    "metric_itemsize": 0 if metric is None else metric.element_size(),
                    "coverage": coverage})
    c = ten.shape[-1]
    if mode == "avg":
        factor = torch.ones_like(ten[..., :1], dtype=torch.float32)
    elif mode == "soft":
        factor = torch.exp(metric.float())
    else:
        raise ValueError(f"softsplat mode {mode!r}: avg or soft")
    acc = _splat_sum(torch.cat([ten.float() * factor, factor], dim=-1), flow)
    raw = acc[..., c:c + 1]
    norm = raw + _EPS
    out = (acc[..., :c] / norm).to(ten.dtype)
    if coverage:
        return out, (raw / norm).to(ten.dtype)
    return out
