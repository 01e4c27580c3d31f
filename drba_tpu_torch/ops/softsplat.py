"""Softmax-splatting forward warp (counterpart of drba_tpu/ops/softsplat.py).

Every source pixel is moved to ``p = (x + u, y + v)`` and its value added to
the 4 integer neighbours of ``p`` with bilinear weights; out-of-frame corners
and non-finite targets are dropped. ``mode``:

  'sum'     raw scatter of the input;
  'avg'     scatter [in, 1], divide by the scattered ones;
  'linear'  scatter [in*metric, metric], divide by the scattered metric;
  'soft'    scatter [in*exp(metric), exp(metric)], divide likewise;

with '-addeps' (default), '-zeroeps' or '-clipeps' denominators.

``softsplat`` runs in two steps: the scatter of the planes [in * factor,
factor] into an f32 accumulator padded to ``acc_stride(C)`` channels, then
the normalise step (divide, cast, coverage). For CUDA tensors these are the
two hand-written kernels of ops/splat_cuda.py, the factor formed inside the
first; otherwise their plain versions below, ``_scatter_plain`` (the planes
and the f32 ``index_add_`` of ``_splat_plain``, which follows
``_corner_contributions`` of the JAX package exactly) and
``_normalise_plain``. Both are exact everywhere: there is no stencil radius.
"""

from __future__ import annotations

import torch

from drba_tpu_torch._build import use_kernel
from drba_tpu_torch.ops.splat_cuda import acc_stride

_EPS = 1e-7
# the scatter's factor per main mode, and the normalise step's denominator
# rule per sub mode (0: none, the sum mode)
FACTOR = {"sum": 0, "avg": 0, "linear": 1, "soft": 2}
DENOM = {None: 1, "addeps": 1, "zeroeps": 2, "clipeps": 3}


def _splat_plain(ten: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """f32 scatter-add of ten (N,H,W,C) along flow (N,H,W,2) -> (N,H,W,C) f32."""
    n, h, w, c = ten.shape
    gx = torch.arange(w, dtype=torch.float32, device=ten.device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=ten.device)[None, :, None]
    fx = gx + flow[..., 0].float()
    fy = gy + flow[..., 1].float()
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    # guard non-finite before floor (the int conversion would be undefined)
    fx = torch.where(finite, fx, torch.full_like(fx, -2.0))
    fy = torch.where(finite, fy, torch.full_like(fy, -2.0))
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = fx - x0
    wy = fy - y0
    # corners this far outside are dropped anyway; clamping keeps the
    # int conversion in range
    x0i = x0.clamp(-2, w + 1).long()
    y0i = y0.clamp(-2, h + 1).long()
    batch_off = (torch.arange(n, device=ten.device) * (h * w))[:, None, None]
    src = ten.float().reshape(n * h * w, c)
    out = torch.zeros((n * h * w, c), dtype=torch.float32, device=ten.device)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ix = x0i + dx
        iy = y0i + dy
        wgt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
        valid = finite & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        # dropped corners add an exact 0 at row 0: no boolean mask, whose
        # nonzero() would read the card back (a captured window holds none)
        idx = torch.where(valid, iy * w + ix + batch_off, 0).reshape(-1)
        val = torch.where(valid[..., None], src.reshape(n, h, w, c) * wgt[..., None], 0.0)
        out.index_add_(0, idx, val.reshape(-1, c))
    return out.reshape(n, h, w, c)


def _scatter_plain(ten: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor | None,
                   mode: int) -> torch.Tensor:
    """The scatter kernel's accumulator: the f32 planes [ten * factor,
    factor, 0...] (factor 1, metric or exp(metric) for ``mode`` 0, 1, 2)
    padded to ``acc_stride(C)`` channels, splatted."""
    n, h, w, c = ten.shape
    x = ten.float()
    planes = torch.zeros((n, h, w, acc_stride(c)), dtype=torch.float32, device=ten.device)
    if mode == 0:
        planes[..., :c] = x
        planes[..., c] = 1.0
    else:
        m = metric.float() if mode == 1 else torch.exp(metric.float())
        planes[..., :c] = x * m
        planes[..., c:c + 1] = m
    return _splat_plain(planes, flow)


def _normalise_plain(acc: torch.Tensor, c: int, denom: int, dtype: torch.dtype,
                     coverage: bool = False):
    """The normalise kernel's result from the accumulator: the sums cast to
    ``dtype`` (``denom`` 0), or divided by the weight channel under the
    addeps (1), zeroeps (2) or clipeps (3) rule, with the coverage."""
    if denom == 0:
        return acc[..., :c].to(dtype)
    raw = acc[..., c:c + 1]
    if denom == 1:
        norm = raw + _EPS
    elif denom == 2:
        norm = torch.where(raw == 0.0, torch.ones_like(raw), raw)
    else:
        norm = raw.clamp(min=_EPS)
    result = (acc[..., :c] / norm).to(dtype)
    if coverage:
        return result, (raw / norm).to(dtype)
    return result


def splat(ten: torch.Tensor, flow: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Bilinear forward splat (summation) of ten (N,H,W,C) -> f32 (N,H,W,C)
    (on the kernel, a view of the padded accumulator)."""
    if use_kernel(backend, ten):
        from drba_tpu_torch.ops.splat_cuda import splat_scatter_cuda

        acc = splat_scatter_cuda(ten.contiguous(), flow.contiguous(), None, 0)
        return acc[..., :ten.shape[-1]]
    return _splat_plain(ten, flow)


def softsplat(ten: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor | None,
              mode: str = "avg", backend: str = "auto", return_coverage: bool = False):
    """Forward-splat ``ten`` (N,H,W,C) along ``flow`` (N,H,W,2).

    ``metric`` is (N,H,W,1) for 'linear'/'soft', None otherwise.
    ``return_coverage=True`` also returns the warped all-ones mask
    ``denom / norm`` taken from the splat's own denominator.
    """
    parts = mode.split("-")
    main, sub = parts[0], (parts[1] if len(parts) > 1 else None)
    if main not in FACTOR or sub not in DENOM:
        raise ValueError(f"unknown softsplat mode {mode!r}")
    if (metric is None) != (main in ("sum", "avg")):
        raise ValueError(f"mode {mode!r} {'needs' if metric is None else 'takes no'} metric")
    if return_coverage and main == "sum":
        raise ValueError("return_coverage needs a normalised mode")

    c = ten.shape[-1]
    denom = 0 if main == "sum" else DENOM[sub]
    if use_kernel(backend, ten):
        from drba_tpu_torch.ops.splat_cuda import splat_normalise_cuda, splat_scatter_cuda

        acc = splat_scatter_cuda(ten.contiguous(), flow.contiguous(),
                                 None if metric is None else metric.contiguous(), FACTOR[main])
        return splat_normalise_cuda(acc, c, denom, ten.dtype, return_coverage)
    acc = _scatter_plain(ten, flow, metric, FACTOR[main])
    return _normalise_plain(acc, c, denom, ten.dtype, return_coverage)
