"""Wrappers of the hand-written splat kernels (csrc/splat.cu).

Counterpart of drba_tpu/ops/splat_stencil.py. ``splat_scatter_cuda`` fills
the padded f32 accumulator that ``ops/softsplat._scatter_plain`` computes, up
to the order of the f32 atomic additions; ``splat_normalise_cuda`` computes
what ``ops/softsplat._normalise_plain`` computes from it.
"""

from __future__ import annotations

import torch

from drba_tpu_torch._build import SPLAT, check_cuda_input, dtype_code, stream_of


def acc_stride(c: int) -> int:
    """Channels a pixel of the scatter's f32 accumulator: the ``c`` values,
    the weight channel (index ``c``), zeros up to a multiple of 4, so that
    every pixel's row is 16-byte aligned for the kernel's vector atomics."""
    return (c + 4) // 4 * 4


def splat_scatter_cuda(ten: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor | None,
                       mode: int) -> torch.Tensor:
    """ten (N,H,W,C), flow (N,H,W,2), metric (N,H,W,1) or None: contiguous
    CUDA tensors, each f32 or bf16. ``mode`` 0: factor 1; 1: the metric; 2:
    exp(metric). Returns the f32 accumulator (N,H,W,acc_stride(C)): the
    splatted [ten * factor, factor, 0...]."""
    check_cuda_input("ten", ten, ndim=4)
    check_cuda_input("flow", flow, ndim=4)
    n, h, w, c = ten.shape
    if tuple(flow.shape) != (n, h, w, 2) or flow.device != ten.device:
        raise ValueError(f"flow {tuple(flow.shape)} on {flow.device} does not match "
                         f"ten {tuple(ten.shape)} on {ten.device}")
    if (metric is None) != (mode == 0):
        raise ValueError(f"splat mode {mode} {'needs' if metric is None else 'takes no'} metric")
    if metric is not None:
        check_cuda_input("metric", metric, ndim=4)
        if tuple(metric.shape) != (n, h, w, 1) or metric.device != ten.device:
            raise ValueError(f"metric {tuple(metric.shape)} on {metric.device} does not match "
                             f"ten {tuple(ten.shape)}")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"the splat kernel takes fewer than 2^31 pixels, got {n * h * w}")
    acc = torch.empty((n, h, w, acc_stride(c)), dtype=torch.float32, device=ten.device)
    SPLAT.launch(ten.data_ptr(), flow.data_ptr(), None if metric is None else metric.data_ptr(),
                 acc.data_ptr(), n, h, w, c, mode, dtype_code(ten), dtype_code(flow),
                 dtype_code(ten if metric is None else metric), stream_of(ten),
                 device=ten.device, entry="drba_splat_scatter")
    return acc


def splat_normalise_cuda(acc: torch.Tensor, c: int, denom: int, dtype: torch.dtype,
                         coverage: bool = False):
    """The accumulator of ``splat_scatter_cuda`` -> the (N,H,W,C) result in
    ``dtype`` and, with ``coverage``, the (N,H,W,1) coverage. ``denom`` 0:
    the sums as they are (no coverage); 1 addeps, 2 zeroeps, 3 clipeps."""
    check_cuda_input("acc", acc, dtypes=(torch.float32,), ndim=4)
    if acc.shape[-1] != acc_stride(c):
        raise ValueError(f"accumulator of {acc.shape[-1]} channels for C={c}")
    if coverage and denom == 0:
        raise ValueError("coverage needs a normalised mode")
    n, h, w, _ = acc.shape
    out = torch.empty((n, h, w, c), dtype=dtype, device=acc.device)
    cov = torch.empty((n, h, w, 1), dtype=dtype, device=acc.device) if coverage else None
    SPLAT.launch(acc.data_ptr(), out.data_ptr(), None if cov is None else cov.data_ptr(),
                 n * h * w, c, denom, dtype_code(out), stream_of(acc),
                 device=acc.device, entry="drba_splat_normalise")
    return (out, cov) if coverage else out
