"""Wrapper of the hand-written warp kernel (csrc/warp.cu).

Counterpart of drba_tpu/ops/warp_mxu.py. The kernel samples exactly what the
plain versions in ops/warp.py compute (``backwarp`` for k == 1,
``warp_downsample`` for even k, ``backwarp2`` for both directions of a
4-channel flow); it takes every shape, with no sampling window and no shape
gate.
"""

from __future__ import annotations

import torch

from drba_tpu_torch._build import WARP, check_cuda_input, dtype_code, stream_of


def warp_cuda(img: torch.Tensor, flow: torch.Tensor, k: int = 1,
              padding_mode: str = "border", img1: torch.Tensor | None = None) -> torch.Tensor:
    """img (N,H,W,C), flow (N,H,W,2) contiguous CUDA tensors -> (N,H/k,W/k,C)
    in img's dtype.

    With ``img1`` (the same shape and dtype as ``img``) the flow is
    (N,H,W,4): ``img`` is warped by its channels 0:2 and ``img1`` by 2:4,
    read in place, in one launch; the result is (2N,H/k,W/k,C), ``img``'s
    warps first.
    """
    check_cuda_input("img", img, ndim=4)
    check_cuda_input("flow", flow, ndim=4)
    n, h, w, c = img.shape
    fc = 2 if img1 is None else 4
    if tuple(flow.shape) != (n, h, w, fc) or flow.device != img.device:
        raise ValueError(f"flow {tuple(flow.shape)} on {flow.device} does not match "
                         f"img {tuple(img.shape)} on {img.device} ({fc} flow channels)")
    if img1 is not None:
        check_cuda_input("img1", img1, dtypes=(img.dtype,), ndim=4)
        if img1.shape != img.shape or img1.device != img.device:
            raise ValueError(f"img1 {tuple(img1.shape)} on {img1.device} does not match "
                             f"img {tuple(img.shape)} on {img.device}")
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"padding_mode must be 'border' or 'zeros', got {padding_mode!r}")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"an image plane of {h}x{w}x{c} elements is beyond the kernel's "
                         "32-bit offsets")
    if k != 1 and (k < 2 or k % 2 or h % k or w % k):
        raise ValueError(f"k must be 1 or an even divisor of H and W, got k={k} for {h}x{w}")
    planes = n if img1 is None else 2 * n
    out = torch.empty((planes, h // k, w // k, c), dtype=img.dtype, device=img.device)
    WARP.launch(img.data_ptr(), None if img1 is None else img1.data_ptr(), flow.data_ptr(),
                out.data_ptr(), n, h, w, c, k, int(padding_mode == "zeros"), fc, 2,
                dtype_code(img), dtype_code(flow), stream_of(img), device=img.device)
    return out
