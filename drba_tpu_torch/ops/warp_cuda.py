"""Wrapper of the hand-written warp kernel (csrc/warp.cu).

Counterpart of drba_tpu/ops/warp_mxu.py. The kernel samples exactly what the
plain versions in ops/warp.py compute (``backwarp`` for k == 1,
``warp_downsample`` for even k, ``backwarp2`` for both directions of a
4-channel flow); it takes every shape, with no sampling window and no shape
gate. Each direction's image is read where it lies, as one or two operands
side by side in its channels (ops/planes.py), and each direction's result
can be written into channel slots of a wider buffer (an IFBlock's input).
"""

from __future__ import annotations

import ctypes

import torch

from drba_tpu_torch._build import WARP, check_cuda_input, dtype_code, stream_of
from drba_tpu_torch.ops.planes import Operand, Pick, Src, src


class WarpArgs(ctypes.Structure):
    """csrc/warp.cu:WarpArgs, field for field."""

    _fields_ = [("img", Src * 4), ("flow", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("ob", ctypes.c_longlong), ("off", ctypes.c_longlong * 2),
                *[(f, ctypes.c_int) for f in ("n", "h", "w", "c", "c0", "k", "ho", "wo", "planes",
                                              "fstride", "foff1", "zeros", "opitch")]]


def _operands(img) -> tuple:
    ops = tuple(img) if isinstance(img, (tuple, list)) else (img,)
    if not 1 <= len(ops) <= 2:
        raise ValueError(f"an image is one or two operands side by side, got {len(ops)}")
    return ops


def _tensor(x: Operand) -> torch.Tensor:
    return x.a if isinstance(x, Pick) else x


def _packed(x: Operand) -> Operand:
    """``x`` with its pixels packed, channels contiguous (a copy where they
    are not: a planar tensor seen as NHWC, a channel slice); the kernel
    reads a corner's channels as one run. A batch stride of 0 is kept."""
    t = _tensor(x)
    h, w, c = t.shape[1:]
    if t.stride()[1:] == (w * c, c, 1):
        return x
    if isinstance(x, Pick):
        return Pick(x.a.contiguous(), x.b.contiguous(), x.take_b)
    return x.contiguous()


def warp_cuda(img, flow: torch.Tensor, k: int = 1, padding_mode: str = "border",
              img1=None, out: torch.Tensor | None = None,
              offsets: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Warp ``img`` by ``flow`` (N, H, W, 2), a contiguous CUDA tensor;
    returns (N, H/k, W/k, C) in the image's dtype.

    ``img`` is an (N, H, W, C) operand (ops/planes.py: a tensor, also with a
    batch stride of 0, or a Pick) or a tuple of two side by side in channels
    (IFNet's frame, 3 channels, and its features); an operand whose pixels
    are not packed is copied. With ``img1`` (the same layout) the flow is
    (N, H, W, 4): ``img`` is warped by its channels 0:2 and ``img1`` by 2:4,
    in one launch; the result stacks the two as (2N, H/k, W/k, C), ``img``'s
    warps first. With ``out`` (N, H/k, W/k, C') contiguous, direction d is
    written into its channels [offsets[d], offsets[d] + C) instead, and
    ``out`` is returned.
    """
    check_cuda_input("flow", flow, ndim=4)
    dirs = [tuple(_packed(x) for x in _operands(im)) for im in (img, img1) if im is not None]
    n, h, w, fc = flow.shape
    if fc != 2 * len(dirs):
        raise ValueError(f"flow {tuple(flow.shape)}: expected {2 * len(dirs)} channels for "
                         f"{len(dirs)} direction(s)")
    first = _tensor(dirs[0][0])
    for ops in dirs:
        if [_tensor(x).shape[-1] for x in ops] != [_tensor(x).shape[-1] for x in dirs[0]]:
            raise ValueError("both directions' images must have the same operand channels")
        for x in ops:
            t = _tensor(x)
            if (tuple(t.shape[:3]) != (n, h, w) or t.device != flow.device
                    or t.dtype != first.dtype):
                raise ValueError(f"image operand {tuple(t.shape)} {t.dtype} on {t.device} does "
                                 f"not match the flow {tuple(flow.shape)} on {flow.device} and "
                                 f"{first.dtype}")
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"padding_mode must be 'border' or 'zeros', got {padding_mode!r}")
    if k != 1 and (k < 2 or k % 2 or h % k or w % k):
        raise ValueError(f"k must be 1 or an even divisor of H and W, got k={k} for {h}x{w}")
    if any(h * w * _tensor(x).stride()[2] >= 2 ** 31 for x in dirs[0]):
        raise ValueError(f"an image plane of {h}x{w} pixels is beyond the kernel's 32-bit "
                         "offsets")
    c = sum(_tensor(x).shape[-1] for x in dirs[0])
    ho, wo = h // k, w // k
    a = WarpArgs()
    if out is None:
        out = torch.empty((len(dirs) * n, ho, wo, c), dtype=first.dtype, device=first.device)
        a.ob, a.opitch = ho * wo * c, c
        a.off[0], a.off[1] = 0, n * ho * wo * c
    else:
        check_cuda_input("out", out, dtypes=(first.dtype,), ndim=4)
        if (tuple(out.shape[:3]) != (n, ho, wo) or out.device != first.device
                or min(offsets) < 0 or max(offsets[:len(dirs)]) + c > out.shape[-1]):
            raise ValueError(f"out {tuple(out.shape)} on {out.device} cannot hold {len(dirs)} "
                             f"direction(s) of ({n}, {ho}, {wo}, {c}) at channels {offsets}")
        a.ob, a.opitch = ho * wo * out.shape[-1], out.shape[-1]
        a.off[0], a.off[1] = offsets
    for d in range(2):
        ops = dirs[min(d, len(dirs) - 1)]
        for s, x in enumerate(ops):
            a.img[2 * d + s] = src(x, first.device)
    a.flow, a.out = flow.data_ptr(), out.data_ptr()
    a.n, a.h, a.w, a.c, a.c0, a.k, a.ho, a.wo = n, h, w, c, _tensor(dirs[0][0]).shape[-1], k, ho, wo
    a.planes, a.fstride, a.foff1 = len(dirs) * n, fc, 2
    a.zeros = int(padding_mode == "zeros")
    WARP.launch(ctypes.byref(a), dtype_code(first), dtype_code(flow), stream_of(first),
                device=first.device)
    return out
