"""NHWC operands that the hand-written kernels read where they lie.

An operand of ``warp.cu`` and ``block_input.cu`` is N planes of an (N, H, W,
C) tensor with any strides: a batch stride of 0 shares one frame among the
planes (``shared``: a window's frame at each of its T timesteps), and a
:class:`Pick` chooses one of two such tensors per plane (the B side of a
DRBA window, I0 before the window's centre and I2 after it). The plain
versions read the same values through :func:`dense`. :class:`Src` is the
kernels' description of one operand (csrc/common.cuh:Src).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Union

import torch

from drba_tpu_torch._build import dtype_code


@dataclass(frozen=True)
class Pick:
    """Plane p of ``a`` where ``take_b[p]`` is False, else of ``b``: both (N,
    H, W, C) with the same strides, ``take_b`` an (N,) bool tensor on their
    device. (Not a tuple: a tuple of operands lies side by side in
    channels.)"""

    a: torch.Tensor
    b: torch.Tensor
    take_b: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.a.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device


Operand = Union[torch.Tensor, Pick]


def shared(x: torch.Tensor, T: int) -> torch.Tensor:
    """``x`` (n, H, W, C) at each of T timesteps, folded into (T n, H, W, C)
    planes: a batch stride of 0 for one frame, no copy; a copy for n > 1."""
    if x.shape[0] == 1:
        return x.expand((T,) + tuple(x.shape[1:]))
    return x[None].expand((T,) + tuple(x.shape)).reshape((-1,) + tuple(x.shape[1:]))


def first_channels(x: Operand, c: int) -> Operand:
    """``x[..., :c]``, a view (of both frames of a Pick)."""
    if isinstance(x, Pick):
        return Pick(x.a[..., :c], x.b[..., :c], x.take_b)
    return x[..., :c]


def dense(x: Operand) -> torch.Tensor:
    """The operand's values as one tensor (the plain versions' input)."""
    if isinstance(x, Pick):
        return torch.where(x.take_b[:, None, None, None], x.b, x.a)
    return x


class Src(ctypes.Structure):
    """csrc/common.cuh:Src, field for field."""

    _fields_ = [("ptr", ctypes.c_void_p * 2), ("pick", ctypes.c_void_p),
                ("sb", ctypes.c_longlong), ("sy", ctypes.c_longlong),
                ("sx", ctypes.c_longlong), ("sc", ctypes.c_longlong),
                ("c", ctypes.c_int), ("dtype", ctypes.c_int), ("mult", ctypes.c_float)]


def src(x: Operand, device: torch.device, mult: float = 1.0) -> Src:
    """The kernels' description of operand ``x``; raises unless it lies on
    ``device`` in f32 or bf16 (a Pick's frames alike, its choice a
    contiguous (N,) bool tensor there)."""
    a, b = (x.a, x.b) if isinstance(x, Pick) else (x, None)
    for name, t in (("operand", a), ("its second frame", b)):
        if t is None:
            continue
        if t.device != device or t.dim() != 4:
            raise ValueError(f"{name}: expected an (N, H, W, C) tensor on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        dtype_code(t)
    if b is not None:
        if b.shape != a.shape or b.stride() != a.stride() or b.dtype != a.dtype:
            raise ValueError(f"Pick: frames {tuple(a.shape)} {a.stride()} {a.dtype} and "
                             f"{tuple(b.shape)} {b.stride()} {b.dtype} differ")
        pick = x.take_b
        if (pick.dtype != torch.bool or pick.shape != (a.shape[0],) or pick.device != device
                or not pick.is_contiguous()):
            raise ValueError(f"Pick: take_b must be a contiguous ({a.shape[0]},) bool tensor "
                             f"on {device}, got {tuple(pick.shape)} {pick.dtype} on {pick.device}")
    s = Src()
    s.ptr[0] = a.data_ptr()
    s.ptr[1] = a.data_ptr() if b is None else b.data_ptr()
    s.pick = None if b is None else x.take_b.data_ptr()
    s.sb, s.sy, s.sx, s.sc = a.stride()
    s.c = a.shape[-1]
    s.dtype = dtype_code(a)
    s.mult = mult
    return s
