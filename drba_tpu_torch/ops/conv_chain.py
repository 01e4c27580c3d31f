"""Chains of 3x3 / stride-1 / pad-1 convs with fused epilogues.

Counterpart of drba_tpu/ops/conv_chain.py, for the epilogues the RIFE path
uses: bias, and the IFNet ResConv ``leaky_relu(conv(x) * beta + x, 0.2)``.
The TPU kernel's pre-PReLU, plain-residual and final-residual epilogues serve
the GMFSS nets only under the JAX package's ``conv_backend='pallas'`` (its
default runs those convs on XLA, as the port runs them on cuDNN), and are not
ported.

``conv_chain(x, steps)`` runs one hand-written kernel launch per step
(csrc/conv_chain.cu) for CUDA tensors, and chained ``F.conv2d`` calls with the
same epilogues for CPU tensors (or ``backend='torch'``). The bf16 kernel reads
its weights packed by ``pack_weights``, once, where a model builds its
parameters (models/ifnet.pack_resconv_weights; ``chain_step`` elsewhere).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from drba_tpu_torch._build import CONV, check_cuda_input, dtype_code, stream_of, use_kernel


class ChainStep(NamedTuple):
    """One conv of the chain: ``y = conv3x3(x) + b``, then with ``beta`` the
    ResConv epilogue ``y = leaky_relu(y * beta + x, 0.2)``.

    w: (Cout, Cin, 3, 3) PyTorch layout; b, beta: (Cout,); wp: ``w`` packed
    for the bf16 kernel (``pack_weights``), which needs it.
    """

    w: torch.Tensor
    b: torch.Tensor
    beta: torch.Tensor | None = None
    wp: torch.Tensor | None = None


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (ceil(Cin/16), 9, Cout, 16), zero past Cin.

    The bf16 kernel's B layout: K chunk g holds input channels [16 g,
    16 g + 16) of every (tap, output channel) as one contiguous 32-byte row,
    taps in raster order (ky, kx).
    """
    cout, cin = w.shape[:2]
    cin_pad = -(-cin // 16) * 16
    wp = w.new_zeros((cout, cin_pad, 3, 3))
    wp[:, :cin] = w
    return wp.reshape(cout, cin_pad // 16, 16, 9).permute(1, 3, 0, 2).contiguous()


def unpack_weights(wp: torch.Tensor, cin: int) -> torch.Tensor:
    """The inverse of ``pack_weights``: (ceil(Cin/16), 9, Cout, 16) -> (Cout, Cin, 3, 3)."""
    chunks, _, cout, _ = wp.shape
    return wp.permute(2, 0, 3, 1).reshape(cout, chunks * 16, 3, 3)[:, :cin].contiguous()


def conv3x3_packed_plain(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv3x3(x) + b (NHWC, pad 1) computed from the packed weights as the
    kernel's implicit GEMM does: per K chunk and tap, the shifted input window
    times that chunk's (Cout, 16) slice, summed in f32."""
    n, h, w, cin = x.shape
    chunks = wp.shape[0]
    xp = torch.zeros((n, h + 2, w + 2, chunks * 16), dtype=torch.float32, device=x.device)
    xp[:, 1:h + 1, 1:w + 1, :cin] = x.float()
    acc = torch.zeros((n, h, w, wp.shape[2]), dtype=torch.float32, device=x.device)
    for g in range(chunks):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            win = xp[:, dy:dy + h, dx:dx + w, 16 * g:16 * g + 16]
            acc = acc + win @ wp[g, tap].float().t()
    return (acc + b.float()).to(x.dtype)


def chain_step(w: torch.Tensor, b: torch.Tensor,
               beta: torch.Tensor | None = None) -> ChainStep:
    """A ChainStep with its weights packed once for the bf16 kernel."""
    return ChainStep(w=w, b=b, beta=beta, wp=pack_weights(w))


def _step_plain(x: torch.Tensor, s: ChainStep) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), s.w, s.b, padding=1).permute(0, 2, 3, 1)
    if s.beta is not None:
        y = F.leaky_relu(y * s.beta + x, 0.2)
    return y


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 beta: torch.Tensor | None = None,
                 wp: torch.Tensor | None = None) -> torch.Tensor:
    """One chain step on the kernel: x (N,H,W,Cin) -> (N,H,W,Cout), all one
    dtype. bf16 reads ``wp`` (``pack_weights(w)``), f32 reads ``w``."""
    check_cuda_input("x", x, ndim=4)
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if x.dtype == torch.bfloat16 and wp is None:
        raise ValueError("the bf16 conv kernel reads packed weights: pass wp=pack_weights(w) "
                         "(ChainSteps from chain_step hold them)")
    packed = (-(-cin // 16), 9, cout, 16)
    for name, t, shape in (("w", w, (cout, cin, 3, 3)), ("b", b, (cout,)),
                           ("beta", beta, (cout,)), ("wp", wp, packed)):
        if t is None:
            continue
        check_cuda_input(name, t, dtypes=(x.dtype,))
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if beta is not None and cin != cout:
        raise ValueError(f"the ResConv epilogue needs Cin == Cout, got {cin} -> {cout}")
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    CONV.launch(x.data_ptr(), w.data_ptr(), None if wp is None else wp.data_ptr(), b.data_ptr(),
                None if beta is None else beta.data_ptr(), out.data_ptr(),
                n, h, wd, cin, cout, dtype_code(x), stream_of(x), device=x.device)
    return out


def conv_chain(x: torch.Tensor, steps: Sequence[ChainStep],
               backend: str = "auto") -> torch.Tensor:
    """Run ``steps`` in order on NHWC ``x``; returns (N, H, W, C_out)."""
    if use_kernel(backend, x):
        x = x.contiguous()
        for s in steps:
            x = conv3x3_cuda(x, s.w.contiguous(), s.b.contiguous(),
                             None if s.beta is None else s.beta.contiguous(),
                             None if s.wp is None else s.wp.contiguous())
        return x
    for s in steps:
        x = _step_plain(x, s)
    return x
