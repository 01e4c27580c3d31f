"""Chains of 3x3 / stride-1 / pad-1 convs with fused epilogues.

Counterpart of drba_tpu/ops/conv_chain.py, for the epilogues the RIFE path
uses: bias, and the IFNet ResConv ``leaky_relu(conv(x) * beta + x, 0.2)``.
The TPU kernel's pre-PReLU, plain-residual and final-residual epilogues serve
the GMFSS nets only under the JAX package's ``conv_backend='pallas'`` (its
default runs those convs on XLA, as the port runs them on cuDNN), and are not
ported.

``conv_chain(x, steps)`` runs one hand-written kernel launch per step
(csrc/conv_chain.cu) for CUDA tensors, and chained ``F.conv2d`` calls with the
same epilogues for CPU tensors (or ``backend='torch'``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from drba_tpu_torch._build import CONV, check_cuda_input, dtype_code, stream_of, use_kernel


class ChainStep(NamedTuple):
    """One conv of the chain: ``y = conv3x3(x) + b``, then with ``beta`` the
    ResConv epilogue ``y = leaky_relu(y * beta + x, 0.2)``.

    w: (Cout, Cin, 3, 3) PyTorch layout; b, beta: (Cout,).
    """

    w: torch.Tensor
    b: torch.Tensor
    beta: torch.Tensor | None = None


def _step_plain(x: torch.Tensor, s: ChainStep) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), s.w, s.b, padding=1).permute(0, 2, 3, 1)
    if s.beta is not None:
        y = F.leaky_relu(y * s.beta + x, 0.2)
    return y


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 beta: torch.Tensor | None = None) -> torch.Tensor:
    """One chain step on the kernel: x (N,H,W,Cin) -> (N,H,W,Cout), all one dtype."""
    check_cuda_input("x", x, ndim=4)
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    for name, t, shape in (("w", w, (cout, cin, 3, 3)), ("b", b, (cout,)),
                           ("beta", beta, (cout,))):
        if t is None:
            continue
        check_cuda_input(name, t, dtypes=(x.dtype,))
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if beta is not None and cin != cout:
        raise ValueError(f"the ResConv epilogue needs Cin == Cout, got {cin} -> {cout}")
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    CONV.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                None if beta is None else beta.data_ptr(), out.data_ptr(),
                n, h, wd, cin, cout, dtype_code(x), stream_of(x))
    return out


def conv_chain(x: torch.Tensor, steps: Sequence[ChainStep],
               backend: str = "auto") -> torch.Tensor:
    """Run ``steps`` in order on NHWC ``x``; returns (N, H, W, C_out)."""
    if use_kernel(backend, x):
        x = x.contiguous()
        for s in steps:
            x = conv3x3_cuda(x, s.w.contiguous(), s.b.contiguous(),
                             None if s.beta is None else s.beta.contiguous())
        return x
    for s in steps:
        x = _step_plain(x, s)
    return x
