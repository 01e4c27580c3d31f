"""Chains of 3x3 / stride-1 / pad-1 convs with fused epilogues.

Counterpart of drba_tpu/ops/conv_chain.py, with all of its epilogues: bias;
the IFNet ResConv ``leaky_relu(conv(x) * beta + x, 0.2)``; a scalar
pre-PReLU on a step's input (GridNet's and MetricNet's (PReLU, Conv) pairs);
the plain residual ``conv(prelu(x)) + x``; and a final residual on the last
step, the chain's input (``residual='input'``) or another tensor
(``residual='extra'``, GridNet's lattice sums). The TPU kernel's column
packing (``packed``), row bands (``hb``) and channel padding are TPU layout
work and have no counterpart: the kernel takes any channel count.

``conv_chain(x, steps, residual, res)`` runs one hand-written kernel launch
per step (csrc/conv_chain.cu) for CUDA tensors, and chained ``F.conv2d``
calls with the same epilogues for CPU tensors (or ``backend='torch'``). The
bf16 kernel reads its weights packed by ``pack_weights``, once, where a
model builds its parameters (models/ifnet.pack_resconv_weights,
models/gmfss_nets.pack_chain_weights; ``chain_step`` elsewhere).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from drba_tpu_torch._build import CONV, check_cuda_input, dtype_code, stream_of, use_kernel

RESIDUALS = ("none", "input", "extra")


class ChainStep(NamedTuple):
    """One conv of the chain: ``y = conv3x3(pre(x)) + b``, then the epilogue.

    w: (Cout, Cin, 3, 3) PyTorch layout; b, beta: (Cout,); wp: ``w`` packed
    for the bf16 kernel (``pack_weights``), which needs it.
    beta: the ResConv epilogue ``y = leaky_relu(y * beta + x, 0.2)``.
    pre_alpha: the scalar slope of a PReLU on the conv's input (one value,
        shape () or (1,)); never with ``beta``.
    plain_res: ``y = y + x`` with this step's un-activated input x; needs
        Cin == Cout, never with ``beta``.
    """

    w: torch.Tensor
    b: torch.Tensor
    beta: torch.Tensor | None = None
    wp: torch.Tensor | None = None
    pre_alpha: torch.Tensor | None = None
    plain_res: bool = False


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


def chain_step(w: torch.Tensor, b: torch.Tensor, beta: torch.Tensor | None = None,
               pre_alpha: torch.Tensor | None = None, plain_res: bool = False) -> ChainStep:
    """A ChainStep with its weights packed once for the bf16 kernel."""
    return ChainStep(w=w, b=b, beta=beta, wp=pack_weights(w), pre_alpha=pre_alpha,
                     plain_res=plain_res)


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``nn.PReLU()`` with one shared slope, as models/layers.prelu."""
    return torch.where(x >= 0, x, x * alpha.to(x.dtype).reshape(()))


def _step_plain(x: torch.Tensor, s: ChainStep, res: torch.Tensor | None = None) -> torch.Tensor:
    """One step with eager ops, each rounded to x's dtype: the pre-PReLU, the
    conv with its bias, the ResConv epilogue, then ``+ res``."""
    inp = x if s.pre_alpha is None else _prelu(x, s.pre_alpha)
    y = F.conv2d(inp.permute(0, 3, 1, 2), s.w.to(x.dtype), s.b.to(x.dtype),
                 padding=1).permute(0, 2, 3, 1)
    if s.beta is not None:
        y = F.leaky_relu(y * s.beta.to(x.dtype) + x, 0.2)
    if res is not None:
        y = y + res
    return y


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 beta: torch.Tensor | None = None, wp: torch.Tensor | None = None,
                 alpha: torch.Tensor | None = None,
                 res: torch.Tensor | None = None) -> torch.Tensor:
    """One chain step on the kernel: x (N,H,W,Cin) -> (N,H,W,Cout), all one
    dtype. bf16 reads ``wp`` (``pack_weights(w)``), f32 reads ``w``.
    ``alpha``: the pre-PReLU's slope (one value); ``res``: (N,H,W,Cout)
    added last."""
    check_cuda_input("x", x, ndim=4)
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if x.dtype == torch.bfloat16 and wp is None:
        raise ValueError("the bf16 conv kernel reads packed weights: pass wp=pack_weights(w) "
                         "(ChainSteps from chain_step hold them)")
    packed = (-(-cin // 16), 9, cout, 16)
    alpha = None if alpha is None else alpha.reshape(-1)
    for name, t, shape in (("w", w, (cout, cin, 3, 3)), ("b", b, (cout,)),
                           ("beta", beta, (cout,)), ("wp", wp, packed), ("alpha", alpha, (1,)),
                           ("res", res, (n, h, wd, cout))):
        if t is None:
            continue
        check_cuda_input(name, t, dtypes=(x.dtype,))
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if beta is not None and cin != cout:
        raise ValueError(f"the ResConv epilogue needs Cin == Cout, got {cin} -> {cout}")
    if beta is not None and alpha is not None:
        raise ValueError("the pre-PReLU does not combine with the ResConv epilogue")
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    CONV.launch(x.data_ptr(), w.data_ptr(), ptr(wp), b.data_ptr(), ptr(beta), ptr(alpha),
                ptr(res), out.data_ptr(), n, h, wd, cin, cout, dtype_code(x), stream_of(x),
                device=x.device)
    return out


def _check_chain(x: torch.Tensor, steps: Sequence[ChainStep], residual: str,
                 res: torch.Tensor | None) -> None:
    """drba_tpu's conv_chain asserts, as ValueErrors."""
    if residual not in RESIDUALS:
        raise ValueError(f"residual={residual!r}; valid: {', '.join(RESIDUALS)}")
    if not steps:
        raise ValueError("a chain needs at least one step")
    cin = x.shape[-1]
    for i, s in enumerate(steps):
        cout, wcin = s.w.shape[:2]
        if wcin != cin:
            raise ValueError(f"step {i}: weights take {wcin} channels, its input has {cin}")
        if s.beta is not None and (s.pre_alpha is not None or s.plain_res):
            raise ValueError(f"step {i}: beta combines with neither pre_alpha nor plain_res")
        if s.plain_res and cin != cout:
            raise ValueError(f"step {i}: plain_res needs Cin == Cout, got {cin} -> {cout}")
        cin = cout
    if residual == "input" and cin != x.shape[-1]:
        raise ValueError(f"residual='input' needs C_out == C_0, got {x.shape[-1]} -> {cin}")
    if residual == "extra" and (res is None or tuple(res.shape) != (*x.shape[:3], cin)):
        raise ValueError(f"residual='extra' needs res of shape {(*x.shape[:3], cin)}, got "
                         f"{None if res is None else tuple(res.shape)}")
    if residual != "none" and steps[-1].plain_res:
        # the kernel adds one residual tensor a step
        raise ValueError("the last step's plain_res does not combine with a final residual")


def conv_chain(x: torch.Tensor, steps: Sequence[ChainStep], residual: str = "none",
               res: torch.Tensor | None = None, backend: str = "auto") -> torch.Tensor:
    """Run ``steps`` in order on NHWC ``x``; returns (N, H, W, C_out).

    residual: 'none' | 'input' (the last step adds ``x``; C_out == C_0) |
    'extra' (the last step adds ``res``, (N, H, W, C_out)). Step weights are
    cast to x's dtype (a no-op where they are in it already).
    """
    _check_chain(x, steps, residual, res)
    kernel = use_kernel(backend, x)
    x0 = x.contiguous() if kernel else x

    def arg(t):  # a step's tensor as the kernel takes it
        return None if t is None else t.to(x0.dtype).contiguous()

    x = x0
    for i, s in enumerate(steps):
        r = x if s.plain_res else None
        if i == len(steps) - 1 and residual != "none":
            r = x0 if residual == "input" else res
        if kernel:
            x = conv3x3_cuda(x, arg(s.w), arg(s.b), arg(s.beta), arg(s.wp), arg(s.pre_alpha),
                             arg(r))
        else:
            x = _step_plain(x, s, r)
    return x
