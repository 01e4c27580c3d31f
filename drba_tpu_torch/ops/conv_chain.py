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
kernels read their weights packed once, where a model builds its parameters
(models/ifnet.pack_resconv_weights, models/gmfss_nets.pack_chain_weights;
``chain_step`` elsewhere), by ``pack_step_weights``: bf16 by
``pack_weights``, f32 split into hi and lo in fragment order by
``pack_weights_tf32``. Each step takes one of three kernel designs, as
``conv3x3_path`` plans it from the dtype and the shape: ``"tf32"`` (f32,
3xTF32 on mma.sync), ``"mma"`` (bf16 on mma.sync, the small and narrow
steps) or ``"wgmma"`` (bf16 on wgmma with persistent blocks, the large
steps).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from drba_tpu_torch._build import CONV, check_cuda_input, dtype_code, stream_of, use_kernel
from drba_tpu_torch.ops.tf32 import pack_frags, split_tf32, tf32_read, unpack_frags

RESIDUALS = ("none", "input", "extra")
# the kernel designs of csrc/conv_chain.cu, by the code its C entry takes
PATHS = ("tf32", "mma", "wgmma")
# the fewest warpgroup tiles (64 columns x its rows) for the wgmma design:
# 8 for each of the H100's 2 x 132 warpgroups. Below that, each block's
# one-time weight load and the launch's tensor maps outweigh its tiles
# (RIFE's 64-channel step at 3 x 136 x 240, 816 tiles, measured slower
# than mma.sync on the H100)
WGMMA_MIN_TILES = 16 * 132
# the most weight bytes a wgmma block keeps in shared memory
WGMMA_RESIDENT_BYTES = 9 * 128 * 64 * 2


def wgmma_blocks(cin: int, cout: int) -> tuple[int, int, bool]:
    """(output channels a block, output rows a warpgroup tile, weights
    resident) of the wgmma design at this width, as
    csrc/conv_chain.cu:conv3x3_wgmma picks them: 128 channels and one row
    where those weights fit resident (147 456 bytes), else 64 channels and
    two rows where they do, else the weights streamed with each K chunk."""
    wbytes = 9 * cin * 2
    if cout % 128 == 0 and wbytes * 128 <= WGMMA_RESIDENT_BYTES:
        return 128, 1, True
    if wbytes * 64 <= WGMMA_RESIDENT_BYTES:
        return 64, 2, True
    return (128, 1, False) if cout % 128 == 0 else (64, 2, False)


def wgmma_takes(cin: int, cout: int) -> bool:
    """The wgmma design's shape rules: Cin a multiple of 16, Cout a
    multiple of 64 up to 256 (and bf16 with 16-byte aligned tensors)."""
    return cin % 16 == 0 and cin >= 16 and cout % 64 == 0 and 0 < cout <= 256


def conv3x3_path(n: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype) -> str:
    """The kernel design a step of this shape takes: ``"tf32"`` for every
    f32 step (3xTF32 on mma.sync; it replaced the FMA design, which the
    H100 measured slower at every GMFSS and RIFE step); ``"wgmma"`` for
    bf16 steps with Cin a multiple of 16 and at least 64,
    Cout a multiple of 64 up to 256, weights that fit resident in a block
    (``wgmma_blocks``) and ``WGMMA_MIN_TILES`` tiles; ``"mma"`` for the
    other bf16 steps (RIFE's ResConvs, Cin 9/12/14, Cout 2, and GridNet's
    256 -> 128 head, where the wgmma design streams its weights and
    measured slower than mma.sync on the H100)."""
    if dtype != torch.bfloat16:
        return "tf32"
    if not (wgmma_takes(cin, cout) and cin >= 64):
        return "mma"
    nb, rows, resident = wgmma_blocks(cin, cout)
    tiles = n * -(-h // rows) * -(-w // 64) * (cout // nb)
    return "wgmma" if resident and tiles >= WGMMA_MIN_TILES else "mma"


class ChainStep(NamedTuple):
    """One conv of the chain: ``y = conv3x3(pre(x)) + b``, then the epilogue.

    w: (Cout, Cin, 3, 3) PyTorch layout; b, beta: (Cout,); wp: ``w`` packed
    for the kernel of its dtype (``pack_step_weights``), which needs it.
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


def pack_weights_tf32(w: torch.Tensor) -> torch.Tensor:
    """f32 (Cout, Cin, 3, 3) -> (ceil(Cin/8), 9, ceil(Cout/8), 32, 4), zero
    past Cin and Cout.

    The f32 kernel's B fragments, split: per K chunk of 8 input channels,
    tap (raster order) and n8 tile of output channels, lane 4 g + t holds
    (hi b0, hi b1, lo b0, lo b1) with b0 = w[8 nt + g, 8 c + 2 t] and b1 =
    w[8 nt + g, 8 c + 2 t + 1] (``ops/tf32.pack_frags`` of the tap's
    (Cin, Cout) matrix; hi + lo == w exactly, ``split_tf32``).
    """
    cout, cin = w.shape[:2]
    ci, co = -(-cin // 8) * 8, -(-cout // 8) * 8
    taps = w.new_zeros((9, ci, co), dtype=torch.float32)
    taps[:, :cin, :cout] = w.float().permute(2, 3, 1, 0).reshape(9, cin, cout)
    return torch.stack([pack_frags(t) for t in taps], dim=1).contiguous()


def pack_step_weights(w: torch.Tensor) -> torch.Tensor:
    """``w`` packed for the kernel of its dtype: split by
    ``pack_weights_tf32`` for f32, ``pack_weights`` for bf16."""
    return pack_weights_tf32(w) if w.dtype == torch.float32 else pack_weights(w)


def unpack_weights(wp: torch.Tensor, cin: int, cout: int | None = None) -> torch.Tensor:
    """The inverse of either packing -> (Cout, Cin, 3, 3): ``pack_weights``'
    (ceil(Cin/16), 9, Cout, 16), or ``pack_weights_tf32``'s (ceil(Cin/8), 9,
    ceil(Cout/8), 32, 4) as hi + lo (``cout`` cuts its padding)."""
    if wp.dim() == 5:
        chunks, _, ntiles = wp.shape[:3]
        taps = torch.stack([sum(unpack_frags(wp[:, t])) for t in range(9)])  # (9, Ci, Co)
        w = taps.reshape(3, 3, chunks * 8, ntiles * 8).permute(3, 2, 0, 1)
        return w[:cout, :cin].contiguous()
    chunks, _, co, _ = wp.shape
    return wp.permute(2, 0, 3, 1).reshape(co, chunks * 16, 3, 3)[:cout, :cin].contiguous()


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


def conv3x3_tf32_plain(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv3x3(x) + b (NHWC f32, pad 1) computed from the split weights
    (``pack_weights_tf32``) as the f32 kernel's 3xTF32 products are: per K
    chunk of 8 channels and tap, x_lo w_hi + x_hi w_lo + x_hi w_hi (each lo
    read as TF32, x split as ``split_tf32``), summed in f32 in that order."""
    n, h, w, cin = x.shape
    chunks, _, ntiles = wp.shape[:3]
    xp = torch.zeros((n, h + 2, w + 2, chunks * 8), dtype=torch.float32, device=x.device)
    xp[:, 1:h + 1, 1:w + 1, :cin] = x.float()
    xh, xl = split_tf32(xp)
    xl = tf32_read(xl)
    acc = torch.zeros((n, h, w, ntiles * 8), dtype=torch.float32, device=x.device)
    for g in range(chunks):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            wh, wl = unpack_frags(wp[g:g + 1, tap])  # (8, Cout_pad) each
            win = (slice(None), slice(dy, dy + h), slice(dx, dx + w), slice(8 * g, 8 * g + 8))
            acc = acc + xl[win] @ wh
            acc = acc + xh[win] @ tf32_read(wl)
            acc = acc + xh[win] @ wh
    return acc[..., :b.shape[0]] + b.float()


def chain_step(w: torch.Tensor, b: torch.Tensor, beta: torch.Tensor | None = None,
               pre_alpha: torch.Tensor | None = None, plain_res: bool = False) -> ChainStep:
    """A ChainStep with its weights packed once for the kernel of their dtype."""
    return ChainStep(w=w, b=b, beta=beta, wp=pack_step_weights(w), pre_alpha=pre_alpha,
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
                 res: torch.Tensor | None = None, path: str | None = None) -> torch.Tensor:
    """One chain step on the kernel: x (N,H,W,Cin) -> (N,H,W,Cout), all one
    dtype. The kernel reads ``wp``, ``w`` packed for its dtype
    (``pack_step_weights``): bf16 ``pack_weights(w)``, f32 the split
    ``pack_weights_tf32(w)``; any other layout is refused by its shape and
    dtype. ``alpha``: the pre-PReLU's slope (one value); ``res``:
    (N,H,W,Cout) added last. ``path``: the kernel design (``PATHS``); None
    takes ``conv3x3_path``'s plan. A design that does not take the dtype or
    the shape raises."""
    check_cuda_input("x", x, ndim=4)
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    path = conv3x3_path(n, h, wd, cin, cout, x.dtype) if path is None else path
    if path not in PATHS:
        raise ValueError(f"path={path!r}; valid: {', '.join(PATHS)}")
    f32 = x.dtype == torch.float32
    if (path == "tf32") != f32:
        raise ValueError(f"the {path} kernel does not take {x.dtype}")
    if wp is None:
        raise ValueError(f"the {path} conv kernel reads packed weights: pass "
                         f"wp=pack_step_weights(w) (ChainSteps from chain_step hold them)")
    packed = (-(-cin // 8), 9, -(-cout // 8), 32, 4) if f32 else (-(-cin // 16), 9, cout, 16)
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
    if path == "wgmma":
        if not wgmma_takes(cin, cout):
            raise ValueError(f"the wgmma kernel takes Cin a multiple of 16 and Cout a multiple "
                             f"of 64 up to 256, got {cin} -> {cout}")
        if any(t is not None and t.data_ptr() % 16 for t in (x, res, out)):
            raise ValueError("the wgmma kernel reads and writes 16-byte aligned tensors")

    def ptr(t):
        return None if t is None else t.data_ptr()

    CONV.launch(x.data_ptr(), w.data_ptr(), wp.data_ptr(), b.data_ptr(), ptr(beta), ptr(alpha),
                ptr(res), out.data_ptr(), n, h, wd, cin, cout, dtype_code(x),
                PATHS.index(path), stream_of(x), device=x.device)
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
        if kernel:  # wp as packed: a cast would not make another dtype's layout
            x = conv3x3_cuda(x, arg(s.w), arg(s.b), arg(s.beta), s.wp, arg(s.pre_alpha),
                             arg(r))
        else:
            x = _step_plain(x, s, r)
    return x
