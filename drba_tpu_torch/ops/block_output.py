"""An IFBlock's output written once (csrc/block_output.cu).

``block_output(lc, scale, flow, out_size)`` takes the lastconv's output
``lc`` (N, hl, wl, C >= 52: the 4 x 13 channels in pixel-shuffle order,
then any padding) and returns the block's (flow, mask, feat) at ``out_size``, the
IFNet's full resolution: ``pixel_shuffle(lc, 2)``'s first 13 channels
resized with ``F.interpolate``'s align_corners=False bilinear (placed as
they are where the block's resolution is ``out_size`` already), the first 4,
the flow, multiplied by ``scale`` and added to the running ``flow`` (none at
block 0), then the mask (1) and the features (8).

The plain version is the eager expression (``pixel_shuffle``,
``resize_bilinear``, a multiply, an add), each step rounded to the dtype;
the kernel rounds at the same steps. The wrapper launches the kernel for
CUDA tensors or raises (``backend``: ``auto | torch | cuda``, as
``_build.use_kernel`` resolves it). The kernel's mask and features are
views of one (N, H, W, 9) tensor, the plain version's of the resized 13
channels. The kernel replaces no TPU kernel: on the TPU, XLA fused the
block's tail into its consumers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from drba_tpu_torch._build import (BLOCK_OUTPUT, check_cuda_input, dtype_code, stream_of,
                                   use_kernel)
from drba_tpu_torch.ops.resize import resize_bilinear
from drba_tpu_torch.ops.shuffle import pixel_shuffle

OUT = 13  # flow 4, mask 1, features 8


class OutputArgs(ctypes.Structure):
    """csrc/block_output.cu:OutputArgs, field for field."""

    _fields_ = [("lc", ctypes.c_void_p),
                *[(f, ctypes.c_longlong) for f in ("sb", "sy", "sx")],
                ("flow", ctypes.c_void_p), ("flow_out", ctypes.c_void_p),
                ("mf_out", ctypes.c_void_p),
                *[(f, ctypes.c_int) for f in ("n", "hb", "wb", "ho", "wo", "resize")],
                *[(f, ctypes.c_float) for f in ("sh", "sw", "scale")]]


def _output_plain(lc: torch.Tensor, scale: float, flow: torch.Tensor | None,
                  out_size: tuple[int, int]):
    tmp = resize_bilinear(pixel_shuffle(lc, 2, channels=OUT), out_size)
    fd = tmp[..., :4] * scale
    return (fd if flow is None else flow + fd), tmp[..., 4:5], tmp[..., 5:]


def block_output(lc: torch.Tensor, scale: float, flow: torch.Tensor | None,
                 out_size: tuple[int, int], backend: str = "auto"):
    """(flow, mask, feat) of an IFBlock at ``out_size`` from its lastconv's
    output ``lc`` (module docstring); ``flow``, the running flow (N, H, W, 4)
    in ``lc``'s dtype, or None."""
    n, hl, wl, c = lc.shape
    ho, wo = int(out_size[0]), int(out_size[1])
    if c < 4 * OUT or (flow is not None and tuple(flow.shape) != (n, ho, wo, 4)):
        raise ValueError(f"lastconv output {tuple(lc.shape)} and flow "
                         f"{None if flow is None else tuple(flow.shape)} do not give a block "
                         f"output at {(ho, wo)}")
    if not use_kernel(backend, lc):
        return _output_plain(lc, scale, flow, (ho, wo))
    elem = lc.element_size()
    if lc.stride(-1) != 1 or any(s * elem % 4 for s in lc.stride()[:3]) or lc.data_ptr() % 4:
        raise ValueError(f"the kernel reads contiguous channels in 4-byte words, got "
                         f"{tuple(lc.shape)} with strides {lc.stride()}")
    dtype_code(lc)
    if flow is not None:
        check_cuda_input("flow", flow, dtypes=(lc.dtype,))
        if flow.data_ptr() % 16 or flow.device != lc.device:
            raise ValueError("flow: expected a 16-byte aligned tensor on the lastconv's device")
    if n * ho * wo * (OUT - 4) >= 2 ** 31:
        raise ValueError(f"the kernel writes fewer than 2^31 elements, got {n} x {(ho, wo)}")
    flow_out = torch.empty((n, ho, wo, 4), dtype=lc.dtype, device=lc.device)
    mf = torch.empty((n, ho, wo, OUT - 4), dtype=lc.dtype, device=lc.device)
    hb, wb = 2 * hl, 2 * wl
    a = OutputArgs()
    a.lc = lc.data_ptr()
    a.sb, a.sy, a.sx = lc.stride()[:3]
    a.flow = None if flow is None else flow.data_ptr()
    a.flow_out, a.mf_out = flow_out.data_ptr(), mf.data_ptr()
    a.n, a.hb, a.wb, a.ho, a.wo = n, hb, wb, ho, wo
    a.resize = (hb, wb) != (ho, wo)
    # F.interpolate's scales: in / out in f32
    a.sh, a.sw = float(np.float32(hb) / np.float32(ho)), float(np.float32(wb) / np.float32(wo))
    a.scale = scale
    BLOCK_OUTPUT.launch(ctypes.byref(a), dtype_code(lc), stream_of(lc), device=lc.device)
    return flow_out, mf[..., :1], mf[..., 1:]
