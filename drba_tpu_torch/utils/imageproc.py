"""Host <-> device image conversion and network-legal sizing
(counterpart of drba_tpu/utils/imageproc.py).

Frames enter as HWC uint8 (BGR from the decoder) and leave the same way; the
network size is reached by bilinear resize, as ``get_valid_net_inp_size`` in
the reference does.

On a CUDA device a frame crosses between host and card through pinned host
memory, both ways, by a copy that does not block the host: a copy from or
into pageable memory holds the CUDA runtime until its stream reaches it,
behind whatever was queued before, and every other thread's launches and
copies wait meanwhile. The pinned blocks come from PyTorch's caching host
allocator, which hands a block out again only after the copies recorded on
it have passed, so the blocks in use are those of the copies in flight. A
frame that comes down is copied out of its block before it is returned: a
writer's queue of frames holds no pinned memory.
"""

from __future__ import annotations

import numpy as np
import torch

from drba_tpu_torch.ops.resize import resize_to
from drba_tpu_torch.utils import profiling


def _net_dim(dim: int, scale: float, div: int) -> int:
    """Smallest working dimension >= dim whose scaled extent is a multiple of
    ``div``, with the reference's float arithmetic (tools.py:41-56)."""
    scaled = dim * scale
    if scaled % div == 0:
        return dim
    return int((scaled // div + 1) * div / scale)


def get_valid_net_inp_size(img: np.ndarray, scale: float, div: int = 64) -> dict:
    h, w = img.shape[:2]
    return {"src_size": (h, w),
            "dst_size": (_net_dim(h, scale, div), _net_dim(w, scale, div))}


def to_tensor(img: np.ndarray, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """HWC uint8 -> (1,H,W,C) float in [0, 1] on ``device``; the frame crosses
    to the device as uint8 and is normalised there. To a CUDA device it goes
    through pinned memory, on the current stream, without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(img))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t.to(dtype)[None] / 255.0


def to_uint8(x: torch.Tensor) -> np.ndarray:
    """(1,H,W,C) float [0,1] -> HWC uint8 on the host (truncation, like
    ``(x*255).astype(uint8)`` in the reference); quantised on the device.
    From a CUDA device the frame comes down into pinned memory, the calling
    thread sleeps on an event behind the copy, and the frame is returned in
    pageable memory. With a recorder active (``utils/profiling.py``) the
    sleep is the span ``d2h-wait`` (the quantise and the copy, and whatever
    the stream queued before them) and the copy into pageable memory the
    span ``copy-out``."""
    q = (x[0].float() * 255.0).clamp(0, 255).to(torch.uint8)
    staged, done = q, None
    if q.is_cuda:
        staged = torch.empty(q.shape, dtype=q.dtype, pin_memory=True)
        staged.copy_(q, non_blocking=True)
        done = torch.cuda.Event(blocking=True)
        done.record(torch.cuda.current_stream(q.device))
    tr = profiling.active()
    with tr.span("d2h-wait") if tr is not None else profiling.NULL:
        if done is not None:
            done.synchronize()
    with tr.span("copy-out") if tr is not None else profiling.NULL:
        return staged.numpy().copy()


def to_inp(img: np.ndarray, dst_size: tuple[int, int], dtype=torch.float32,
           device="cpu") -> torch.Tensor:
    return resize_to(to_tensor(img, dtype, device), dst_size)


def to_out(x: torch.Tensor, src_size: tuple[int, int]) -> np.ndarray:
    return to_uint8(resize_to(x.float(), src_size))
