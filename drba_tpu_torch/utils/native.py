"""ctypes bindings of the host runtime ``csrc/host.cpp`` (counterpart of
drba_tpu/utils/native.py).

The library is built from the repository's source by the host's C++
compiler at first use (``_build.HOST``), never at import. There is no
fallback: where it cannot be built, every converter and ``FrameRing`` raise
with the compiler's output. The plain numpy version beside each converter
is the reference the tests hold it against; no writer calls it.

The converters take HWC frames; ``threads`` = 0 lets the library choose
(about one thread per MB of frame, at most the host's cores). ctypes
releases the interpreter lock during each call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from drba_tpu_torch import _build


def load() -> ctypes.CDLL:
    """The built library (building it at the first call); raises on failure."""
    return _build.HOST.load()


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _check_frame(frame: np.ndarray, dtype) -> np.ndarray:
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) frame, got shape {frame.shape}")
    if frame.dtype != dtype:
        raise TypeError(f"expected a {np.dtype(dtype)} frame, got {frame.dtype}")
    return np.ascontiguousarray(frame)


def bgr8_to_rgbf32(frame: np.ndarray, threads: int = 0) -> np.ndarray:
    """HWC BGR uint8 -> HWC RGB float32 in [0, 1] (times 1/255)."""
    lib = load()
    frame = _check_frame(frame, np.uint8)
    h, w = frame.shape[:2]
    out = np.empty((h, w, 3), np.float32)
    lib.drba_bgr8_to_rgbf32(frame.ctypes.data, out.ctypes.data, h, w, threads)
    return out


def bgr8_to_rgbf32_plain(frame: np.ndarray) -> np.ndarray:
    return frame[:, :, ::-1].astype(np.float32) / 255.0


def bgr8_to_rgb8(frame: np.ndarray, out: np.ndarray | None = None,
                 threads: int = 0) -> np.ndarray:
    """HWC BGR uint8 -> RGB uint8 channel flip into ``out`` (allocated when
    None; the writers pass a buffer they reuse), which it returns."""
    lib = load()
    frame = _check_frame(frame, np.uint8)
    h, w = frame.shape[:2]
    if out is None:
        out = np.empty((h, w, 3), np.uint8)
    elif (out.shape != frame.shape or out.dtype != np.uint8 or not out.flags.c_contiguous
          or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous uint8 array of shape {frame.shape}, "
                         f"got {out.dtype} {out.shape}")
    lib.drba_bgr8_to_rgb8(frame.ctypes.data, out.ctypes.data, h, w, threads)
    return out


def bgr8_to_rgb8_plain(frame: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    if out is None:
        out = np.empty(frame.shape, np.uint8)
    np.copyto(out, frame[:, :, ::-1])
    return out


def rgbf32_to_bgr8(frame: np.ndarray, threads: int = 0) -> np.ndarray:
    """HWC RGB float32 -> HWC BGR uint8: clipped to [0, 1], times 255,
    truncated (the reference's ``(x * 255).astype(uint8)``)."""
    lib = load()
    frame = _check_frame(np.asarray(frame, np.float32), np.float32)
    h, w = frame.shape[:2]
    out = np.empty((h, w, 3), np.uint8)
    lib.drba_rgbf32_to_bgr8(frame.ctypes.data, out.ctypes.data, h, w, threads)
    return out


def rgbf32_to_bgr8_plain(frame: np.ndarray) -> np.ndarray:
    return (np.clip(frame[:, :, ::-1], 0, 1) * 255.0).astype(np.uint8)


class FrameRing:
    """Lock-free single-producer / single-consumer ring of ``capacity``
    (rounded up to a power of two) slots of ``slot_bytes``, allocated once.

    ``push`` returns 1, or 0 when full, -1 when closed; ``pop`` the frame's
    byte count, or 0 when empty, -1 when closed and drained. A frame larger
    than a slot, or an ``out`` smaller than a slot, raises ``ValueError``.
    """

    def __init__(self, slot_bytes: int, capacity: int):
        if slot_bytes < 1 or capacity < 1:
            raise ValueError(f"slot_bytes and capacity must be >= 1, got {slot_bytes}, "
                             f"{capacity}")
        self._lib = load()
        self._ring = self._lib.drba_ring_create(slot_bytes, capacity)
        if not self._ring:
            raise MemoryError(f"cannot create a ring of {capacity} x {slot_bytes} bytes")
        self.slot_bytes = slot_bytes

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data)
        if data.nbytes > self.slot_bytes:
            raise ValueError(f"frame of {data.nbytes} bytes > slot of {self.slot_bytes}")
        return self._lib.drba_ring_push(self._ring, data.ctypes.data, data.nbytes)

    def pop(self, out: np.ndarray) -> int:
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError("out must be a writeable C-contiguous array")
        if out.nbytes < self.slot_bytes:
            raise ValueError(f"out of {out.nbytes} bytes < slot of {self.slot_bytes}")
        return int(self._lib.drba_ring_pop(self._ring, out.ctypes.data, out.nbytes))

    def close(self) -> None:
        """No push succeeds after this; pops drain what is queued."""
        self._lib.drba_ring_close(self._ring)

    def __len__(self) -> int:
        return int(self._lib.drba_ring_size(self._ring))

    def __del__(self):
        # the instance holds the library, so this also runs at interpreter exit
        ring, self._ring = getattr(self, "_ring", None), None
        if ring:
            self._lib.drba_ring_destroy(ring)
