"""Build and load the hand-written CUDA kernels (and the writers' host
library); count the kernels' launches.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs at
a kernel's first launch, never at import, into ``drba_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so a
fresh checkout builds from its own sources alone. ``csrc/host.cpp``, the
video writers' frame converters and frame ring (``utils/native.py``), is
built the same way by the host's C++ compiler (:class:`HostLibrary`).

Every C entry returns ``cudaGetLastError()`` after its launch and
:meth:`Kernel.launch` raises if it is not 0. There is no fallback: a missing
``nvcc``, a failed build or a failed launch raises. Each launch runs with
its tensors' device current (:meth:`Kernel.launch`'s ``device``).

The counts (:func:`counts`) are launches the card ran: a launch made while
a CUDA graph captures (inside :func:`recording` on that thread) is recorded
apart and not counted, and each replay of the graph adds what its capture
recorded (:func:`add_counts`; ``graphs.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype code for ``t`` (csrc/common.cuh:DType)."""
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") from None


def use_kernel(backend: str, t: torch.Tensor) -> bool:
    """Resolve an ``auto | torch | cuda`` backend for tensor ``t``.

    ``auto`` picks the kernel exactly when ``t`` lies on a CUDA device;
    ``cuda`` on a CPU tensor raises.
    """
    if backend == "torch":
        return False
    if backend == "auto":
        return t.is_cuda
    if backend == "cuda":
        if not t.is_cuda:
            raise ValueError(f"backend='cuda' needs a CUDA tensor, got one on {t.device}")
        return True
    raise ValueError(f"unknown backend {backend!r}; valid: auto, torch, cuda")


def check_cuda_input(name: str, t: torch.Tensor, dtypes=(torch.float32, torch.bfloat16),
                     ndim: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of an accepted dtype."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _source_hash(source: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class Kernel:
    """One kernel of a ``csrc`` source: its C entries, lazy build and launch count.

    ``entries`` maps each C entry of the kernel to its ctypes argtypes; the
    first is the default of :meth:`launch`. Several kernels may share a
    source (one library). ``launches`` counts successful launches through
    :meth:`launch` only, over all entries; the count is exact when several
    threads launch (the multi-device planner's dispatch threads). A launch
    inside :func:`recording` goes to that thread's record instead.
    """

    def __init__(self, name: str, source: str, entries: dict):
        self.name = name
        self.source = source
        self.entries = dict(entries)
        self.launches = 0
        self.build_log = ""
        self._fns: dict = {}
        self._lock = threading.Lock()

    @property
    def source_path(self) -> str:
        """Path of the source relative to the repository root."""
        return f"drba_tpu_torch/csrc/{self.source}"

    def library_path(self) -> Path:
        return BUILD_DIR / f"{Path(self.source).stem}-{_source_hash(self.source)}.so"

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists."""
        return _compile([find_nvcc(), *NVCC_FLAGS], self.source, self.library_path())

    def load(self) -> None:
        """Build (if needed) and load the library and the C entries; with a
        recorder active, as a ``build`` span (``utils/profiling.py``)."""
        with self._lock:
            if not self._fns:
                from drba_tpu_torch.utils import profiling  # the package imports this module

                tr = profiling.active()
                with tr.span("build", kernel=self.name) if tr is not None else profiling.NULL:
                    lib = ctypes.CDLL(str(self.build()))
                self.build_log = _BUILD_LOGS.get(self.source, "")
                for entry, argtypes in self.entries.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    self._fns[entry] = fn

    def launch(self, *args, device: torch.device, entry: str | None = None) -> None:
        """Call a C entry (which launches on the given stream) on ``device``,
        the CUDA device of the call's tensors, and count it.

        The entry runs with ``device`` current, so that its launch and the
        ``cudaGetDevice`` it sizes its grid by see the tensors' device; the
        switch is skipped when that device is already current.
        """
        self.load()
        fn = self._fns[entry or next(iter(self.entries))]
        if device.type != "cuda":
            raise ValueError(f"{self.name}: kernels launch on a CUDA device, got {device}")
        if device.index is None or device.index == torch.cuda.current_device():
            rc = fn(*args)
        else:
            with torch.cuda.device(device.index):
                rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {rc}")
        record = getattr(_RECORDING, "record", None)
        if record is not None:
            record[self.name] += 1
            return
        with self._lock:
            self.launches += 1


_BUILD_LOCKS: dict = {}
_BUILD_LOGS: dict = {}
_RECORDING = threading.local()


def _compile(compiler: list, source: str, out: Path) -> Path:
    """Compile ``csrc/<source>`` with ``compiler`` (the command and its flags)
    into ``out`` unless it exists: into a temporary name first, then renamed,
    so that processes building the same library at once each load a whole
    file. A failed build raises with the compiler's output."""
    with _BUILD_LOCKS.setdefault(source, threading.Lock()):
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [*compiler, "-o", str(tmp), str(CSRC / source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {compiler[0]} to build {source}: {e}") from e
        _BUILD_LOGS[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler[0]} failed for {source} (rc {proc.returncode}):\n"
                               f"{_BUILD_LOGS[source]}")
        os.replace(tmp, out)
        return out


SPLAT = Kernel("splat", "splat.cu", {
    # ten, flow, metric, acc; n, h, w, c, mode; 3 dtypes; stream
    "drba_splat_scatter": [_P] * 4 + [_I] * 8 + [_P],
    # acc, out, cov; pixels; c, denom, dtype; stream
    "drba_splat_normalise": [_P] * 3 + [_L] + [_I] * 3 + [_P],
})
# WarpArgs (ops/warp_cuda.py); image and flow dtypes; stream
WARP = Kernel("warp", "warp.cu", {"drba_warp": [_P, _I, _I, _P]})
# AssembleArgs (ops/block_input.py); dtype; stream
BLOCK_INPUT = Kernel("block_input", "block_input.cu", {"drba_block_input": [_P, _I, _P]})
# OutputArgs (ops/block_output.py); dtype; stream
BLOCK_OUTPUT = Kernel("block_output", "block_output.cu", {"drba_block_output": [_P, _I, _P]})
# x, w (OIHW), packed w, bias, beta, alpha, res, out; n, h, w, cin, cout, dtype, path; stream
CONV = Kernel("conv_chain", "conv_chain.cu", {"drba_conv3x3": [_P] * 8 + [_I] * 7 + [_P]})
# q, k, v, out, labels; b, h, w, kk; 4 token strides; 2 label strides; half; dtype; stream
WINDOW = Kernel("window_attention", "attention.cu",
                {"drba_window_attention": [_P] * 5 + [_I] * 12 + [_P]})
FLASH = Kernel("flash_attention", "attention.cu", {
    # q, k, v, out, labels; b, L; dtype; partials, key splits; stream
    "drba_flash_attention": [_P] * 5 + [_I] * 3 + [_P, _I, _P],
    # partials, out; rows, key splits; stream
    "drba_flash_combine": [_P, _P, _I, _I, _P],
})
LAYER = Kernel("transformer_layer", "attn_layer.cu", {
    # x, target, packed wqkv, qkv; tokens; dtype; stream
    "drba_layer_proj": [_P] * 4 + [_L, _I, _P],
    # x, av, packed wmerge, g1, b1, packed ffn, g2, b2, out; hidden, tokens, dtype; stream
    "drba_layer_tail": [_P] * 9 + [_I, _L, _I, _P],
})
KERNELS = (SPLAT, WARP, CONV, WINDOW, FLASH, LAYER, BLOCK_INPUT, BLOCK_OUTPUT)

HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")


def find_cxx() -> str:
    """The host's C++ compiler: ``$CXX``, else ``c++``."""
    cxx = os.environ.get("CXX") or "c++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX or put c++ on PATH); "
                           "the host library cannot be built")
    return path


class HostLibrary:
    """A ``csrc`` host (CPU) source built by the C++ compiler into a shared
    library with a plain C interface, loaded with ``ctypes``.

    Built at first :meth:`load`, never at import, into ``BUILD_DIR``, named
    by a hash of the source, the compiler and ``HOST_FLAGS``. ``entries``
    maps each C entry to ``(restype, argtypes)``. No fallback: a missing
    compiler or a failed build raises.
    """

    def __init__(self, source: str, entries: dict):
        self.source = source
        self.entries = dict(entries)
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self, cxx: str) -> Path:
        h = hashlib.sha256((CSRC / self.source).read_bytes())
        h.update(" ".join((cxx, *HOST_FLAGS)).encode())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; returns it."""
        with self._lock:
            if self._lib is None:
                cxx = find_cxx()
                lib = ctypes.CDLL(str(_compile([cxx, *HOST_FLAGS], self.source,
                                               self.library_path(cxx))))
                for entry, (restype, argtypes) in self.entries.items():
                    fn = getattr(lib, entry)
                    fn.restype = restype
                    fn.argtypes = argtypes
                self._lib = lib
            return self._lib


# the writers' host runtime (utils/native.py): src, dst, h, w, threads for
# each converter; the SPSC frame ring
_CONVERT = (None, [_P, _P, _L, _L, _I])
HOST = HostLibrary("host.cpp", {
    "drba_bgr8_to_rgbf32": _CONVERT,
    "drba_bgr8_to_rgb8": _CONVERT,
    "drba_rgbf32_to_bgr8": _CONVERT,
    "drba_ring_create": (_P, [_L, _L]),        # slot bytes, capacity
    "drba_ring_destroy": (None, [_P]),
    "drba_ring_push": (_I, [_P, _P, _L]),      # ring, data, bytes
    "drba_ring_pop": (_L, [_P, _P, _L]),       # ring, out, out's bytes
    "drba_ring_close": (None, [_P]),
    "drba_ring_size": (_L, [_P]),
})


def build_all() -> dict:
    """Build every kernel's source at once, one ``nvcc`` per source in
    parallel, then load each; returns seconds per source."""
    import concurrent.futures
    import time

    def one(k):
        t0 = time.perf_counter()
        k.build()
        return k.source, time.perf_counter() - t0

    first = {k.source: k for k in KERNELS}
    with concurrent.futures.ThreadPoolExecutor(len(first)) as ex:
        secs = dict(ex.map(one, first.values()))
    for k in KERNELS:
        k.load()
    return secs


def reset_counts() -> None:
    for k in KERNELS:
        with k._lock:
            k.launches = 0


def counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


@contextlib.contextmanager
def recording():
    """Launches on this thread inside the block go to the yielded Counter
    (kernel name -> launches) instead of the counts: a CUDA graph's capture
    records its kernels without running them."""
    outer = getattr(_RECORDING, "record", None)
    _RECORDING.record = record = Counter()
    try:
        yield record
    finally:
        _RECORDING.record = outer


def add_counts(record: dict) -> None:
    """Count the launches of ``record`` (a graph replay runs what its
    capture recorded)."""
    for k in KERNELS:
        if record.get(k.name):
            with k._lock:
                k.launches += record[k.name]


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
