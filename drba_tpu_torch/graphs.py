"""One dispatch per window on the card: the fused window as a CUDA graph
(counterpart of ``_drba_window_fused``, drba_tpu/models/rife.py:157-179,
gmfss.py:69-84 and gmfss_union.py:87-104, which compile a window's next
reuse pass and all its T timesteps into one XLA program).

``inference_ts_drba`` of RIFE, GMFSS and GMFSS_UNION on a CUDA device runs
each window through :func:`run_window`. Per model instance a cache holds
one captured window per (T, frame shape, dtype, ``linear``, device), and,
where ``linear`` is False, per timestep values, since the bisection
schedule is host control flow: what ``jax.jit`` keeps per static
signature. At 24 -> 60 fps that is two graphs per model (T = 2 and 3).

An entry's first call copies the inputs into its static buffers, runs the
window once eagerly on a side stream and returns that run's frames (the
warm-up: it builds the kernels and fills the one-time caches that may not
run under capture: shared-memory attributes, the tensor-map entry point,
the label and constant caches, the cuBLAS and cuDNN handles), then captures
the window (the model's ``_fused_window``: its ``next_reuse`` and its
timesteps) on the same stream into a graph. A model's graphs share one
memory pool: they replay one at a time, in the caller's stream order, and
each replay's outputs are copied out before the next can reuse the
memory; at 1080p a float32 GMFSS window's capture alone reserves tens of
GB, so two pools of their own would not fit beside the eager chain start.
``Entry.pool_bytes`` is what an entry's capture added to the device's
reserved memory. Each later call copies the inputs in (the timesteps from a pinned ring),
replays, and copies the frames and the next reuse out into fresh tensors,
which outlive the next replay; a reuse tensor that is one of the window's
inputs passed through is handed back as the caller's own.

The graph keeps the static buffers' addresses (the conv's TMA tensor maps
are encoded once, at capture, against them): a replay never runs on other
tensors. A capture or a replay that fails raises; nothing falls back to the
eager window. ``_build.counts()`` stays the launches the card ran: a
capture's launches are recorded, not counted, and each replay adds them.

The CPU never captures: there the models run their eager window, and
:func:`timesteps` makes a plain tensor.
"""

from __future__ import annotations

import contextlib
import itertools
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from drba_tpu_torch import _build
from drba_tpu_torch.parallel.batch import _leaves, _map


def host_timesteps(ts) -> np.ndarray:
    """A window's timesteps as host float32 values. A tensor on the card is
    refused (numpy raises), so nothing reads the card back."""
    return np.asarray(ts, dtype=np.float32).reshape(-1)


class PinnedRing:
    """Pinned host slots through which timesteps go up to the card by
    non-blocking copies. A slot is written again only after the event
    recorded behind its last copy has passed, so the host never overwrites
    values a copy has not read; with ``slots`` copies in flight that wait
    means the host runs that many windows ahead."""

    def __init__(self, slots: int = 8, width: int = 16):
        self._bufs = torch.empty(slots, width, dtype=torch.float32, pin_memory=True)
        self._events = [torch.cuda.Event() for _ in range(slots)]
        self._next = 0

    def upload(self, values: np.ndarray, out: torch.Tensor) -> torch.Tensor:
        """Copy ``values`` into the (T,) float32 CUDA tensor ``out`` on its
        device's current stream; returns ``out``."""
        n = values.shape[0]
        if n > self._bufs.shape[1]:
            for e in self._events:
                e.synchronize()
            self._bufs = torch.empty(len(self._events), n, dtype=torch.float32, pin_memory=True)
        i = self._next
        self._next = (i + 1) % len(self._events)
        self._events[i].synchronize()  # returns at once unless the slot's copy is pending
        slot = self._bufs[i, :n]
        slot.numpy()[:] = values
        out.copy_(slot, non_blocking=True)
        self._events[i].record(torch.cuda.current_stream(out.device))
        return out


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` captured on the given stream into the
    given memory pool. The capture is ``thread_local``: the frame loop's
    other threads (uploads, downloads) may call the runtime meanwhile."""

    def __init__(self):
        self._graph = torch.cuda.CUDAGraph()

    def capture(self, fn, stream, pool):
        with torch.cuda.graph(self._graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self) -> None:
        self._graph.replay()


@dataclass
class Entry:
    """One captured window: static inputs (I0, I1, I2, the reuse's tensors)
    and timesteps, the graph, its static outputs (the (T, N, H, W, 3) frames
    and the next reuse), the launches its capture recorded, the bytes its
    capture reserved, and its replays so far."""

    graph: object
    inputs: list
    ts: torch.Tensor
    out: torch.Tensor
    nxt: object
    launches: dict
    pool_bytes: int
    replays: int = 0

    def load(self, inputs: list) -> None:
        """Copy the call's inputs into the static buffers (current stream)."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"the window takes {len(self.inputs)} tensors, got {len(inputs)}")
        for dst, src in zip(self.inputs, inputs):
            if src.shape != dst.shape or src.dtype != dst.dtype or src.device != dst.device:
                raise ValueError(f"window input {tuple(src.shape)} {src.dtype} on {src.device} "
                                 f"differs from the captured {tuple(dst.shape)} {dst.dtype} on "
                                 f"{dst.device}")
            dst.copy_(src)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()
            and a.dtype == b.dtype)


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _hand_out(out, nxt, statics: list, inputs: list, copy: bool):
    """(frames, next reuse) for the caller: a tensor that is a static input
    is handed back as the caller's input; every other tensor is copied where
    ``copy`` (a replay's static outputs) or where it shares a static
    input's memory, else handed out as it is (the warm-up's own)."""
    stream = torch.cuda.current_stream(out.device) if out.is_cuda and not copy else None

    def take(t):
        for s, x in zip(statics, inputs):
            if _same(t, s):
                return x
        if copy or any(_shares(t, s) for s in statics):
            return t.clone()
        if stream is not None:  # made on the side stream, read on this one
            t.record_stream(stream)
        return t

    return list(take(out).unbind(0)), _map(take, nxt)


class WindowGraphs:
    """The captured windows of one model instance and its timestep ring;
    used by one thread at a time, as the model is."""

    def __init__(self, model, graph_factory=CudaGraph):
        self.owner = weakref.ref(model)
        self.entries: dict = {}
        self.graph_factory = graph_factory
        self._ring = None
        self._side = None
        self._pool = None

    def pool(self):
        """The memory pool all of the model's graphs capture into, made at
        first use."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def upload(self, values: np.ndarray, out: torch.Tensor) -> torch.Tensor:
        if self._ring is None:
            self._ring = PinnedRing()
        return self._ring.upload(values, out)

    @contextlib.contextmanager
    def _on_side(self, device: torch.device):
        """The side stream current, ordered after and before the caller's
        stream (nothing on the CPU)."""
        if device.type != "cuda":
            yield None
            return
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        cur = torch.cuda.current_stream(device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            yield self._side
        cur.wait_stream(self._side)

    def run(self, fused, I0, I1, I2, ts, reuse, linear: bool):
        """The window (I0, I1, I2) at timesteps ``ts`` on the chain's
        ``reuse`` -> (frames, next reuse), through the entry's graph.
        ``fused(I0, I1, I2, ts, ts_host, reuse, linear)`` is the model's
        eager window -> ((T, N, H, W, 3) frames, next reuse)."""
        host = host_timesteps(ts)
        key = (len(host), tuple(I1.shape), I1.dtype, bool(linear), I1.device)
        if not linear:
            key += (tuple(host.tolist()),)
        inputs = [I0, I1, I2, *_leaves(reuse)]
        entry = self.entries.get(key)
        if entry is None:
            return self._capture(key, fused, inputs, reuse, host, linear)
        entry.load(inputs)
        self._load_ts(host, entry.ts)
        entry.graph.replay()
        entry.replays += 1
        _build.add_counts(entry.launches)
        return _hand_out(entry.out, entry.nxt, entry.inputs, inputs, copy=True)

    def _load_ts(self, host: np.ndarray, ts: torch.Tensor) -> None:
        if ts.is_cuda:
            self.upload(host, ts)
        else:
            ts.copy_(torch.from_numpy(host))

    def _capture(self, key, fused, inputs, reuse, host, linear):
        device = inputs[1].device
        statics = [x.clone() for x in inputs]
        ts = torch.empty(len(host), dtype=torch.float32, device=device)
        self._load_ts(host, ts)
        counter = itertools.count(3)
        s_reuse = _map(lambda _: statics[next(counter)], reuse)

        def window():
            return fused(statics[0], statics[1], statics[2], ts, host, s_reuse, linear)

        graph = self.graph_factory()
        with self._on_side(device) as side:
            warm_out, warm_nxt = window()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(device) if device.type == "cuda" else 0
            try:
                with _build.recording() as launches:
                    out, nxt = graph.capture(window, side,
                                             self.pool() if device.type == "cuda" else None)
            except Exception as e:
                raise RuntimeError(f"capturing the window (T, shape, dtype, linear, device) = "
                                   f"{key[:5]} failed") from e
            pool = (torch.cuda.memory_reserved(device) - before) if device.type == "cuda" else 0
        self.entries[key] = Entry(graph, statics, ts, out, nxt, dict(launches), pool)
        return _hand_out(warm_out, warm_nxt, statics, inputs, copy=False)


def state(model) -> WindowGraphs:
    """``model``'s own captured windows and timestep ring, made at first
    use. A shallow copy of the model (the planner's replicas) gets its own."""
    st = model.__dict__.get("_window_graphs")
    if st is None or st.owner() is not model:
        st = model._window_graphs = WindowGraphs(model)
    return st


def timesteps(model, ts) -> torch.Tensor:
    """``ts`` (host values) as a (T,) float32 tensor on ``model.device``; on
    a CUDA device through the model's pinned ring, without a host sync."""
    host = host_timesteps(ts)
    if model.device.type != "cuda":
        return torch.from_numpy(host.copy())
    out = torch.empty(host.shape[0], dtype=torch.float32, device=model.device)
    return state(model).upload(host, out)


def run_window(model, I0, I1, I2, ts, reuse, linear: bool):
    """``model``'s steady-state window (a reuse given, ``ts`` not empty) on
    its CUDA device, through its captured graph -> (frames, next reuse)."""
    return state(model).run(model._fused_window, I0, I1, I2, ts, reuse, linear)
