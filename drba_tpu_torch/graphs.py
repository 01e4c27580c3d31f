"""One dispatch per model call on the card: drba_tpu's four jitted programs
as CUDA graphs. This module is the capture cache; which call runs through
which kind, and its eager body, are the models' (``models/base.py``).
The kinds and their counterparts, each one XLA program per call:

* ``window``: the fused window ``_drba_window_fused`` (drba_tpu/models/
  rife.py:157-179, gmfss.py:69-84, gmfss_union.py:87-104), a window's next
  reuse pass and all its T timesteps (``inference_ts_drba``);
* ``plain``: the plain batch ``_ts_batch`` behind ``inference_ts``
  (rife.py:182-205, gmfss.py:87-102, gmfss_union.py:108-111); on GMFSS and
  GMFSS_UNION on a given reuse;
* ``pass``: the flow/reuse pass (``_flow_jit``, rife.py:207-208;
  ``_reuse_jit``, gmfss.py:118-122, gmfss_union.py:152-156) behind
  ``reuse`` and ``next_reuse``: the chain starts, the planner's per-replica
  passes, resume's recomputed pass;
* ``unfused``: the window's timesteps apart from its pass, ``_drba_window``
  (rife.py:103-108, gmfss.py:35-37, gmfss_union.py:37-42), behind
  ``drba_window``: the planner's replicas run it.

Per model instance a cache holds one captured graph per kind and static
signature, what ``jax.jit`` keeps per static signature: the frame shape,
dtype and device; for ``window``, ``plain`` and ``unfused`` the number of
timesteps T (their values are data, compared on the device); for ``window``
and ``unfused`` ``linear`` and, where it is False, the timestep values,
since the bisection schedule is host control flow; for ``pass`` which of
its optional features are given. At 24 -> 60 fps that is two window
graphs per model (T = 2 and 3).

When an entry is captured. A ``window`` key's first call copies the inputs
into its static buffers, runs the call once eagerly on a side stream and
returns that run's outputs (the warm-up: it builds the kernels and fills
the one-time caches that may not run under capture: shared-memory
attributes, the tensor-map entry point, the label and constant caches, the
cuBLAS and cuDNN handles), then captures the call on the same stream into
a graph. A key of the other kinds runs its first call eagerly and captures
nothing, since the head and the tail are one-off calls and a clip with no
cuts must not pay for captures it never replays; its second call does
what a window's first does. Every later call copies the inputs in (the
timesteps from a pinned ring, without a host sync), replays, and copies
the outputs out into fresh tensors, which outlive the next replay; a
tensor that is one of the call's inputs passed through is handed back as
the caller's own.

A model's graphs share one memory pool: they replay one at a time, in the
caller's stream order, and each replay's outputs are copied out before the
next can reuse the memory; at 1080p a float32 GMFSS window's capture alone
reserves GBs, so pools of their own would not fit beside each other.
``Entry.pool_bytes`` is what an entry's capture added to the device's
reserved memory. The graph keeps the static buffers' addresses (the conv's
TMA tensor maps are encoded once, at capture, against them): a replay
never runs on other tensors. A capture or a replay that fails raises;
nothing falls back to the eager call. Captures run one at a time in the
process, whatever thread asks (the planner's replicas capture on their
dispatch threads): another thread's synchronise would break one in
flight. ``_build.counts()`` stays the launches the card ran: a capture's
launches are recorded, not counted, and each replay adds them.

With a recorder active (``utils/profiling.py``) each call is a ``call``
span with its kind, T (0 for a pass) and outcome (``replay``, ``eager`` or
``capture``), counted in ``graphs.<outcome>.<kind>``; a capture adds its
seconds (the warm-up's eager run included) to ``graphs.capture_s`` and its
reserved bytes to ``graphs.pool_bytes``.

The CPU never captures: there (``on`` is False) the models run their eager
bodies.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from drba_tpu_torch import _build
from drba_tpu_torch.utils import profiling

# the call of a key that captures: the window's first (its chain replays
# from the next window on), the other kinds' second
CAPTURE_AT = {"window": 1, "plain": 2, "pass": 2, "unfused": 2}
# one capture at a time in the process: a capture's device synchronise and
# cache release on one thread break a capture in flight on another (the
# planner's replicas capture on their dispatch threads)
_CAPTURING = threading.Lock()


def _map(fn, tree):
    """``fn`` over every tensor of a reuse (tensors in tuples, NamedTuples,
    dicts; None stays None)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        vals = [_map(fn, x) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


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
    """One captured call: static inputs (the call's tensors, reuse trees
    flattened) and timesteps (None for a pass), the graph, its static
    outputs (the (T, ...) frames and the reuse, either None where the kind
    has none), the launches its capture recorded, the bytes its capture
    reserved, and its replays so far."""

    graph: object
    inputs: list
    ts: torch.Tensor | None
    out: torch.Tensor | None
    nxt: object
    launches: dict
    pool_bytes: int
    replays: int = 0

    def load(self, inputs: list, kind: str) -> None:
        """Copy the call's inputs into the static buffers (current stream)."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"the {kind} takes {len(self.inputs)} tensors, got {len(inputs)}")
        for dst, src in zip(self.inputs, inputs):
            if src.shape != dst.shape or src.dtype != dst.dtype or src.device != dst.device:
                raise ValueError(f"{kind} input {tuple(src.shape)} {src.dtype} on {src.device} "
                                 f"differs from the captured {tuple(dst.shape)} {dst.dtype} on "
                                 f"{dst.device}")
            dst.copy_(src)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()
            and a.dtype == b.dtype)


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _hand_out(out, nxt, statics: list, inputs: list, copy: bool):
    """(frames, reuse) for the caller (frames a list, or None): a tensor that
    is a static input is handed back as the caller's input; every other
    tensor is copied where ``copy`` (a replay's static outputs) or where it
    shares a static input's memory, else handed out as it is (the
    warm-up's own)."""
    device = statics[0].device
    stream = torch.cuda.current_stream(device) if device.type == "cuda" and not copy else None

    def take(t):
        for s, x in zip(statics, inputs):
            if _same(t, s):
                return x
        if copy or any(_shares(t, s) for s in statics):
            return t.clone()
        if stream is not None:  # made on the side stream, read on this one
            t.record_stream(stream)
        return t

    return (None if out is None else list(take(out).unbind(0))), _map(take, nxt)


class WindowGraphs:
    """The captured calls of one model instance, its calls per key before
    a capture, and its timestep ring; used by one thread at a time, as the
    model is."""

    def __init__(self, model, graph_factory=None):
        self.owner = weakref.ref(model)
        self.entries: dict = {}
        self.calls: Counter = Counter()
        self.graph_factory = CudaGraph if graph_factory is None else graph_factory
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

    def timesteps(self, host: np.ndarray, device: torch.device) -> torch.Tensor:
        """A fresh (T,) float32 tensor on ``device`` holding ``host``."""
        if device.type != "cuda":
            return torch.from_numpy(host.copy())
        return self.upload(host, torch.empty(host.shape[0], dtype=torch.float32, device=device))

    def call(self, kind: str, key: tuple, fn, args: tuple, host=None):
        """One call of ``kind`` under its static signature ``key`` -> (frames,
        reuse): ``fn(args, ts)`` is the eager body -> ((T, ...) frames or
        None, reuse or None); ``args`` a tuple of tensors, reuse trees and
        None; ``host`` the timesteps' host values, which reach ``fn`` as a
        (T,) float32 tensor on the inputs' device (None: the kind takes no
        timesteps)."""
        key = (kind, *key)
        tr = profiling.active()
        if tr is None:
            return self._call(kind, key, fn, args, host)
        outcome = ("replay" if key in self.entries
                   else "eager" if self.calls[key] + 1 < CAPTURE_AT[kind] else "capture")
        with tr.span("call", kind=kind, T=0 if host is None else len(host),
                     outcome=outcome) as sp:
            out = self._call(kind, key, fn, args, host)
        tr.add(f"graphs.{outcome}.{kind}")
        if outcome == "capture":
            tr.add("graphs.capture_s", sp.seconds)
            tr.add("graphs.pool_bytes", self.entries[key].pool_bytes)
        return out

    def _call(self, kind: str, key: tuple, fn, args: tuple, host):
        leaves = _leaves(args)
        entry = self.entries.get(key)
        if entry is not None:
            entry.load(leaves, kind)
            if host is not None:
                self._load_ts(host, entry.ts)
            entry.graph.replay()
            entry.replays += 1
            _build.add_counts(entry.launches)
            return _hand_out(entry.out, entry.nxt, entry.inputs, leaves, copy=True)
        self.calls[key] += 1
        if self.calls[key] < CAPTURE_AT[kind]:
            out, nxt = fn(args, None if host is None else self.timesteps(host, leaves[0].device))
            return (None if out is None else list(out.unbind(0))), nxt
        return self._capture(key, fn, args, leaves, host)

    def run(self, fused, I0, I1, I2, ts, reuse, linear: bool):
        """The window (I0, I1, I2) at timesteps ``ts`` on the chain's
        ``reuse`` -> (frames, next reuse), through the entry's graph.
        ``fused(I0, I1, I2, ts, ts_host, reuse, linear)`` is the model's
        eager window -> ((T, N, H, W, 3) frames, next reuse)."""
        host = host_timesteps(ts)
        return self.call("window", window_key(host, I1, linear),
                         lambda a, t: fused(*a[:3], t, host, a[3], linear),
                         (I0, I1, I2, reuse), host)

    def _load_ts(self, host: np.ndarray, ts: torch.Tensor) -> None:
        if ts.is_cuda:
            self.upload(host, ts)
        else:
            ts.copy_(torch.from_numpy(host))

    def _capture(self, key, fn, args, leaves, host):
        device = leaves[0].device
        statics = [x.clone() for x in leaves]
        counter = itertools.count()
        s_args = _map(lambda _: statics[next(counter)], args)
        ts = None if host is None else self.timesteps(host, device)

        def body():
            return fn(s_args, ts)

        graph = self.graph_factory()
        with _CAPTURING, self._on_side(device) as side:
            warm_out, warm_nxt = body()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(device) if device.type == "cuda" else 0
            try:
                with _build.recording() as launches:
                    out, nxt = graph.capture(body, side,
                                             self.pool() if device.type == "cuda" else None)
            except Exception as e:
                raise RuntimeError(f"capturing the {key[0]} {key[1:]} failed") from e
            pool = (torch.cuda.memory_reserved(device) - before) if device.type == "cuda" else 0
        self.entries[key] = Entry(graph, statics, ts, out, nxt, dict(launches), pool)
        return _hand_out(warm_out, warm_nxt, statics, leaves, copy=False)


def window_key(host: np.ndarray, I1: torch.Tensor, linear: bool) -> tuple:
    """(T, frame shape, dtype, linear, device), and the timestep values
    where ``linear`` is False."""
    key = (len(host), tuple(I1.shape), I1.dtype, bool(linear), I1.device)
    return key if linear else key + (tuple(host.tolist()),)


def state(model) -> WindowGraphs:
    """``model``'s own captured calls and timestep ring, made at first use.
    A shallow copy of the model (the planner's replicas) gets its own."""
    st = model.__dict__.get("_window_graphs")
    if st is None or st.owner() is not model:
        st = model._window_graphs = WindowGraphs(model)
    return st


def on(model) -> bool:
    """Whether ``model``'s calls run through its graphs: on a CUDA device."""
    return model.device.type == "cuda"

