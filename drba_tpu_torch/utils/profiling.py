"""The port's span recorder (counterpart of drba_tpu/utils/profiling.py).

``StageTimes`` records spans (named intervals of one thread) and named
counters:

* the frame loop's stages on the thread that runs ``run_pipeline``
  (``window``, ``emit-wait``, ``prefetch-wait``, ``scdet``, ``finish``), as
  before: host wall-clock, reported by :meth:`StageTimes.report` in the
  ``stage timings:`` lines. Kernels launch asynchronously, so ``window``
  measures the host's dispatch plus any waits inside it, which is what the
  frame loop experiences. On a CUDA device every model call replays a
  captured graph once its key is warm (``graphs.py``), so there ``window``
  is the host time of the copies in and out and of the replays' launches;
  each key's eager first calls and its capture add their own;
* every other span, by the thread that ran it: the prefetch thread's
  ``read`` (the decoder), ``upload`` (the upload, the scene score, its copy
  and event) and ``put-wait`` (blocked on the full queue); the download
  threads' ``download`` (``to_out``, any wait for the card included) and
  inside it ``d2h-wait`` (asleep on the frame's event, behind the work the
  stream queued before it) and ``copy-out`` (the copy out of pinned memory;
  ``imageproc.to_uint8``); the writer's ``write``; ``call``
  (``graphs.WindowGraphs.call``: kind, T and outcome ``replay``, ``eager``
  or ``capture``); ``load`` (``cli.load_model``: the model, its flow scale
  and, given the frame size, ``flow_px``, GMFlow's input height x width)
  and ``build`` (``_build.Kernel.load`` building or loading a library).
  The report gives each as ``<thread>/<span>`` in the stages' line format,
  threads named ``loop``, ``prefetch``, ``download`` (its workers
  ``download-k`` together) and ``writer``;
* counters: ``graphs.<outcome>.<kind>`` (model calls), ``graphs.capture_s``
  and ``graphs.pool_bytes`` (captures), ``prefetch.staged`` (the prefetch
  thread's frames uploaded through pinned memory), ``pinned.host_allocs``
  (pinned blocks the caching host allocator created while the frame loop
  ran, on a CUDA device), ``records.dropped``.

Aggregates are exact and thread-safe. Each span is also kept as a
:class:`Span` record, up to ``max_records`` (then counted in
``records.dropped``): its name, thread, start and end in ns, its parent
span and its attributes (a frame's index, a block's, an output's sequence
number), on ``time.time_ns``'s clock, which is the clock of
``torch.profiler``'s events.

One recorder at a time is active in the process (:func:`tracer`); the span
sites record into it and, with none active, cost one check of a module
value. While a profiler records, the spans of the thread that opened the
recorder are ``record_function`` ranges too, named ``drba.<span>`` (a
model call ``drba.call.<kind>.<outcome>``), so the trace can name them.
"""

from __future__ import annotations

import contextlib
import itertools
import re
import threading
import time
from collections import defaultdict

import torch

MAX_RECORDS = 100_000
NULL = contextlib.nullcontext()  # the span sites' context with no recorder active
_clock = time.time_ns
_ACTIVE: "StageTimes | None" = None
_WORKER = re.compile(r"-\d+$")


def active() -> "StageTimes | None":
    """The active recorder, or None."""
    return _ACTIVE


@contextlib.contextmanager
def tracer():
    """The active recorder over the block: the one already active, else a
    new one that this block opens and closes. The calling thread records as
    ``loop``."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.name_thread("loop")
        yield _ACTIVE
        return
    st = _ACTIVE = StageTimes()
    try:
        yield st
    finally:
        _ACTIVE = None


class Span:
    """One recorded span, and the context that records it."""

    __slots__ = ("name", "thread", "start_ns", "end_ns", "id", "parent", "attrs", "_st",
                 "_stage", "_range", "_keep")

    def __init__(self, st, name: str, stage: bool, attrs: dict):
        self._st, self.name, self._stage, self.attrs = st, name, stage, attrs
        self._range = None
        self._keep = True

    def discard(self) -> None:
        """Record nothing of this span (a read that found the stream's end)."""
        self._keep = False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        st = self._st
        stack = st._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(st._ids)
        stack.append(self.id)
        self.thread = st._names.get(threading.get_ident()) or threading.current_thread().name
        if self.thread == "loop" and torch._C._autograd._profiler_enabled():
            label = "drba." + ".".join([self.name, *(str(self.attrs[k]) for k in ("kind", "outcome")
                                                      if k in self.attrs)])
            self._range = torch.profiler.record_function(label)
            self._range.__enter__()
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._st._stack().pop()
        if self._keep:
            self._st._close(self)
        return False


class StageTimes:
    """Spans and counters of a run (see the module docstring). ``total`` and
    ``count`` are the stages' seconds and counts, ``spans`` every span's by
    ``<thread>/<name>``, ``records`` the :class:`Span` records."""

    def __init__(self, max_records: int = MAX_RECORDS):
        self.total: dict = defaultdict(float)
        self.count: dict = defaultdict(int)
        self.spans: dict = {}
        self.counters: dict = defaultdict(float)
        self.records: list = []
        self.max_records = max_records
        self._staged: set = set()  # the stages' ``<thread>/<name>`` keys
        self._lock = threading.Lock()
        self._local = threading.local()
        self._names = {threading.get_ident(): "loop"}
        self._ids = itertools.count(1)

    def name_thread(self, name: str) -> None:
        """Record the calling thread's spans under ``name``."""
        self._names[threading.get_ident()] = name

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def stage(self, name: str, **attrs) -> Span:
        """A frame-loop stage: a span reported on its own line."""
        return Span(self, name, True, attrs)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, False, attrs)

    def add(self, name: str, n: float = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self.counters[name] += n

    def _close(self, sp: Span) -> None:
        key = f"{_WORKER.sub('', sp.thread)}/{sp.name}"
        s = sp.seconds
        with self._lock:
            if sp._stage:
                self.total[sp.name] += s
                self.count[sp.name] += 1
                self._staged.add(key)
            agg = self.spans.get(key)
            self.spans[key] = (s, 1) if agg is None else (agg[0] + s, agg[1] + 1)
            if len(self.records) < self.max_records:
                self.records.append(sp)
            else:
                self.counters["records.dropped"] += 1

    def report(self) -> str:
        """The stages, then every other span by ``<thread>/<name>``, one line
        each (seconds, mean ms, count); then the counters."""
        lines = ["stage timings:"]
        rows = [(n, self.total[n], self.count[n]) for n in self.total]
        rows.sort(key=lambda r: -r[1])
        other = [(k, t, c) for k, (t, c) in self.spans.items() if k not in self._staged]
        other.sort(key=lambda r: -r[1])
        for name, t, c in rows + other:
            lines.append(f"  {name:<16} {t:8.3f}s total  {t / max(c, 1) * 1e3:8.2f}ms avg  x{c}")
        if self.counters:
            lines.append("counters:")
            for name in sorted(self.counters):
                v = self.counters[name]
                lines.append(f"  {name:<24} {int(v) if float(v).is_integer() else round(v, 6)}")
        return "\n".join(lines)
