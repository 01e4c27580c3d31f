"""What a ``--trace 1`` run records, from the benchmark's side of the
program's calls, and what the per-layer metrics read.

* :class:`Recorder` stands in for the model that ``run_pipeline`` drives:
  every model call (a DRM window, plain interpolation) goes through it, and
  it records the call's kind and T, its host time (``perf_counter``) and,
  for a chained DRM window, CUDA events around it on the caller's stream;
  each call is a labelled range for the profiler.
* :func:`profiled_pipeline` runs a short second window under
  ``torch.profiler`` after the measured one, so that the profiler's own
  cost (starting, recording, collecting) stays out of the measured window.
* :class:`Trace` holds the run's stage times (the program's ``StageTimes``
  report, parsed), the calls, the work of each call kind on the frozen
  reference (``work.py``), and the profiled device activity.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

# the program's stage report lines (utils/profiling.StageTimes.report)
_STAGE = re.compile(r"^\s+(\S+)\s+([0-9.]+)s total\s+([0-9.]+)ms avg\s+x(\d+)", re.MULTILINE)


def parse_stages(report: str | None) -> dict:
    """{stage: (total seconds, count)} from a stage report."""
    return {m.group(1): (float(m.group(2)), int(m.group(4))) for m in _STAGE.finditer(report or "")}


@dataclass
class Call:
    kind: str  # window | window_start | plain | plain_pass
    T: int
    host_s: float
    events: tuple | None  # CUDA (start, end) events of a chained window


@dataclass
class Trace:
    stages: dict = field(default_factory=dict)
    windows: int = 0
    window_s: float = 0.0
    calls: list = field(default_factory=list)  # the measured window's
    profiled_calls: list = field(default_factory=list)  # the profiled window's
    work: dict = field(default_factory=dict)  # (kind, T) -> work.CallWork
    kernels: list = field(default_factory=list)  # (name, start_s, dur_s): the profiled window's
    span_s: float = 0.0  # the profiled window's steady span: first to last model call
    busy_s: float = 0.0  # device busy seconds in that span
    window_device_ms: list = field(default_factory=list)
    latency_ms: list = field(default_factory=list)  # every written frame's, in order


class Recorder:
    """``model`` with its calls recorded."""

    def __init__(self, model, union: bool):
        self._model = model
        self._union = union
        self.calls: list = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    # ----------------------------------------------------------------------------- calls

    def _call(self, kind: str, T: int, fn, *args, **kwargs):
        events = None
        if kind == "window" and self._model.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{kind}.T{T}"):
            out = fn(*args, **kwargs)
        host = time.perf_counter() - t0
        if events is not None:
            events[1].record()
        self.calls.append(Call(kind, T, host, events))
        return out

    def inference_ts_drba(self, I0, I1, I2, ts, reuse=None, linear=False):
        kind = "window" if reuse is not None else "window_start"
        return self._call(kind, len(ts), self._model.inference_ts_drba, I0, I1, I2, ts, reuse,
                          linear=linear)

    def inference_ts(self, I0, I1, ts, reuse=None, return_reuse=False):
        if len(ts) == 0:
            return self._model.inference_ts(I0, I1, ts, reuse, return_reuse)
        kind = "plain_pass" if self._union and reuse is None else "plain"
        return self._call(kind, len(ts), self._model.inference_ts, I0, I1, ts, reuse,
                          return_reuse)


def _device(e) -> bool:
    """A device operation (kernel, copy, fill), not a labelled range."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
            and not e.name().startswith("bench."))


def profiled_pipeline(run_window, model, union: bool, device) -> tuple:
    """``run_window(model)`` under ``torch.profiler`` with ``model``'s calls
    recorded -> (events, calls, span): the span runs from the first model
    call's start to the last one's, on the trace's clock (ns)."""
    from torch.profiler import ProfilerActivity, profile

    rec = Recorder(model, union)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = profile(activities=activities)
    prof.start()
    run_window(rec)
    if device.type == "cuda":
        torch.cuda.synchronize()
    prof.stop()
    events = prof.profiler.kineto_results.events()
    starts = sorted(e.start_ns() for e in events
                    if e.device_type() == torch.autograd.DeviceType.CPU
                    and e.name().startswith("bench."))
    return events, rec.calls, (starts[0], starts[-1]) if len(starts) > 1 else None


def device_activity(events, span) -> tuple:
    """(busy seconds, idle gaps [(start ns, end ns)]) of the device
    operations inside ``span`` (ns)."""
    lo, hi = span
    dev = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                  if _device(e) and e.start_ns() < hi and e.start_ns() + e.duration_ns() > lo),
                 key=lambda x: x[0])
    busy, gaps, cur = 0, [], lo
    for s, e, _ in dev:
        s, e = max(s, lo), min(e, hi)
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy * 1e-9, gaps


def kernels(events) -> list:
    """(name, start s, duration s) of every device operation traced."""
    dev = [e for e in events if _device(e)]
    t0 = min((e.start_ns() for e in dev), default=0)
    return [(e.name(), (e.start_ns() - t0) * 1e-9, e.duration_ns() * 1e-9) for e in dev]


def host_label(events, t_ns: int) -> str:
    """What the host's main thread was doing at ``t_ns``: its innermost
    benchmark label or operation then."""
    best = None
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        s = e.start_ns()
        if s <= t_ns < s + e.duration_ns() and (best is None or s >= best.start_ns()):
            best = e
    if best is None:
        return "host: no traced call (frame loop waiting)"
    return f"host: {best.name()}"


def breakdown(events, span, gaps, top: int = 10) -> dict:
    """The device operations that took most time in ``span``, and its
    longest idle gaps by what the host was doing."""
    lo, hi = span
    by_name: dict = {}
    for name, _, dur in ((e.name(), 0, e.duration_ns() * 1e-9) for e in events
                         if _device(e) and lo <= e.start_ns() < hi):
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [[host_label(events, (a + b) // 2), (b - a) * 1e-9] for a, b in longest]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": idle}


def window_device_ms(calls) -> list:
    """Device ms of each chained DRM window (synchronises)."""
    out = [c.events for c in calls if c.events is not None]
    if out:
        torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in out]


def mean(xs) -> float | None:
    return float(np.mean(xs)) if len(xs) else None
