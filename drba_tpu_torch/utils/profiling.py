"""Stage timers and a device trace (counterpart of drba_tpu/utils/profiling.py).

* ``StageTimes``: host wall-clock per pipeline stage (``window``,
  ``emit-wait``, ``prefetch-wait``, ``scdet``, ``finish``), reported at the
  end of a run. Kernels launch asynchronously, so ``window`` measures the
  host's dispatch plus any waits inside it, which is what the frame loop
  experiences. On a CUDA device every model call replays a captured graph
  once its key is warm (``graphs.py``): the steady-state windows, and the
  windows beside a scene cut, the chain starts, the head and the tail
  (their ``plain`` calls and passes), so there ``window`` is the host time
  of the copies in and out and of the replays' launches; each key's eager
  first calls and its capture (the first window of each T; the second call
  of a plain call or a pass) add their own.
* ``device_trace``: ``torch.profiler`` over a block, written as a Chrome
  trace (``chrome://tracing`` or Perfetto) into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimes:
    total: dict = field(default_factory=lambda: defaultdict(float))
    count: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> str:
        lines = ["stage timings:"]
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            t, c = self.total[name], self.count[name]
            lines.append(f"  {name:<16} {t:8.3f}s total  {t / max(c, 1) * 1e3:8.2f}ms avg  x{c}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the host and, where there is a CUDA device, the card over the
    block with ``torch.profiler``; writes ``<logdir>/trace.json`` (Chrome
    trace format) and yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
