"""Model-call graphs: mean host ms per model call of any kind (chained and
chain-start DRM windows, plain interpolation), ``perf_counter``."""

from benchmark.trace import mean


def read(t):
    v = mean([c.host_s for c in t.calls])
    return None if v is None else v * 1e3
