"""Model: mean device ms of a chained DRM window (``inference_ts_drba`` on
the chain's reuse), CUDA events around each call on the caller's stream."""

from benchmark.trace import mean


def read(t):
    return mean(t.window_device_ms)
