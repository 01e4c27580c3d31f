"""Kernels: the backward-warp kernel's share of its roofline, in %: the
least time for the bytes of every warp of the calls made in the profiled
span (frozen reference, ``work.py``) over the device time of the program's
warp kernels there."""

from benchmark.metrics_common import roofline


def read(t):
    return roofline(t, "warp", r"(?:^|[^A-Za-z0-9_])warp_(?:narrow_)?kernel\b")
