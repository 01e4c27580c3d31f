"""Kernels: the softsplat kernels' share of their roofline, in %: the least
time for the bytes of every softsplat of the calls made in the profiled
span (counted on the frozen reference, ``work.py``) over the device time of
the program's splat kernels there."""

from benchmark.metrics_common import roofline


def read(t):
    return roofline(t, "splat", r"(?:^|[^A-Za-z0-9_])splat_(?:scatter|normalise)")
