"""Arithmetic that several per-layer metric readers share."""

from __future__ import annotations

import re

from benchmark.work import Work, bound_s


def roofline(t, part: str, kernel_pattern: str):
    """100 x the least time for ``part``'s work (``splat`` or ``warp``) of
    the calls of the profiled window, over the device time of the kernels
    whose names match ``kernel_pattern`` there; None where none ran."""
    pat = re.compile(kernel_pattern)
    device_s = sum(d for name, _, d in t.kernels if pat.search(name))
    calls = t.profiled_calls
    if device_s <= 0 or not calls:
        return None
    least = bound_s(sum((getattr(t.work[(c.kind, c.T)], part) for c in calls), Work()))
    return least / device_s * 100.0
