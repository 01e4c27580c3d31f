"""Whole step: model FLOPs of every call the window made (counted on the
frozen reference at the cell's shapes, ``work.py``) over the window's
seconds and the H100's 989 TFLOP/s dense bf16, in %."""

from benchmark.work import PEAK_BF16_FLOPS


def read(t):
    flops = sum(t.work[(c.kind, c.T)].flops for c in t.calls)
    return None if flops <= 0 or t.window_s <= 0 else flops / t.window_s / PEAK_BF16_FLOPS * 100.0
