"""Device: the share of the profiled span, in %, in which no operation ran
on the card (1 - the union of device activity over the span)."""


def read(t):
    return None if t.span_s <= 0 else (1.0 - t.busy_s / t.span_s) * 100.0
