"""Frame loop: mean host ms the prefetch thread was blocked handing a
frame to the full queue (its ``put-wait`` span, the ``prefetch/put-wait``
report line), per frame of the measured window. Near 0 while
``prefetch_wait_ms`` is high: the producer sets the loop's pace."""


def read(t):
    total = t.stages.get("prefetch/put-wait")
    return None if total is None or not total[1] else total[0] / total[1] * 1e3
