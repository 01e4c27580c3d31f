"""Frame loop: mean host ms per output frame of the measured window that a
download thread waits on the frame's event, its ``d2h-wait`` span inside
``download``: the frame's resize, quantise and copy to the host, queued on
the card behind the window graphs before it (the ``download/d2h-wait``
report line; None where the program reports no such line)."""


def read(t):
    total = t.stages.get("download/d2h-wait")
    return None if total is None or not total[1] else total[0] / total[1] * 1e3
