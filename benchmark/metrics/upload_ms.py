"""Frame loop: mean host ms of the prefetch thread's ``upload`` span per
frame of the measured window: the frame's upload, its scene score, the
score's copy and the event (the program's ``prefetch/upload`` report line;
None where the program reports no such line)."""


def read(t):
    total = t.stages.get("prefetch/upload")
    return None if total is None or not total[1] else total[0] / total[1] * 1e3
