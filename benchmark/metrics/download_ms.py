"""Frame loop: mean host ms of a download thread's ``download`` span per
output frame of the measured window (``to_out``: resize, quantise and the
copy to the host, any wait for the card included; the
``download/download`` report line)."""


def read(t):
    total = t.stages.get("download/download")
    return None if total is None or not total[1] else total[0] / total[1] * 1e3
