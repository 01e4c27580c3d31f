"""Frame loop: host ms a block waited to hand its frames to the download
pool (the program's ``emit-wait`` stage, per body window)."""


def read(t):
    total = t.stages.get("emit-wait")
    return None if total is None or not t.windows else total[0] / t.windows * 1e3
