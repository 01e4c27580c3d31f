"""Frame loop: host ms a body window waited for its next uploaded frame
(the program's ``prefetch-wait`` stage, per body window)."""


def read(t):
    total = t.stages.get("prefetch-wait")
    return None if total is None or not t.windows else total[0] / t.windows * 1e3
