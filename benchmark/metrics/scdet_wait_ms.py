"""Scene detection: host ms a body window waited for its frame's scene
score (the program's ``scdet`` stage, per body window)."""


def read(t):
    total = t.stages.get("scdet")
    return None if total is None or not t.windows else total[0] / t.windows * 1e3
