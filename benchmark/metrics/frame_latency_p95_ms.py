"""Frame loop: the 95th percentile, over every frame the measured window
wrote, of the ms from the source handing out the newest input the frame's
block reads (head: input 1; window i: input i + 2; tail: the last input)
to the frame reaching the sink. In the closed loop the queues' depth
decides it, and it swings from run to run; a live cell's tail would be
an end-to-end metric."""

import numpy as np


def read(t):
    return float(np.percentile(t.latency_ms, 95)) if len(t.latency_ms) else None
