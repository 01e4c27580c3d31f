#!/usr/bin/env python3
"""Window fps of the port's kernel path in a given checkout, so that two
trees can be timed in turns on one card.

    python3 scripts/torch_window_fps.py <tree> [rife] [gmfss] [gmfss_union]

``<tree>`` is the root of a checkout: this repository's, or another commit's
unpacked with ``git archive``. Its own ``drba_tpu_torch`` and
``chip_smoke.py`` (``make_model``, ``synthetic_frames``, ``timed``) are used.
For each model: a seed-0 bf16 model on the card, three synthetic 1080p
frames at the model's padded size, the reuse chained; ``inference_ts_drba``
at T = 2 and T = 3 (24 -> 60 alternates them), 5 calls each on CUDA events,
twice in turns; prints the window ms and the fps over a T=2+3 pair beside
the card's name and power limit, and a digest (SHA-256) of one T=3
window's frames: equal digests are bitwise equal outputs. Compare two trees
by running them as parent, change, change, parent, one after another on
one card.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    names = sys.argv[2:] or ["rife", "gmfss"]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from drba_tpu_torch import _build
    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper, get_valid_net_inp_size, to_inp

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    _build.build_all()
    dev = torch.device("cuda", 0)
    frames = cs.synthetic_frames(3)
    tmap = TMapper(cs.SRC_FPS, cs.DST_FPS)
    ts2, ts3 = calc_ts(1, tmap, -1), calc_ts(0, tmap, -1)
    for name in names:
        m = cs.make_model(name, dev)
        size = get_valid_net_inp_size(frames[0], m.scale, div=m.pad_size)["dst_size"]
        I0, I1, I2 = (to_inp(f, size, m.config.compute_dtype, dev) for f in frames)
        reuse = m.reuse(I1, I0)
        times = {2: [], 3: []}
        for _ in range(2):
            for ts in (ts2, ts3):
                times[len(ts)].append(cs.timed(
                    lambda: m.inference_ts_drba(I0, I1, I2, ts, reuse, linear=True), 5))
        t2, t3 = (sum(times[n]) / 2 for n in (2, 3))
        out = torch.stack(m.inference_ts_drba(I0, I1, I2, ts3, reuse, linear=True)[0])
        digest = hashlib.sha256(out.contiguous().view(torch.int16).cpu().numpy().tobytes())
        print(f"{root}: {name} window bf16 1080p kernel path: T=2 {t2:.2f} ms, T=3 {t3:.2f} ms, "
              f"{5e3 / (t2 + t3):.2f} fps, T=3 frames sha256 {digest.hexdigest()[:16]}  "
              f"[{gpu}]", flush=True)
        del m
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
