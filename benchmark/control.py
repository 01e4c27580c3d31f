"""The readings that ``frame_bad_px``'s limit is set from, for one cell:

* the program's, over many seeds: a run's set-up, a short window at the
  cell's own load, the check, as ``run.py`` makes them;
* the control's, on some of those seeds: the frozen reference with every
  product's operands rounded to float8 e4m3 (one scale per tensor), the
  step below the configurations' bf16, put in the program's place for the
  same blocks and judged as the program is (``Run.judge(control=True)``);
* with ``--fault``, a fault of ``faults.FAULTS`` planted in the program:
  the readings are then the fault's.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2 --seconds 6

Prints one line per seed and a summary. The benchmark's runs do not run
this; ``tests/test_bench_faults.py`` holds the control and the faults to
``correct`` coming out false.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from benchmark import check, faults, harness  # noqa: E402


# the levels at which readings are taken, beside the check's own
LEVELS = (1, 2, 3, 4, 8)


def _row(cls, j, a, b) -> dict:
    return {"class": cls, "frame": j, "mae": check.mae(a, b),
            **{str(k): check.bad_share(a, b, k) for k in LEVELS}}


def frame_rows(run, frames: dict) -> list:
    """Per compared frame of ``frames``: its class, index, mean abs and %
    off the f32 reference at each level."""
    return [_row(run.classes[j], j, frames[j], r) for j, r in run.reference.items()]


def worst(rows) -> dict:
    return {k: max(r[str(k)] for r in rows) for k in LEVELS}


def reading(cell, seed: int, seconds: float, device, control: bool, frame_size=None,
            fault=None) -> dict:
    """One seed's program reading (and the control's, with ``control``)."""
    run = harness.Run(cell, seed, device, frame_size=frame_size, fault=fault)
    try:
        run.setup()
        run.window(seconds, False)
        run.end_to_end()
        run.free_program()
        checks = run.judge()
        out = {"seed": seed, **{k: v for k, (v, _) in checks.items()},
               "correct": all(v <= lim for v, lim in checks.values()),
               "compared": len(run.compared),
               "classes": sorted({c[0] for c in run.compared}),
               "frame_mae": max(c[2] for c in run.compared),
               "program_frames": frame_rows(run, run.source.frames_kept()),
               "bf16_reference_frames": frame_rows(run, run.bf16)}
        out["program_by_levels"] = worst(out["program_frames"])
        if control:
            frames = run.control_frames()
            ctrl = run.verdict(frames)
            out["control_frames"] = frame_rows(run, frames)
            out["control_by_levels"] = worst(out["control_frames"])
            out["control_frame_bad_px"] = ctrl["frame_bad_px"][0]
            out["control_correct"] = all(v <= lim for v, lim in ctrl.values())
    finally:
        run.cleanup()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    args = p.parse_args(argv)
    from benchmark import cells

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for s in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rows.append(reading(cell, s, args.seconds, "cuda:0", s in control,
                            fault=faults.FAULTS.get(args.fault)))
        rows[-1]["secs"] = time.perf_counter() - t0
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    prog = [r["frame_bad_px"] for r in rows]
    summary = {"workload": args.workload, "fault": args.fault, "frame_bad_px": prog,
               "copy_bad_px": [r["copy_bad_px"] for r in rows],
               "correct": [r["correct"] for r in rows],
               "control_frame_bad_px": [r["control_frame_bad_px"] for r in rows
                                        if "control_frame_bad_px" in r],
               "control_correct": [r["control_correct"] for r in rows if "control_correct" in r]}
    for k in LEVELS:
        summary[f"program_max_over_{k}"] = max(r["program_by_levels"][k] for r in rows)
        ctrl = [r["control_by_levels"][k] for r in rows if "control_by_levels" in r]
        summary[f"control_min_over_{k}"] = min(ctrl) if ctrl else None
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
