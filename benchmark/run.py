"""The benchmark of ``drba_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the card(s) the cell
asks for (``BENCHMARK.json``). Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted`` (output frames planned for the
frames read), ``failed`` (of those, not written), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, which also end standard error. Exits non-zero, printing
no result, without the cards, or if JAX or ``drba_tpu`` was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"  # no library may bring JAX in


def fixed_malloc() -> None:
    """Fix glibc malloc's thresholds before the run allocates: freed blocks
    of up to 32 MiB (a downloaded 1080p frame is 6 MiB) stay in the heap for
    reuse, where by default the threshold moves with the run's history and a
    frame's block may be mapped and unmapped anew, page faults and all."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(-3, 32 << 20)  # M_MMAP_THRESHOLD
    libc.mallopt(-1, (1 << 31) - 1)  # M_TRIM_THRESHOLD


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    fixed_malloc()
    import torch

    from benchmark import cells, harness

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, "cuda:0")
    try:
        run.setup()
        setup_s = time.perf_counter() - T_START
        run.window(args.seconds, bool(args.trace))
        e2e = run.end_to_end()
        if args.trace:
            metrics, extra, bd = run.per_layer()
        else:
            e2e["setup_s"] = {"value": setup_s, "unit": "s"}
            metrics = {m["name"]: e2e[cells.quantity(m["name"])] for m in cell.end_to_end}
            extra, bd = {}, None
        planned = run.blocks[-1].first_output + len(run.blocks[-1].ts)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                  "memory_peak_bytes": run.memory_peak, **extra,
                  "power": harness.power_limit()}
        run.free_program()
        torch.cuda.reset_peak_memory_stats(run.device)
        t_judge = time.perf_counter()
        checks = run.judge()
        t_judge = time.perf_counter() - t_judge
        judge_peak = torch.cuda.max_memory_allocated(run.device)
    finally:
        run.cleanup()
    found = harness.forbidden_modules()
    if found:
        print(f"refused: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    correct = all(v <= lim for v, lim in checks.values())
    levels = cell.config["frame_bad_levels"]
    for cls, j, e, bad, bad16 in run.compared:
        print(f"frame {j} ({cls}): mean abs {e:.4f} levels, {bad:.6f}% more than {levels} "
              f"levels off (the bf16 reference: {bad16:.6f}%)", file=sys.stderr)
    print(f"frames/s by 5 s of the window: {run.fps_by_chunk()}", file=sys.stderr)
    print(f"the reference's check took {t_judge:.1f} s, its device memory peaked at "
          f"{judge_peak} bytes", file=sys.stderr)
    if run.window_captures:
        print("warning: the window captured a CUDA graph set-up had not", file=sys.stderr)
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    result = {"correct": correct, "attempted": planned,
              "failed": max(0, planned - run.stats.frames_out), "metrics": metrics,
              "device": device}
    if bd is not None:
        result["breakdown"] = bd
    result["window_captures"] = run.window_captures
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
