"""Batch interpolation over a folder of clips (counterpart of scripts/demo.py,
the reference Colab notebook's workflow): times-mode interpolation of every
video in a folder, one ``drba_tpu_torch.cli.main`` run per clip.

Usage:
  python -m drba_tpu_torch.demo --input_dir clips/ --output_dir out/ -m rife -t 2 \\
      [-s] [-st 0.3] [-scale 1.0] [--weights weights] [--device cuda|cpu]

Each ``clip.ext`` (.mp4, .mkv, .mov, .avi, .webm) is written as
``clip_{times}x.mp4`` in ``--output_dir``. The models run on the CUDA card
unless ``--device`` asks for another device.
"""

from __future__ import annotations

import argparse
import os

VIDEO_EXTS = {".mp4", ".mkv", ".mov", ".avi", ".webm"}


def main(argv=None) -> list:
    """Interpolate every clip of ``--input_dir``; returns the CLI's stats per clip."""
    ap = argparse.ArgumentParser(description="Batch DRBA interpolation over a folder")
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("-m", "--model_type", default="rife")
    ap.add_argument("-t", "--times", type=int, default=2)
    ap.add_argument("-s", "--enable_scdet", action="store_true", default=False)
    ap.add_argument("-st", "--scdet_threshold", type=float, default=0.3)
    ap.add_argument("-scale", "--scale", type=float, default=1.0)
    ap.add_argument("--weights", default="weights")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a CUDA device)")
    args = ap.parse_args(argv)

    from drba_tpu_torch.cli import main as cli_main

    os.makedirs(args.output_dir, exist_ok=True)
    clips = sorted(f for f in os.listdir(args.input_dir)
                   if os.path.splitext(f)[1].lower() in VIDEO_EXTS)
    if not clips:
        print(f"no videos found in {args.input_dir}")
        return []

    stats = []
    for i, name in enumerate(clips, 1):
        src = os.path.join(args.input_dir, name)
        dst = os.path.join(args.output_dir, f"{os.path.splitext(name)[0]}_{args.times}x.mp4")
        print(f"[{i}/{len(clips)}] {src} -> {dst}")
        stats.append(cli_main(
            ["-m", args.model_type, "-i", src, "-o", dst, "-t", str(args.times),
             "-scale", str(args.scale), "--weights", args.weights, "--device", args.device]
            + (["-s", "-st", str(args.scdet_threshold)] if args.enable_scdet else [])))
    return stats


if __name__ == "__main__":
    main()
