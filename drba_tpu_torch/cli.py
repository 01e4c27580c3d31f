"""CLI driver of the port, flag-compatible with the reference (infer.py:18-36).

Usage:
  python -m drba_tpu_torch.cli -m rife|gmfss|gmfss_union -i in.mp4 -o out.mp4 \\
      -fps 60 [-t N] [-s] [-st 0.3] [-hw] [-scale 1.0] [--fp32] [--exact-drm] \\
      [--device cuda|cuda:N|cpu] [--devices N] [--splat-backend auto|torch|cuda] \\
      [--profile] [--seg-frames N [--resume]]

The models run on the CUDA card; without one, or given a card index PyTorch
does not see, the CLI raises before it builds a model, unless it is given
``--device cpu``. ``--devices N`` above the cards PyTorch sees raises before
a model is built; with ``--device cpu`` it runs N CPU replicas.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from drba_tpu_torch.config import BACKENDS, Config, full_f32_products, model_device
from drba_tpu_torch.parallel.mesh import make_devices
from drba_tpu_torch.pipeline import run_pipeline
from drba_tpu_torch.utils import get_valid_net_inp_size, profiling
from drba_tpu_torch.utils.log import get_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Interpolate a video with DRBA (PyTorch/CUDA)")
    p.add_argument("-m", "--model_type", dest="model_type", default="rife",
                   help="model network type: rife, gmfss or gmfss_union")
    p.add_argument("-i", "--input", dest="input", default="input.mp4",
                   help="path of the input video")
    p.add_argument("-o", "--output", dest="output", default="output.mp4",
                   help="path of the output video")
    p.add_argument("-fps", "--dst_fps", dest="dst_fps", type=float, default=60,
                   help="interpolate to this fps")
    p.add_argument("-t", "--times", dest="times", type=int, default=-1,
                   help="interpolate to N x source fps")
    p.add_argument("-s", "--enable_scdet", dest="enable_scdet", action="store_true",
                   help="enable scene change detection")
    p.add_argument("-st", "--scdet_threshold", dest="scdet_threshold", type=float,
                   default=0.3, help="ssim scene detection threshold")
    p.add_argument("-hw", "--hwaccel", dest="hwaccel", action="store_true",
                   help="hardware encode: ffmpeg's first hardware h264 encoder (nvenc, "
                        "videotoolbox, vaapi), else libx264")
    p.add_argument("-scale", "--scale", dest="scale", type=float, default=1.0,
                   help="flow scale: 1.0 at 1080p, 0.5 at 4K")
    p.add_argument("--weights", dest="weights", default="weights",
                   help="weights root directory (train_log_* subdirs)")
    p.add_argument("--fp32", dest="fp32", action="store_true",
                   help="compute in float32 instead of bfloat16 (cuDNN and matmuls in full "
                        "f32, TF32 off)")
    p.add_argument("--exact-drm", dest="exact_drm", action="store_true",
                   help="DRM alignment splats at full resolution (default: half)")
    p.add_argument("--strict", dest="strict", action="store_true",
                   help="fail when a weight file is absent or its keys do not match")
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device (default: cuda; raises without a CUDA device)")
    p.add_argument("--devices", dest="devices", type=int, default=1,
                   help="spread the windows over the first N devices of --device's type, "
                        "one model replica, dispatch thread and stream each, the reuse chain "
                        "handed from device to device (parallel/batch.py); 1: the serial loop")
    p.add_argument("--splat-backend", dest="splat_backend", default="auto", choices=BACKENDS,
                   help="forward splat: auto (the CUDA kernel on a CUDA tensor), torch (the "
                        "plain version), cuda (the kernel, raising on the CPU)")
    p.add_argument("--profile", dest="profile", action="store_true",
                   help="print wall-clock timings per pipeline stage, per span of the frame "
                        "loop's threads and the model's load and calls, and the graph counters "
                        "at the end")
    p.add_argument("--seg-frames", dest="seg_frames", type=int, default=0,
                   help="write the output in crash-safe segments of N frames, concatenated "
                        "(with the source's audio) at the end; enables --resume")
    p.add_argument("--resume", dest="resume", action="store_true",
                   help="resume an interrupted segmented run: the output frames of its "
                        "completed segments are not computed again (needs --seg-frames)")
    return p.parse_args(argv)


# model type -> (module, class, weights subdirectory), as infer.py:39-55
_MODELS = {"rife": ("rife", "RIFE", "train_log_rife_426_heavy"),
           "gmfss": ("gmfss", "GMFSS", "train_log_gmfss"),
           "gmfss_union": ("gmfss_union", "GMFSS_UNION", "train_log_gmfss_union")}


def load_model(model_type: str, weights_root: str, scale: float, config: Config, device,
               frame=None):
    """Build the model of ``model_type``; random seeded weights where its
    weights directory is absent. With a recorder active, a ``load`` span
    (the weights read, converted, cast and packed) naming the model and its
    flow ``scale`` and, for a GMFSS model given the source ``frame`` size
    (h, w), ``flow_px``: GMFlow's input height x width, so that a trace
    says which flow path ran."""
    import importlib

    module, cls, sub = _MODELS[model_type]
    wdir = os.path.join(weights_root, sub)
    tr = profiling.active()
    with (tr.span("load", model=model_type, scale=scale) if tr is not None
          else profiling.NULL) as span:
        model_cls = getattr(importlib.import_module(f"drba_tpu_torch.models.{module}"), cls)
        model = model_cls(weights=wdir if os.path.isdir(wdir) else None, scale=scale,
                          config=config, device=device)
        if span is not None and frame is not None and model_type != "rife":
            span.attrs["flow_px"] = flow_px(model, frame)
        return model


def flow_px(model, frame) -> str:
    """GMFlow's input for source frames of ``frame`` (h, w): the network
    size halved, then scaled by the flow scale (``gmfss_core.gmfss_reuse``),
    as ``"<height>x<width>"``."""
    net = get_valid_net_inp_size(np.empty((*frame, 0), np.uint8), model.scale,
                                 div=model.pad_size)["dst_size"]
    half = [int(d * 0.5) for d in net]
    if model.scale != 1.0:
        half = [int(d * model.scale) for d in half]
    return "x".join(map(str, half))


def _frame_size(path: str) -> tuple:
    """The video's frame size (h, w) as its container states it."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    finally:
        cap.release()


def main(argv=None):
    args = parse_args(argv)
    # --profile: one recorder over the model's load and the run
    with profiling.tracer() if args.profile else profiling.NULL:
        return _main(args)


def _main(args):
    if args.model_type not in _MODELS:
        raise ValueError(f"model_type must be one of {', '.join(_MODELS)}, "
                         f"got {args.model_type!r}")
    device = model_device(args.device)
    devices = make_devices(args.devices, device) if args.devices != 1 else [device]
    if args.resume and args.seg_frames <= 0:
        raise ValueError("--resume requires --seg-frames N (segmented output)")
    if not os.path.exists(args.input):
        raise FileNotFoundError(f"can't find the video file {args.input}")

    from tqdm import tqdm

    log = get_logger("drba_tpu_torch.cli")
    full_f32_products()  # --fp32: cuDNN's convolutions in f32, not TF32
    config = Config(compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
                    flow_scale=args.scale, scdet_threshold=args.scdet_threshold,
                    drm_splat_scale=1.0 if args.exact_drm else 0.5,
                    splat_backend=args.splat_backend, strict_load=args.strict)
    model = load_model(args.model_type, args.weights, args.scale, config, devices[0],
                       frame=_frame_size(args.input))

    skip_outputs = 0
    if args.seg_frames > 0:
        from drba_tpu_torch.utils.segmented_io import SegmentedVideoIO

        video_io = SegmentedVideoIO(args.input, args.output, dst_fps=args.dst_fps,
                                    times=args.times, hwaccel=args.hwaccel,
                                    seg_frames=args.seg_frames)
        if args.resume:
            skip_outputs = video_io.completed_frames
            log.info("resuming after %d completed output frames", skip_outputs)
    else:
        from drba_tpu_torch.utils.video_io import VideoFI_IO

        video_io = VideoFI_IO(args.input, args.output, dst_fps=args.dst_fps, times=args.times,
                              hwaccel=args.hwaccel)
    pbar = tqdm(total=video_io.total_frames_count)
    if len(devices) > 1 and args.resume:
        log.info("--resume runs the serial loop")
    elif len(devices) > 1 and args.profile:
        log.info("--profile reports the serial loop only: no stage report with --devices > 1")
    if len(devices) > 1 and not args.resume:
        from drba_tpu_torch.parallel.pipeline import run_pipeline_parallel

        stats = run_pipeline_parallel(model, video_io, devices, progress=pbar.update,
                                      times=args.times, enable_scdet=args.enable_scdet,
                                      scdet_threshold=args.scdet_threshold)
    else:
        stats = run_pipeline(model, video_io, progress=pbar.update, times=args.times,
                             enable_scdet=args.enable_scdet,
                             scdet_threshold=args.scdet_threshold, profile=args.profile,
                             skip_outputs=skip_outputs)
    pbar.close()
    print(f"done: {stats.frames_in} frames in, {stats.frames_out} frames out, "
          f"{stats.windows} windows, {stats.scene_cuts} scene cuts, {stats.wall_s:.2f}s")
    if stats.stage_report:
        print(stats.stage_report)
    return stats


if __name__ == "__main__":
    main()
