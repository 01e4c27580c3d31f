"""One run of a cell: set-up, the measured window, the check, the result.

Set-up (counted in ``setup_s``): the seeded weights, written as the
reference checkpoints' tree under ``TMPDIR`` and loaded by the program's
``cli.load_model`` with ``strict_load`` (so a missing file fails instead of
falling back to the program's own initialiser); the stream's reel of
frames, made on the device and kept in host memory; and a warm-up
``run_pipeline`` over a short clip of the cell's own traffic whose cuts
make every call the window makes capture its CUDA graph.

The window: one ``run_pipeline`` call over the endless stream, which stops
handing out frames ``seconds`` after the call; the drain is inside the
window. With ``trace`` the model goes through :class:`trace.Recorder` and the
program's stage report is on; after it a window of ``PROFILE_SPAN_S``
seconds runs under ``torch.profiler`` (its output is not judged).

Then the device's peak memory is read, the program's state freed, and the
frozen reference judges the output (``check.py``).
"""

from __future__ import annotations

import gc
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import cells, check, plan, stream, trace, work
from benchmark.reference import models, scene, weights
from benchmark.reference.nn import products

FORBIDDEN = ("jax", "jaxlib", "flax", "drba_tpu")
# the compared numbers' limits (PERF.md gives the readings they were set from)
LIMITS = {"frames_off_plan": 0, "cuts_off_reference": 0, "copy_bad_px": 5.0}
PROFILE_SPAN_S = 3.0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unknown"


class Run:
    """A cell's run on ``device``; ``frame_size`` replaces the configuration's
    frame size (the CPU tests); ``fault``, one of ``faults.FAULTS``, is
    planted in the program after it is built."""

    def __init__(self, cell: cells.Cell, seed: int, device, frame_size=None, fault=None):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cfg, self.traffic = cell.config, cell.traffic
        self.src_size = tuple(frame_size or self.cfg["frame"])
        self.union = self.cfg["model_type"] == "gmfss_union"
        self.fault = fault
        self.unplant = None
        self.tmp = None
        self.recorder = None

    # ------------------------------------------------------------------------------ set-up

    def setup(self) -> None:
        from drba_tpu_torch.cli import load_model
        from drba_tpu_torch.config import Config, full_f32_products

        cfg, traffic = self.cfg, self.traffic
        specs = models.specs(cfg["model_type"])
        self.params = weights.draw(specs, self.seed, self.device, cfg["init_gain"])
        self.tmp = tempfile.mkdtemp(prefix="drba-bench-")
        weights.write_tree(self.tmp, cfg["weights_dir"], models.files(cfg["model_type"]), specs,
                           self.params)
        full_f32_products()  # as the CLI does before it builds a model
        config = Config(flow_scale=cfg["scale"], drm_splat_scale=cfg["drm_splat_scale"],
                        scdet_threshold=traffic["scdet_threshold"], strict_load=True)
        if str(config.compute_dtype).replace("torch.", "") != cfg["dtype"]:
            raise ValueError(f"the program computes in {config.compute_dtype}, the "
                             f"configuration states {cfg['dtype']}")
        self.model = load_model(cfg["model_type"], self.tmp, cfg["scale"], config, self.device)
        if self.model.pad_size != cfg["pad"]:
            raise ValueError(f"the program pads to {self.model.pad_size}, the configuration "
                             f"states {cfg['pad']}")
        if self.fault is not None:
            self.unplant = self.fault(self.model)
        h, w = self.src_size
        self.size = scene.net_size(h, w, cfg["scale"], cfg["pad"])
        self.reel = stream.Reel(traffic, stream.shot_lengths(traffic, self.seed), h, w,
                                self.seed, self.device)
        warm = stream.Reel(traffic, traffic["warmup_shot_frames"], h, w, self.seed + 1,
                           self.device)
        self._pipeline(self.model, stream.Source(warm, traffic, limit=len(warm)))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.captured = self._graph_state()

    def _pipeline(self, model, source, profile=False):
        from drba_tpu_torch.pipeline import run_pipeline

        return run_pipeline(model, source, times=-1,
                            enable_scdet=bool(self.traffic["scene_detection"]),
                            scdet_threshold=float(self.traffic["scdet_threshold"]),
                            profile=profile)

    def _graph_state(self) -> tuple:
        from drba_tpu_torch import graphs

        st = graphs.state(self.model)
        return tuple(sorted(map(str, st.entries))), sum(st.calls.values())

    # ------------------------------------------------------------------------------ window

    def window(self, seconds: float, traced: bool) -> None:
        """The measured window; with ``traced``, the calls recorded and the
        stage report on, then a short profiled window after it."""
        self.sampler = check.Sampler(self.seed, self.reel, self.traffic)
        src = self.source = stream.Source(self.reel, self.traffic, keep=self.sampler.keep)
        model = self.model
        if traced:
            model = self.recorder = trace.Recorder(self.model, self.union)
        self.t0 = src.start(seconds)
        self.stats = self._pipeline(model, src, profile=traced)
        self.t1 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))
        else:
            self.memory_peak = 0
        if traced:
            def profiled(rec):
                src_b = stream.Source(self.reel, self.traffic)
                src_b.start(PROFILE_SPAN_S)
                self._pipeline(rec, src_b)

            self.profiled = trace.profiled_pipeline(profiled, self.model, self.union,
                                                    self.device)
        self.window_captures = self._graph_state() != self.captured

    def end_to_end(self) -> dict:
        src, stats = self.source, self.stats
        n = len(src.read_at)
        blocks = plan.blocks(n, self.reel.cuts(n), src.src_fps, src.dst_fps, self.union)
        read_at = np.asarray(src.read_at)
        written = np.asarray(src.written_at)
        newest = np.concatenate([np.full(len(b.ts), b.newest) for b in blocks])
        m = min(len(written), len(newest))
        self.latency_ms = (written[:m] - read_at[newest[:m]]) * 1e3
        self.blocks = blocks
        return {"out_fps": {"value": stats.frames_out / (self.t1 - self.t0), "unit": "frames/s"}}

    def fps_by_chunk(self, chunk: float = 5.0) -> list:
        """Frames written in each ``chunk`` seconds of the window, per second."""
        t = np.asarray(self.source.written_at) - self.t0
        n = int(np.ceil((self.t1 - self.t0) / chunk))
        return [round(float(((t >= i * chunk) & (t < (i + 1) * chunk)).sum() / chunk), 2)
                for i in range(n)]

    # ------------------------------------------------------------------------------- trace

    def per_layer(self) -> tuple:
        """(metrics, device extras, breakdown) of a traced run."""
        rec, cfg = self.recorder, self.cfg
        t = trace.Trace(stages=trace.parse_stages(self.stats.stage_report),
                        windows=self.stats.windows, window_s=self.t1 - self.t0, calls=rec.calls,
                        latency_ms=list(self.latency_ms))
        t.window_device_ms = trace.window_device_ms(rec.calls)
        lengths = sorted({c.T for c in rec.calls + self.profiled[1]
                          if c.kind.startswith("window")} | {2})
        t.work = work.work_table(cfg, self.size, lengths)
        events, t.profiled_calls, span = self.profiled
        t.kernels = trace.kernels(events)
        extra, bd = {}, None
        if span is not None:
            t.busy_s, gaps = trace.device_activity(events, span)
            t.span_s = (span[1] - span[0]) * 1e-9
            extra = {"busy_s": t.busy_s, "window_s": t.span_s}
            bd = trace.breakdown(events, span, gaps)
        metrics = {}
        for m in self.cell.per_layer:
            value = cells.metric_reader(m["name"], self.cell.root)(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        return metrics, extra, bd

    # ------------------------------------------------------------------------------- check

    def free_program(self) -> None:
        self.model = None
        self.recorder = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, control: bool = False) -> dict:
        """{check: (number, limit)}. With ``control`` the control's frames
        take the program's place where frames are compared."""
        self.references()
        return self.verdict(self.control_frames() if control else self.source.frames_kept())

    def references(self) -> None:
        """What the reference says: its cuts, its f32 and bf16 frames of the
        blocks compared, and the copies' check on the prints."""
        n = len(self.source.read_at)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.ref_cuts = check.reference_cuts(self.reel, n, self.size,
                                             self.traffic["scdet_threshold"], self.device)
        self.copy_bad = check.copy_bad_px(self.blocks, self.source.prints, self.reel, self.size,
                                          self.src_size, self.cfg["frame_bad_levels"],
                                          self.device)
        self.judged_blocks = check.choose(self.blocks, self.source.frames_kept(), self.seed)
        f32 = check.block_frames(models.Reference(self.cfg, self.params), self.judged_blocks,
                                 self.reel, self.size, self.src_size, self.device)
        bf16 = check.block_frames(check.in_bf16(self.cfg, self.params), self.judged_blocks,
                                  self.reel, self.size, self.src_size, self.device,
                                  torch.bfloat16)
        self.reference = {j: r for _, j, r in f32}
        self.classes = {j: cls for cls, j, _ in f32}
        self.bf16 = {j: r for _, j, r in bf16}

    def control_frames(self) -> dict:
        """The control's frames of the blocks compared: the reference with
        every product's operands rounded to float8 e4m3, the step below the
        configurations' bf16."""
        with products("fp8"):
            out = check.block_frames(models.Reference(self.cfg, self.params),
                                     self.judged_blocks, self.reel, self.size, self.src_size,
                                     self.device)
        return {j: r for _, j, r in out}

    def verdict(self, frames: dict) -> dict:
        """The checks with ``frames`` (output index -> uint8 frame) as the
        compared frames."""
        stats, src, blocks = self.stats, self.source, self.blocks
        n = len(src.read_at)
        planned = blocks[-1].first_output + len(blocks[-1].ts)
        off_plan = (abs(stats.frames_out - planned) + abs(stats.frames_in - n)
                    + abs(stats.windows - (n - 2)) + abs(len(src.written_at) - stats.frames_out))
        levels = self.cfg["frame_bad_levels"]
        self.compared = [(self.classes[j], j, check.mae(frames[j], r),
                          check.bad_share(frames[j], r, levels),
                          check.bad_share(self.bf16[j], r, levels))
                         for j, r in self.reference.items()]
        excess = max(c[3] - c[4] for c in self.compared)
        return {"frames_off_plan": (off_plan, LIMITS["frames_off_plan"]),
                "cuts_off_reference": (abs(stats.scene_cuts - self.ref_cuts),
                                       LIMITS["cuts_off_reference"]),
                "copy_bad_px": (self.copy_bad, LIMITS["copy_bad_px"]),
                "frame_bad_px": (excess, self.cfg["frame_bad_px_limit"])}

    def cleanup(self) -> None:
        if self.unplant is not None:
            self.unplant()
            self.unplant = None
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
