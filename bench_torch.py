#!/usr/bin/env python3
"""Evaluation bench of the PyTorch/CUDA port (``drba_tpu_torch``): the
counterpart of ``bench.py``, through the port's public entry points, on one
NVIDIA GPU.

    python3 bench_torch.py                        # headline: RIFE 1080p 24->60
    python3 bench_torch.py --config NAME|all      # the evaluation configs
    python3 bench_torch.py --config e2e           # the CLI as its own process

The default run prints ONE JSON line: ``metric`` (RIFE 1080p 24->60
synthesized frames/s), ``value``, ``unit``, ``vs_baseline`` (value / 36,
the frames/s a 24->60 conversion must sustain to run in real time: the
reference publishes no numbers, BASELINE.md), ``device`` (the card's name
and power limit, as nvidia-smi gives them) and ``breakdown`` (the entries of
``bench_breakdown_torch.json`` measured in the last 12 h). ``--config``
measures the configs of CONFIGS and saves each entry to that file after it
is measured (``--no-save``: not at all); ``all`` leaves out the e2e configs,
which run the CLI as processes of their own. A config that fails records its
error, the sweep goes on, and the run exits non-zero at the end. There is no
fallback to other backends: a kernel that fails to build or launch fails its
config.

Window configs: synthetic frames (seed-0 noise rolled 8 px a frame), made on
the device in the compute dtype; two warm-up windows build the kernels and
capture the T = 3 and T = 2 graphs; then steady-state windows, reuse
chained, alternating ts_a = [0.5, 0.9, 1.3] and ts_b = [0.7, 1.1] (24 -> 60),
timed with CUDA events and a final synchronise; fps = frames returned /
seconds. Each entry also says whether its windows replayed a CUDA graph
(``graphed``), the graph pool's bytes, the ms of one T = 2 and one T = 3
window, the launches per kernel over the timed windows and the padded frame
size. The pan configs time ``drba_window``'s body on injected pan flows,
through a CUDA graph in the model's pool; the gate holds the default fast
path against the exact plain path at SSIM >= 0.995 (BASELINE.md).

``--device cpu``, ``--size HxW`` (the 1080p configs' frame size; uhd takes
twice it) and ``--windows N`` exist for the tests: on the CPU the numbers are
the CPU's, and each entry names its device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BREAKDOWN_PATH = os.path.join(ROOT, "bench_breakdown_torch.json")
TS_A, TS_B = (0.5, 0.9, 1.3), (0.7, 1.1)   # 24 -> 60 alternates T = 3 and T = 2
REAL_TIME_FPS = 36.0                       # synthesized frames/s of real-time 24 -> 60
GATE_SSIM = 0.995                          # BASELINE.md: min frame SSIM, fast vs exact
GATE_PANS = (8.0, 20.0, 40.0)
MODELS = {"rife": ("drba_tpu_torch.models.rife", "RIFE"),
          "gmfss": ("drba_tpu_torch.models.gmfss", "GMFSS"),
          "gmfss_union": ("drba_tpu_torch.models.gmfss_union", "GMFSS_UNION")}


@dataclass
class Settings:
    """Where and how large a run is: ``device`` (``cuda:0`` unless the
    caller asks for the CPU), ``size`` (overrides the 1080p configs' padded
    frame size, HxW) and ``windows`` (overrides each config's count of timed
    windows)."""

    device: torch.device
    size: Optional[tuple] = None
    windows: Optional[int] = None

    def n_windows(self, default: int) -> int:
        return self.windows or default


def _now_iso():
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _age_hours(measured_at):
    """Hours since an ISO-8601 UTC stamp; None if absent or unparseable."""
    if not measured_at:
        return None
    try:
        t = time.mktime(time.strptime(measured_at, "%Y-%m-%dT%H:%M:%SZ"))
    except ValueError:
        return None
    return (time.mktime(time.gmtime()) - t) / 3600.0


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the CPU."""
    if device.type != "cuda":
        return "cpu"
    idx = device.index or 0
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or f"{torch.cuda.get_device_name(idx)}, power limit unavailable"


def _seconds(device, fn):
    """(fn(), seconds it took): CUDA events and a synchronise on the card,
    the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / 1e3


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def make_model(name, device, scale=1.0, **cfg):
    """Seed-0 random-weight model ``name`` (a key of MODELS) with the default
    config (bf16, the kernels), or the given config fields, on ``device``."""
    import importlib

    from drba_tpu_torch.config import DEFAULT

    module, cls = MODELS[name]
    return getattr(importlib.import_module(module), cls)(
        weights=None, scale=scale, config=DEFAULT.replace(**cfg), device=device)


def padded_size(model, src=(1080, 1920)) -> tuple:
    """The size ``model`` runs ``src``-sized frames at (1080p: 1088x1920, or
    1152x1920 for GMFSS_UNION's pad of 128; 4K at scale 0.5: 2176x3840)."""
    from drba_tpu_torch.utils import get_valid_net_inp_size

    return tuple(get_valid_net_inp_size(np.empty((*src, 0), np.uint8), model.scale,
                                        div=model.pad_size)["dst_size"])


def _frames(h, w, device, dtype, n=4, shift=8):
    """``n`` frames (1, h, w, 3): one seed-0 noise image rolled ``shift`` px
    a frame, on ``device`` in ``dtype`` (bench.py:55-62)."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32))
    base = base.to(device, dtype)
    return [torch.roll(base, shift * i, dims=2) for i in range(n)]


def _pan_flow(h, w, dx, dy, jitter, seed, device, dtype):
    """A near-rigid pan flow (1, h, w, 2) of (dx, dy) px plus uniform jitter
    (bench.py:94-101)."""
    rng = np.random.default_rng(seed)
    f = np.broadcast_to(np.asarray([dx, dy], np.float32), (1, h, w, 2)).copy()
    f += rng.uniform(-jitter, jitter, f.shape).astype(np.float32)
    return torch.from_numpy(f).to(device, dtype)


def _make_clip(path, h, w, n_frames, fps=24, shift=6, cell=16):
    """A pan clip with cv2: seed-0 uint8 noise drawn at 1/``cell`` of the
    size, upsampled bicubically (a smooth texture at full contrast), panning
    ``shift`` px a frame. bench.py's clip pans full-resolution noise, whose
    neighbours score an SSIM near 0 at the 32x32 scene scale, so ``-s`` cuts
    every pair and the model never runs; this one's pairs score ~0.8
    (threshold 0.3)."""
    import cv2

    width = w + shift * n_frames
    small = np.random.default_rng(0).integers(0, 255, (h // cell + 1, width // cell + 1, 3),
                                              np.uint8)
    base = cv2.resize(small, (small.shape[1] * cell, small.shape[0] * cell),
                      interpolation=cv2.INTER_CUBIC)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed for {path}")
    for i in range(n_frames):
        vw.write(np.ascontiguousarray(base[:h, shift * i:shift * i + w]))
    vw.release()


def _launches():
    from drba_tpu_torch import _build

    return {k: v for k, v in _build.counts().items() if v}


def _run_windows(model, frames, n_windows):
    """Reuse-chained windows, 24 -> 60's ts pattern (bench.py:65-78): the
    chain starts with the first window's own flow pass, as bench.py's loop
    does; returns the frames returned."""
    reuse, total = None, 0
    for k in range(n_windows):
        ts = TS_A if k % 2 == 0 else TS_B
        out, reuse = model.inference_ts_drba(*frames[k % 2:k % 2 + 3], ts, reuse, linear=True)
        total += len(out)
    return total


def bench_windows(name, s: Settings, n_windows, scale=1.0, src=(1080, 1920)):
    """``inference_ts_drba`` of model ``name`` on ``src``-sized frames (padded),
    reuse chained, through its graphs on the card."""
    from drba_tpu_torch import _build, graphs

    dev = s.device
    model = make_model(name, dev, scale)
    size = padded_size(model, src) if s.size is None else \
        (int(s.size[0] / scale), int(s.size[1] / scale))
    frames = _frames(*size, dev, model.config.compute_dtype)
    for _ in range(2):  # builds the kernels, captures both window graphs and, at its
        _run_windows(model, frames, 2)  # second call, the chain start's pass graph
    n = s.n_windows(n_windows)
    _build.reset_counts()
    total, secs = _seconds(dev, lambda: _run_windows(model, frames, n))
    launches = _launches()
    reuse = model.inference_ts_drba(*frames[:3], TS_A, None, linear=True)[1]
    window_ms = {}
    for ts, fr in ((TS_B, frames[1:]), (TS_A, frames[:3])):
        _, t = _seconds(dev, lambda: [model.inference_ts_drba(*fr, ts, reuse, linear=True)
                                      for _ in range(3)])
        window_ms[f"T{len(ts)}"] = round(t / 3 * 1e3, 3)
    entries = graphs.state(model).entries.values()
    result = {"fps": round(total / secs, 3), "frames": total, "windows": n,
              "seconds": round(secs, 4), "size": list(size), "scale": scale,
              "dtype": str(model.config.compute_dtype).replace("torch.", ""),
              "graphed": any(e.replays for e in entries),
              "pool_bytes": sum(e.pool_bytes for e in entries),
              "window_ms": window_ms, "launches": launches, "device": device_line(dev)}
    del model, frames, reuse
    _free(dev)
    return result


class _Replay:
    """``fn`` (a window on fixed tensors) captured as a CUDA graph in
    ``model``'s graph pool, after one eager warm-up run; each call replays
    it and counts the launches its capture recorded."""

    def __init__(self, model, fn):
        from drba_tpu_torch import _build, graphs

        dev = model.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        self.graph = graphs.CudaGraph()
        with _build.recording() as launches:
            self.out = self.graph.capture(fn, side, graphs.state(model).pool())
        torch.cuda.current_stream(dev).wait_stream(side)
        self.launches = dict(launches)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - before

    def __call__(self):
        from drba_tpu_torch import _build

        self.graph.replay()
        _build.add_counts(self.launches)
        return self.out


def _pan_windows(model, name, frames, mag):
    """The two windows of ``bench.py``'s motion loop (frames 0-2 at ts_a,
    1-3 at ts_b) with injected pans of ``mag`` px a frame: [(I0, I1, I2,
    ts, reuse10, reuse21)]. RIFE takes the flows at full resolution; GMFSS
    and GMFSS_UNION at their reuse's half resolution, as ``mag / 2``."""
    from drba_tpu_torch.models.ifnet import ifnet_encode
    from drba_tpu_torch.models.rife import Flows

    dev, dt = model.device, model.config.compute_dtype
    if name == "rife":
        h, w = frames[0].shape[1:3]
        flow10 = _pan_flow(h, w, mag, mag * 0.3, 1.5, 0, dev, dt)
        flow12 = _pan_flow(h, w, -mag, -mag * 0.3, 1.5, 1, dev, dt)
        f = [ifnet_encode(model.params, x) for x in frames[:3]]
        return [(*frames[k:k + 3], ts, Flows(flow10, flow10, f[1], f[0]),
                 Flows(flow12, flow12, f[2 - k], f[1])) for k, ts in ((0, TS_A), (1, TS_B))]
    r10 = model.reuse(frames[1], frames[0])
    h, w = r10.flow01.shape[1:3]
    fdt = r10.flow01.dtype
    r10 = r10._replace(flow01=_pan_flow(h, w, mag / 2, mag * 0.15, 1.5, 0, dev, fdt),
                       flow10=_pan_flow(h, w, -mag / 2, -mag * 0.15, 1.5, 1, dev, fdt))
    r12 = model.reuse(frames[1], frames[2])._replace(
        flow01=_pan_flow(h, w, -mag / 2, -mag * 0.15, 1.5, 2, dev, fdt),
        flow10=_pan_flow(h, w, mag / 2, mag * 0.15, 1.5, 3, dev, fdt))
    return [(*frames[k:k + 3], ts, r10, r12.swapped()) for k, ts in ((0, TS_A), (1, TS_B))]


def bench_motion(name, mag, s: Settings, n_windows=16, eager=False):
    """The window's timesteps (``drba_window``'s body) with INJECTED pan
    flows of ``mag`` px a frame in both window sides (bench.py:104-185):
    with random weights the model's own flow does not track the frames'
    pan, and the splat's and the warp's cost moves with the flow they get.
    Each of the two windows runs through a CUDA graph in the model's pool;
    where it cannot be captured (or with ``eager``), eagerly, and the entry
    says so. pan8 is the like-for-like baseline for pan40."""
    from drba_tpu_torch import _build, graphs

    dev = s.device
    model = make_model(name, dev)
    size = padded_size(model) if s.size is None else tuple(s.size)
    frames = _frames(*size, dev, model.config.compute_dtype)
    calls, capture_error = [], None
    for I0, I1, I2, ts, r10, r21 in _pan_windows(model, name, frames, mag):
        host = graphs.host_timesteps(ts)
        tdev = model._ts(host)

        def window(a=(I0, I1, I2, tdev, host, r10, r21)):
            return model._window(*a, True)

        calls.append(window)
    graphed = dev.type == "cuda" and not eager
    if graphed:
        try:
            calls = [_Replay(model, fn) for fn in calls]
        except RuntimeError as e:  # measured eagerly instead, and said so
            graphed, capture_error = False, f"{type(e).__name__}: {e}"[:300]

    def run(n):
        for k in range(n):
            calls[k % 2]()
        return sum(len(TS_A if k % 2 == 0 else TS_B) for k in range(n))

    run(2)
    n = s.n_windows(n_windows)
    _build.reset_counts()
    total, secs = _seconds(dev, lambda: run(n))
    result = {"fps": round(total / secs, 3), "frames": total, "windows": n,
              "seconds": round(secs, 4), "pan_px": mag, "size": list(size), "graphed": graphed,
              "pool_bytes": sum(c.pool_bytes for c in calls) if graphed else 0,
              "window_ms": {}, "launches": _launches(), "device": device_line(dev)}
    for k in (1, 0):
        _, t = _seconds(dev, lambda: [calls[k]() for _ in range(3)])
        result["window_ms"][f"T{len(TS_A if k == 0 else TS_B)}"] = round(t / 3 * 1e3, 3)
    if capture_error:
        result["capture_error"] = capture_error
    del model, frames, calls
    _free(dev)
    return result


def _gate_window(model, frames, mag):
    """One T = 3 RIFE window (``drba_window``) on frames 0-2 with injected
    pans of ``mag`` px a frame -> (3, 1, H, W, 3) in float32."""
    (I0, I1, I2, ts, r10, r21), _ = _pan_windows(model, "rife", frames, mag)
    return torch.stack(model.drba_window(I0, I1, I2, ts, r10, r21, linear=True)).float()


def gate_composed(s: Settings):
    """The composed fast path against the exact path (bench.py:188-224): one
    T = 3 RIFE window at 1088x1920 with injected pans of 8, 20 and 40 px, on
    the default config (the CUDA kernels, half-resolution DRM splats, bf16)
    and on the plain path (``splat/warp/conv_backend="torch"``, full-resolution
    DRM splats), in the same dtype and in float32, from the same seeded
    parameters. Score: SSIM (``ops/ssim.ssim``, float32, L = 1) of each
    synthesized frame, the minimum over the three; both readings must reach
    GATE_SSIM at every pan (``passed``)."""
    from drba_tpu_torch.ops.ssim import ssim

    dev = s.device
    exact = dict(splat_backend="torch", warp_backend="torch", conv_backend="torch",
                 drm_splat_scale=1.0)
    paths = {"fast": {}, "exact": exact, "exact_f32": dict(exact, compute_dtype=torch.float32)}
    size = tuple(s.size or (1088, 1920))
    outs = {}
    for label, cfg in paths.items():
        model = make_model("rife", dev, **cfg)
        frames = _frames(*size, dev, model.config.compute_dtype)
        outs[label] = [_gate_window(model, frames, mag) for mag in GATE_PANS]
        del model, frames
        _free(dev)
    readings = {}
    for i, mag in enumerate(GATE_PANS):
        readings[f"pan{int(mag)}"] = {
            ref: round(min(float(ssim(outs["fast"][i][t], outs[ref][i][t], val_range=1.0))
                           for t in range(len(TS_A))), 5)
            for ref in ("exact", "exact_f32")}
    passed = all(v >= GATE_SSIM for r in readings.values() for v in r.values())
    return {"ssim": readings, "gate": GATE_SSIM, "passed": passed, "size": list(size),
            "device": device_line(dev)}


DONE = re.compile(r"done: (\d+) frames in, (\d+) frames out, (\d+) windows, (\d+) scene cuts, "
                  r"([0-9.]+)s")


def bench_e2e(name, s: Settings, n_frames=96, warm_frames=8, dst_fps=60):
    """The CLI (``python -m drba_tpu_torch.cli -m <name> -fps 60 -s
    --profile``) as a fresh process on a cv2 pan clip of ``n_frames``
    1080x1920 frames (``--size``: that size), after one run on a
    ``warm_frames`` clip that builds the kernels into the package's build
    directory. fps counts OUTPUT frames over the done line's wall
    (``run_pipeline``'s clock: decode, scene detection, windows, encode; the
    model's construction excluded). In the fresh process that wall includes
    the first windows' graph captures on the card."""
    h, w = s.size or (1080, 1920)
    with tempfile.TemporaryDirectory(prefix="drba_e2e_") as tmp:
        def cli(clip, n):
            _make_clip(os.path.join(tmp, clip), h, w, n)
            cmd = [sys.executable, "-m", "drba_tpu_torch.cli", "-m", name,
                   "-i", os.path.join(tmp, clip), "-o", os.path.join(tmp, "out_" + clip),
                   "-fps", str(dst_fps), "-s", "--profile", "--device", str(s.device)]
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=3000, cwd=ROOT)
            if r.returncode != 0:
                raise RuntimeError(f"CLI run on {clip} failed (rc {r.returncode}):\n"
                                   f"{r.stdout[-800:]}\n{r.stderr[-800:]}")
            return r

        cli("warm.mp4", warm_frames)
        r = cli("in.mp4", n_frames)
    m = DONE.search(r.stdout)
    if not m:
        raise RuntimeError(f"no done line in the CLI's output:\n{r.stdout[-800:]}")
    frames_out, wall = int(m.group(2)), float(m.group(5))
    stages = {k: float(v) for k, v in re.findall(r"^\s+(\S+)\s+([0-9.]+)s total", r.stdout,
                                                 re.MULTILINE)}
    return {"fps": round(frames_out / wall, 3), "frames_in": int(m.group(1)),
            "frames_out": frames_out, "windows": int(m.group(3)),
            "scene_cuts": int(m.group(4)), "wall_s": wall, "stages_s": stages,
            "size": [h, w], "encoder": "ffmpeg" if shutil.which("ffmpeg") else "cv2 mp4v",
            # a cut spoils the two windows around it: with more windows than
            # that, one ran uncut on the chain, and its first call per T
            # captured its graph inside the wall
            "wall_includes_graph_capture": s.device.type == "cuda" and
            int(m.group(3)) > 2 * int(m.group(4)),
            "device": device_line(s.device)}


# pan configs: (model, pan px a frame)
PANS = {"rife_pan8": ("rife", 8.0), "rife_pan40": ("rife", 40.0),
        "gmfss_pan8": ("gmfss", 8.0), "gmfss_pan40": ("gmfss", 40.0),
        "union_pan8": ("gmfss_union", 8.0), "union_pan40": ("gmfss_union", 40.0)}


def _pan(name):
    model, mag = PANS[name]
    return lambda s: bench_motion(model, mag, s)


CONFIGS = {
    # BASELINE.md evaluation configs (2)-(5), bench.py:306-335
    "rife": ("rife 1080p 24->60", lambda s: bench_windows("rife", s, 24)),
    "gmfss": ("gmfss 1080p 24->60", lambda s: bench_windows("gmfss", s, 12)),
    "gmfss_union": ("gmfss_union 1080p 24->60", lambda s: bench_windows("gmfss_union", s, 12)),
    "uhd": ("rife 4K -scale 0.5 24->60",
            lambda s: bench_windows("rife", s, 8, scale=0.5, src=(2160, 3840))),
    # window timesteps with INJECTED pan flows (bench_motion): the pan-8 rows
    # are the like-for-like baseline for the pan-40 rows
    "rife_pan8": ("rife window, injected 8px pan", _pan("rife_pan8")),
    "rife_pan40": ("rife window, injected 40px pan (high motion)", _pan("rife_pan40")),
    "gmfss_pan8": ("gmfss window, injected 8px pan", _pan("gmfss_pan8")),
    "gmfss_pan40": ("gmfss window, injected 40px pan (high motion)", _pan("gmfss_pan40")),
    "union_pan8": ("gmfss_union window, injected 8px pan", _pan("union_pan8")),
    "union_pan40": ("gmfss_union window, injected 40px pan (high motion)",
                    _pan("union_pan40")),
    "gate": ("composed fast path vs exact, min frame SSIM (>= 0.995 gate)", gate_composed),
    # the CLI as a process of its own over a generated 1080p clip
    "e2e": ("rife 1080p 24->60 FULL CLI pipeline (decode+scdet+encode)",
            lambda s: bench_e2e("rife", s)),
    "e2e_gmfss": ("gmfss 1080p 24->60 FULL CLI pipeline", lambda s: bench_e2e("gmfss", s)),
}


def run_config(name, s: Settings, fn=None):
    """Measure config ``name`` (with ``fn`` in place of its own function, if
    given) -> its entry: ``label``, ``measured_at`` and the config's
    numbers, or ``error``."""
    label, own = CONFIGS[name]
    entry = {"label": label, "measured_at": _now_iso()}
    try:
        entry.update((fn or own)(s))
    except Exception as e:  # keep sweeping: one config must not lose the rest
        import traceback

        traceback.print_exc()
        entry["error"] = f"{type(e).__name__}: {e}"[:300]
    return entry


def failed(entry) -> bool:
    return "error" in entry or entry.get("passed") is False


def _print(entry):
    if "error" in entry:
        print(f"{entry['label']}: FAILED ({entry['error']})", flush=True)
        return
    rest = {k: v for k, v in entry.items() if k not in ("label", "device")}
    print(f"{entry['label']} [{entry['device']}]: {json.dumps(rest)}", flush=True)


def _pan_sibling(name):
    """The other row of pan config ``name``'s model, or None."""
    model = PANS.get(name, (None,))[0]
    return next((o for o, (m, _) in PANS.items() if m == model and o != name), None)


def sweep(names, s: Settings, save: bool) -> list:
    """Measure ``names`` in order, saving after each; returns the failed names."""
    breakdown = {}
    if save and os.path.exists(BREAKDOWN_PATH):
        with open(BREAKDOWN_PATH) as f:
            breakdown = json.load(f)
    bad, done = [], set()
    for name in names:
        entry = breakdown[name] = run_config(name, s)
        done.add(name)
        _print(entry)
        # a pan row whose graph could not be captured: its model's other row
        # is timed eagerly too, so that the pair stays like for like
        other = _pan_sibling(name)
        if other in done and not failed(entry) and not failed(breakdown[other]) and \
                entry["graphed"] != breakdown[other]["graphed"]:
            graphed = name if entry["graphed"] else other
            model, mag = PANS[graphed]
            breakdown[graphed] = run_config(
                graphed, s, lambda s: bench_motion(model, mag, s, eager=True))
            _print(breakdown[graphed])
        if failed(entry):
            bad.append(name)
        if save:  # after every config, so that a crash keeps the finished ones
            with open(BREAKDOWN_PATH, "w") as f:
                json.dump(breakdown, f, indent=1)
    return bad


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None, choices=list(CONFIGS) + ["all"],
                    help="measure one evaluation config (or 'all': every config but the e2e "
                         "ones) and save it to bench_breakdown_torch.json")
    ap.add_argument("--no-save", action="store_true",
                    help="don't write bench_breakdown_torch.json")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; exits with an error without a card)")
    ap.add_argument("--size", default=None,
                    help="HxW frame size of the 1080p configs, for tests (uhd: twice it)")
    ap.add_argument("--windows", type=int, default=None,
                    help="timed windows of each window config, for tests")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("bench_torch: no CUDA device (torch.cuda.is_available() is False); "
                 "pass --device cpu to run on the CPU")
    from drba_tpu_torch.config import full_f32_products

    full_f32_products()  # the f32 plain paths' convolutions in f32, not TF32
    size = tuple(int(v) for v in args.size.lower().split("x")) if args.size else None
    s = Settings(device, size, args.windows)
    save = not args.no_save

    if args.config:
        names = ([n for n in CONFIGS if not n.startswith("e2e")] if args.config == "all"
                 else [args.config])
        bad = sweep(names, s, save)
        if bad:
            raise SystemExit(f"configs failed: {bad}")
        return

    entry = run_config("rife", s)
    if failed(entry):
        raise SystemExit(f"the headline config failed: {entry['error']}")
    result = {"metric": "1080p 24->60 DRBA synthesized frames/s (rife path, drba_tpu_torch)",
              "value": entry["fps"], "unit": "frames/sec",
              "vs_baseline": round(entry["fps"] / REAL_TIME_FPS, 3),
              "baseline_anchor": "36 fps = real-time 1080p 24->60 delivery",
              "device": entry["device"], "measured_at": entry["measured_at"]}
    breakdown = {}
    if os.path.exists(BREAKDOWN_PATH):
        with open(BREAKDOWN_PATH) as f:
            breakdown = json.load(f)
    breakdown["rife"] = entry
    if save:
        with open(BREAKDOWN_PATH, "w") as f:
            json.dump(breakdown, f, indent=1)
    # entries measured more than 12 h ago are dropped by name (bench.py:436-449)
    ages = {n: _age_hours(e.get("measured_at")) for n, e in breakdown.items()}
    fresh = {n: e for n, e in breakdown.items() if ages[n] is not None and ages[n] <= 12.0}
    result["breakdown"] = fresh
    stale = sorted(set(breakdown) - set(fresh))
    if stale:
        result["stale_omitted"] = stale
    print(json.dumps(result))


if __name__ == "__main__":
    main()
