#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. environment: the card's name and power limit (nvidia-smi), torch,
     numpy, CUDA and nvcc versions; exits 1 when torch sees no CUDA device;
  2. build: compiles every hand-written kernel from drba_tpu_torch/csrc, one
     nvcc per source, all in parallel;
 2b. host (the writers' host runtime and the parameter cache, on the card
     machine's host): builds ``csrc/host.cpp`` (``_build.HOST``); checks
     ``bgr8_to_rgb8`` and ``rgbf32_to_bgr8`` bitwise and ``bgr8_to_rgbf32``
     within 1e-7 against numpy at 1080x1920 and 2160x3840, and times the
     rgb24 flip three ways in turns (native, ``[..., ::-1].tobytes()``,
     ``np.copyto`` of the reversed view; median ms a frame, beside
     ``os.cpu_count()``); passes 64 1080p frames through a ``FrameRing``
     from a producer thread to a consumer (bytes checked, frames/s); writes
     seeded stand-in ``.pkl`` state dicts for the three models' ``train_log_*``
     directories, converts them with ``python -m drba_tpu_torch.convert_weights``,
     and builds RIFE, GMFSS and GMFSS_UNION from an ``.npz``-only tree and
     from a ``.pkl``-only tree (``cli.load_model``): params bitwise equal
     to each other and to the stand-ins, one bf16 1080p T=3 window of each
     bitwise equal (or, where two runs of one model differ by the splat's
     atomics, within the bf16 gate), the load times from each; loads the
     ten networks from partial ``.pkl`` files at seeds 7-11 (missing keys
     take the seed-0 init) bitwise against the ``.npz`` ``convert_weights``
     writes from each, and from state dicts of numpy arrays (numpy scalar
     and 0-d slopes) under numpy 2's and numpy 1's module names bitwise
     against their tensor twins;
  3. kernels: each kernel against its plain PyTorch version at the 1080p
     shapes of the RIFE and GMFSS paths, in f32 and bf16, with the tolerance
     stated beside each check; times both with CUDA events, beside the
     kernel's bound (drba_tpu_torch/bounds.py) and, where one PyTorch call
     computes the same function, that call's time (used nowhere in the port);
     the splat as the paths' six softsplat calls (scatter and normalise
     launches), the layer's projection, window and tail also timed apart;
     the f32 window, flash, layer and conv (3xTF32 on the tensor cores)
     summed into rows of their own, with SDPA in f32 beside window and
     flash and F.conv2d in f32 (TF32 off) beside the conv;
     GMFSS_UNION's shapes (1080p padded to 1152x1920) and the conv chain's
     GMFSS steps (pre-PReLU, plain and final residuals: GridNet L0/L1,
     heads, head1's first step and tail, MetricNet, FeatureNet level 1;
     in f32 also GridNet's L2 and head3 and FeatureNet's levels 2-3)
     checked and timed outside the summed rows; each conv shape on the
     design its plan gives (printed), and in bf16 also on the other design
     that takes it (mma.sync, wgmma), against the plain version;
  4. slices: ``run_pipeline`` on synthetic 1080p frames at 24 -> 60 fps in
     bf16, with a seed-0 random-weight RIFE (IFNet 4.26-heavy, full width), a
     seed-0 GMFSS (GMFlow, MetricNet, FeatureNet, GridNet, full width), a
     seed-0 GMFSS_UNION (the union nets and a half-resolution IFNet), and
     RIFE with scene detection (``-s -st 0.3``) on a stream whose frame 4
     alone is colour-inverted (two cuts); checks the output count against
     the plan, every frame finite at the model's padded size, the cuts, and
     that each kernel of the path was launched during its run (launch counts
     are reset just before each run and read just after); the steady-state
     windows replay their captured CUDA graph (``graphs.py``), whose
     replays count the launches their capture recorded; the models' graphs
     printed by kind (``window``, ``plain``, ``pass``, ``unfused``);
  5. windows: one window of each model on the kernel path against the plain
     path (f32 and bf16), the window time both ways (each through its
     graph), and a profile of one kernel-path window's eager pieces
     (``next_reuse`` + ``drba_window``) with its launches per kernel and its
     conv launches by design (the profiler's kernel names) against the
     plan's; GMFSS's and GMFSS_UNION's windows also timed with
     ``conv_backend="torch"`` alone (every conv on cuDNN, as before the conv
     chain took their nets' convs), in turns with the other two; the graphed
     window (``inference_ts_drba``) against its eager pieces within the
     gates (f32 and bf16), and, in bf16 at T = 2 and 3, both timed in turns
     (CUDA events), their wall, host and device-busy time per window and
     idle share, and each graph's memory pool; in bf16 also drba_tpu's
     other programs as graphs against their eager bodies, per call
     (``inference_ts`` at T = 1 and 2 on a given reuse, the chain start's
     pass, for GMFSS and GMFSS_UNION ``inference_ts`` without a reuse): the
     bf16 gate, a replay's hand-written launches equal to the eager call's,
     both timed the same ways, a replay's host time below the eager call's
     (else the script fails); in f32, GMFSS's and
     GMFSS_UNION's windows timed on the plain path's and the kernel path's
     eager pieces (before any f32 graph) and through the graph, in turns,
     and one replay of each profiled: every window, flash and layer launch
     on the 3xTF32 kernels, every conv launch on the f32 conv design, no
     cuDNN FFT convolution (any fails the script);
  6. resume: ``run_pipeline(skip_outputs=k)`` through the graphs (RIFE at
     a window boundary and inside a window, GMFSS inside a window, RIFE
     ``-s`` just past a cut)
     against the uninterrupted run's tail: the written count is the plan
     less k, fewer kernel launches than the uninterrupted run, and the
     frames bitwise where two uninterrupted runs are, else within the bf16
     gate; the segmented writer (cv2 or ffmpeg) is left to the CPU tests;
  7. scene cuts twice: RIFE and GMFSS ``run_pipeline -s -st 0.3`` twice on
     one model instance over 16 frames, frames 4 and 10 colour-inverted
     (four cuts): in the second run every ``plain``, ``pass`` and ``window``
     call replays (else the script fails), the two runs' frames within the
     bf16 gate, the graphs printed by kind with their replays and pools;
  8. devices: ``run_pipeline_parallel`` over two replicas on the one card
     (two dispatch threads and streams, each replica's passes and windows
     through its own ``pass`` and ``unfused`` graphs) for the
     four slices and an 18-frame GMFSS stream, against the serial run
     (graphed; count, frames within the bf16
     gate, every kernel of the path launched), both timed in turns; each
     replica's graphs and replays (the RIFE and 18-frame runs, where each
     replica runs three or more windows of one T, fail unless they replay);
     ``exchange_accounting`` of one GMFSS group; eight GMFSS windows alone
     through the serial chain and the planner over one and two replicas;
  9. uhd (after the earlier phases' models and graph pools are freed): RIFE
     and GMFSS at ``-scale 0.5`` on 4K frames (2176x3840): a T = 3 and a
     T = 2 window each through its graph against the plain path's eager
     pieces (the bf16 gate), the window ms, each graph's pool bytes and
     launches per replay; then a 6-frame 4K RIFE ``run_pipeline``: the
     planned frames, all finite, every kernel of the path launched;
 10. gate: ``bench_torch.gate_composed``, the composed fast path (kernels,
     half-resolution DRM splats, bf16) against the exact plain path in bf16
     and in f32, min frame SSIM >= 0.995 at injected pans of 8, 20 and 40 px
     (a reading below fails the script); and one SSIM reading each, not
     gated, of a GMFSS and a GMFSS_UNION window against their f32 plain path;
 11. f32 pools (last, after the earlier pools are freed): what holds an
     f32 GMFSS and an f32 GMFSS_UNION graph's pool (the allocator's history
     during each capture, by the port's source lines).

The line before the last is one JSON object with a summary per kernel (and
``*_f32`` rows for the f32 designs of window, flash, layer and conv, whose
launches are the f32 windows'; ``ms_at_library_shapes``: the kernel's time
summed over the shapes its ``library_ms`` covers); the last line is ``{"ok": true, "device":
{...}}``. TF32 is off for PyTorch's f32 convolutions and products
(``config.full_f32_products``, as the CLI sets it); the main path computes
in bf16, where TF32 does not apply. A crash in native code prints every
thread's Python stack (``faulthandler``); after the last line the script
frees the card's memory and exits 0 without the interpreter's teardown.
"""

from __future__ import annotations

import faulthandler
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from collections import Counter

# seed-0 random-weight models of bench_torch's configs, and the size each
# runs a frame at
from bench_torch import make_model, padded_size  # noqa: F401 (torch_window_fps.py)

H, W = 1088, 1920          # 1080p padded to RIFE's and GMFSS's multiple of 64
HU = 1152                  # 1080p padded to GMFSS_UNION's multiple of 128
SRC_FPS, DST_FPS = 24.0, 60.0
N_FRAMES = {"rife": 10, "gmfss": 6, "gmfss_union": 6, "scdet": 10}
UHD = (2160, 3840)         # 4K source frames, run at -scale 0.5 (padded to 2176x3840)
N_UHD = 6
# a longer GMFSS stream for the serial / two-thread timing (8 groups of two)
N_TIMING = 18

# the kernels each path must launch ("scdet": RIFE with scene detection)
PATH_KERNELS = {"rife": ("splat", "warp", "conv_chain", "block_input", "block_output"),
                "gmfss": ("splat", "warp", "conv_chain", "window_attention",
                          "flash_attention", "transformer_layer"),
                "gmfss_union": ("splat", "warp", "conv_chain", "window_attention",
                                "flash_attention", "transformer_layer", "block_input",
                                "block_output"),
                "scdet": ("splat", "warp", "conv_chain", "block_input", "block_output"),
                "uhd": ("splat", "warp", "conv_chain", "block_input", "block_output")}
# window gates, kernel path against plain path on one T=3 window, per
# dtype: (mean abs, share of values off by more than 1e-2). f32: the same
# arithmetic up to atomic/FMA/summation order; bf16: roundings at other
# places (the bf16 layer kernel keeps f32 intermediates that the plain ops
# round). Five random-weight IFNet stages, or GMFlow's 24 transformer layers
# and two correlation softmaxes, amplify both, and thresholds (coverage
# < 0.999; union's 25x timestep swap) can flip pixels, so the gate is on the
# mean and on the share. GMFSS_UNION measured within the same gates (bf16
# mean 3.7e-4, share 2.1e-3), so it shares them.
GATES = {"f32": (1e-4, 1e-3), "bf16": (1e-2, 5e-2)}
# resumed and two-thread runs against the serial uninterrupted run hold the
# bf16 gate on the written uint8 frames (on the [0, 1] scale), as the splat's
# f32 atomics make two runs differ in their last bits; bitwise where two
# uninterrupted runs are
# the __global__ functions of drba_tpu_torch/csrc (by name prefix)
DEVICE_KERNELS = ("splat_", "warp_", "conv3x3_", "attn_wgmma_kernel",
                  "attn_tf32_kernel", "flash_combine_kernel", "layer_proj_", "layer_tail_",
                  "block_input_kernel", "block_output_kernel")
# the kernels whose f32 (--fp32) design has rows of its own in the kernels
# line: 3xTF32 on the tensor cores (csrc/tf32.cuh), timed at the same
# summed shapes; their launches come from the f32 windows
F32_ROWS = ("window_attention", "flash_attention", "transformer_layer", "conv_chain")
# device kernel names of cuDNN's FFT convolutions and the complex products
# they run: an f32 window must launch none
FFT_MARKS = ("fft", "cf32cf32")
# the TPU kernel(s) each kernel replaces (function reaching pl.pallas_call)
REPLACES = {"splat": "drba_tpu/ops/splat_stencil.py:282",
            "warp": "drba_tpu/ops/warp_mxu.py:265",
            "conv_chain": "drba_tpu/ops/conv_chain.py:349",
            "window_attention": "drba_tpu/ops/attn_mxu.py:63 and drba_tpu/ops/attn_mxu.py:281",
            "flash_attention": "drba_tpu/ops/attn_mxu.py:150",
            "transformer_layer": "drba_tpu/ops/attn_layer.py:176",
            "block_input": "none: XLA fused IFNet's concatenations into the first conv on the "
                           "TPU (drba_tpu/models/ifnet.py:ifnet_apply); eager PyTorch wrote "
                           "each out",
            "block_output": "none: XLA fused each IFBlock's shuffle, resize, flow scale and "
                            "flow sum into their consumers on the TPU "
                            "(drba_tpu/models/ifnet.py:311-313, :427); eager PyTorch wrote "
                            "each out"}
# the one PyTorch call timed beside each kernel (used nowhere in the port), or
# why there is none
LIBRARY = {"splat": "none: no single call scatters with bilinear weights and normalises "
                    "(index_add_ takes precomputed indices and weighted values, one call per "
                    "corner)",
           "warp": "F.grid_sample on a precomputed normalised grid, both directions' images "
                   "made dense and stacked beforehand, at the k = 1 launches only (stage 4 "
                   "C=19 and the merge C=3); the tap-averaged k = 2/4/8 warps have none",
           "conv_chain": "F.conv2d with bias (cuDNN), without the epilogue (ResConv, "
                         "pre-PReLU, residual)",
           "window_attention": "F.scaled_dot_product_attention on the windows split "
                               "beforehand, boolean mask where masked; fastest backend",
           "flash_attention": "F.scaled_dot_product_attention, value zero-padded to 8 or 128 "
                              "columns in bf16, unmasked shapes only; fastest backend and width",
           "transformer_layer": "none: projection, attention, merge, norms and FFN are "
                                "several calls",
           "block_input": "the reference's expression for the same channels: torch.cat of "
                          "the pieces (the warps' outputs among them; at full resolution where "
                          "it concatenates there), F.interpolate, and cuDNN's padding copy as "
                          "one more torch.cat",
           "block_output": "the plain version (the expression the kernel replaced): "
                           "pixel_shuffle (a copy), F.interpolate (upsample_bilinear2d), the "
                           "flow's multiply by the scale and its add"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cmd_line(cmd: list[str]) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    lines = [ln for ln in (out.stdout or out.stderr).splitlines() if ln.strip()]
    return lines[0] if cmd[0] == "nvidia-smi" else (lines[-1] if lines else "unavailable")


def timed(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smooth_flow(gen, n, h, w, mag, device, dtype):
    """Bilinearly upsampled random flow (the shape of real flows) plus small noise."""
    import torch
    import torch.nn.functional as F

    coarse = (torch.rand(n, 2, h // 64 + 2, w // 64 + 2, generator=gen, device=device) * 2 - 1)
    f = F.interpolate(coarse * mag, size=(h, w), mode="bilinear", align_corners=False)
    f = f + torch.randn(n, 2, h, w, generator=gen, device=device) * 0.3
    return f.permute(0, 2, 3, 1).contiguous().to(dtype)


def synthetic_frames(n: int, h: int = 1080, w: int = 1920):
    """``n`` BGR uint8 frames (1080p unless given): smooth texture panning 6
    px per frame, with a square moving against it (so the flows are not
    uniform)."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w + 6 * n].astype(np.float32)
    base = np.stack([np.sin(xx / 37.0 + k) * np.cos(yy / 23.0 - k) for k in range(3)], -1)
    base = ((base * 0.4 + 0.5) * 255).astype(np.uint8)
    frames = []
    for i in range(n):
        f = np.ascontiguousarray(base[:, 6 * i:6 * i + w])
        x0 = 600 + 9 * i
        f[400:600, x0:x0 + 200] = (40, 200, 90)
        frames.append(f)
    return frames


class _FrameIO:
    """In-memory frame source and sink with the pipeline's video interface."""

    src_fps, dst_fps = SRC_FPS, DST_FPS
    total_frames_count = 0

    def __init__(self, frames):
        self._frames = list(frames)
        self.written = []

    def read_frame(self):
        return self._frames.pop(0) if self._frames else None

    def write_frame(self, frame):
        self.written.append(frame)

    def finish_writing(self):
        return True


def check_close(label, got, want, atol, rtol, why) -> float:
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    print(f"  {label:<44} max_abs_err {float(err.max()):.3e}  mean {float(err.mean()):.3e}"
          f"  (tol {atol:g} + {rtol:g}*|ref|: {why})")
    if bad.any():
        fail(f"{label}: {int(bad.sum())} elements beyond tolerance")
    return float(err.max())


def sdpa_call(q, k, v, mask=None):
    """The fastest single ``F.scaled_dot_product_attention`` call on these
    inputs over PyTorch's backends: (fn, backend name)."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    best = None
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def fn(be=be):
            with sdpa_kernel([be]):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        t = timed(fn, 3)
        if best is None or t < best[0]:
            best = (t, fn, be.name)
    return best[1], best[2]


def tensors_of(obj, path=""):
    """(path, tensor) of every tensor in a model's params (dicts, named
    tuples, lists), in a fixed order."""
    import torch

    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from tensors_of(obj[k], f"{path}.{k}")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from tensors_of(v, f"{path}[{i}]")


def host_converters(gpu_line):
    """The converters of ``utils/native.py`` against numpy at 1080p and 4K,
    and the rgb24 flip timed three ways in turns."""
    import statistics

    import numpy as np

    from drba_tpu_torch.utils import native

    rng = np.random.default_rng(0)
    for (h, w), reps in (((1080, 1920), 30), ((2160, 3840), 15)):
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out = np.empty_like(frame)
        if not np.array_equal(native.bgr8_to_rgb8(frame, out=out),
                              native.bgr8_to_rgb8_plain(frame)):
            fail(f"host: bgr8_to_rgb8 differs from numpy at {h}x{w}")
        x = rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
        if not np.array_equal(native.rgbf32_to_bgr8(x), native.rgbf32_to_bgr8_plain(x)):
            fail(f"host: rgbf32_to_bgr8 differs from numpy at {h}x{w}")
        err = float(np.abs(native.bgr8_to_rgbf32(frame) - native.bgr8_to_rgbf32_plain(frame)).max())
        if err > 1e-7:  # times 1/255 against numpy's division
            fail(f"host: bgr8_to_rgbf32 off by {err:.3e} (> 1e-7) at {h}x{w}")
        ways = {"native": lambda: native.bgr8_to_rgb8(frame, out=out),
                "[..., ::-1].tobytes()": lambda: frame[..., ::-1].tobytes(),
                "np.copyto": lambda: np.copyto(out, frame[..., ::-1])}
        ms = {k: [] for k in ways}
        for _ in range(reps):
            for k, fn in ways.items():
                t0 = time.perf_counter()
                fn()
                ms[k].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(f"host {h}x{w}: bgr8_to_rgb8 and rgbf32_to_bgr8 bitwise equal to numpy, "
              f"bgr8_to_rgbf32 max abs {err:.3e} (<= 1e-7); rgb24 flip, median ms a frame "
              f"over {reps} in turns: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
              + f" (native {med['[..., ::-1].tobytes()'] / med['native']:.2f}x tobytes); "
              f"os.cpu_count() {os.cpu_count()}  [{gpu_line}]")


def host_ring(gpu_line):
    """64 1080p frames through a ``FrameRing`` from a producer thread to a
    consumer thread; the bytes checked."""
    import threading

    import numpy as np

    from drba_tpu_torch.utils import native

    n, slot = 64, 1080 * 1920 * 3
    frames = np.random.default_rng(1).integers(0, 256, (n, slot), dtype=np.uint8)
    got = np.empty_like(frames)
    ring = native.FrameRing(slot, 8)
    popped = []

    def consumer():
        i = 0
        while True:
            rc = ring.pop(got[i] if i < n else np.empty(slot, np.uint8))
            if rc == -1:
                break
            if rc > 0:
                popped.append(rc)
                i += 1

    t = threading.Thread(target=consumer)
    t0 = time.perf_counter()
    t.start()
    for f in frames:
        while (rc := ring.push(f)) == 0:
            pass
        if rc != 1:
            fail(f"host: FrameRing.push returned {rc}")
    ring.close()
    t.join(timeout=120)
    dt = time.perf_counter() - t0
    if t.is_alive() or popped != [slot] * n or not np.array_equal(got, frames):
        fail(f"host: FrameRing passed {len(popped)} of {n} frames, or not their bytes")
    print(f"host ring: {n} 1080p frames producer -> consumer thread (8 slots), bytes equal, "
          f"{n / dt:.1f} frames/s ({n * slot / dt / 1e9:.2f} GB/s)  [{gpu_line}]")


def host_cache(dev, gpu_line):
    """The ``.npz`` parameter cache: stand-in checkpoints converted by
    ``python -m drba_tpu_torch.convert_weights``; each model from an
    ``.npz``-only and from a ``.pkl``-only tree, params and one window."""
    import shutil
    import tempfile

    import torch

    from drba_tpu_torch import convert
    from drba_tpu_torch.cli import _MODELS, load_model
    from drba_tpu_torch.config import DEFAULT
    from drba_tpu_torch.convert_weights import specs_for
    from drba_tpu_torch.models.layers import init_from_spec
    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper, to_inp

    with tempfile.TemporaryDirectory(prefix="drba_weights_") as tmp:
        made, standin = os.path.join(tmp, "made"), {}
        for j, (_, _, sub) in enumerate(_MODELS.values()):
            os.makedirs(os.path.join(made, sub))
            for i, (pkl, spec) in enumerate(specs_for(sub).items()):
                p = convert.from_jax_params(init_from_spec(spec, seed=100 + 10 * j + i), spec)
                standin[(sub, pkl)] = p
                torch.save(convert.to_torch_state_dict(p, spec), os.path.join(made, sub, pkl))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "drba_tpu_torch.convert_weights",
                               "--weights", made], capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0 or f"done, {len(standin)} checkpoints converted" not in proc.stdout:
            fail(f"host: convert_weights failed (rc {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        print(f"host cache: python -m drba_tpu_torch.convert_weights wrote {len(standin)} .npz "
              f"in {time.perf_counter() - t0:.2f} s")
        trees = {ext: os.path.join(tmp, ext) for ext in ("npz", "pkl")}
        for ext, root in trees.items():
            for sub in {s for s, _ in standin}:
                os.makedirs(os.path.join(root, sub))
                for f in os.listdir(os.path.join(made, sub)):
                    if f.endswith("." + ext):
                        shutil.copy(os.path.join(made, sub, f), os.path.join(root, sub, f))

        # the loads alone (CPU, f32), in turns: each network equal to its stand-in
        secs = {ext: 0.0 for ext in trees}
        for ext in ("pkl", "npz", "npz", "pkl"):
            for (sub, pkl), spec_p in standin.items():
                spec = specs_for(sub)[pkl]
                t0 = time.perf_counter()
                got = convert.load_network(os.path.join(trees[ext], sub), pkl, spec, strict=True)
                secs[ext] += (time.perf_counter() - t0) / 2
                bad = [k for k in spec if not torch.equal(got[k], spec_p[k])]
                if bad:
                    fail(f"host: {sub}/{pkl} from the {ext} tree differs from its stand-in "
                         f"at {bad[:3]}")
        print(f"host cache: {len(standin)} networks from .pkl {secs['pkl']:.3f} s, from .npz "
              f"{secs['npz']:.3f} s (convert.load_network, mean of two in turns), each "
              f"bitwise equal to its stand-in  [{gpu_line}]")

        frames = synthetic_frames(3)
        ts3 = calc_ts(0, TMapper(SRC_FPS, DST_FPS), -1)
        for name in _MODELS:
            models, build = {}, {}
            for ext, root in trees.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                models[ext] = load_model(name, root, 1.0, DEFAULT.replace(strict_load=True), dev)
                torch.cuda.synchronize()
                build[ext] = time.perf_counter() - t0
            a, b = (list(tensors_of(tuple(getattr(models[e], t) for t in models[e].PARAM_TREES)))
                    for e in ("npz", "pkl"))
            if [k for k, _ in a] != [k for k, _ in b] or not all(
                    x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(a, b)):
                fail(f"host: {name} built from .npz and from .pkl hold other params")
            m = models["npz"]
            size = padded_size(m)
            I0, I1, I2 = (to_inp(f, size, m.config.compute_dtype, dev) for f in frames)

            # each model's chain-start pass once (a second call of its key would capture)
            reuse = {e: mm.reuse(I1, I0) for e, mm in models.items()}
            w_pkl, w_npz, w_pkl2 = (
                torch.stack(eager_window(models[e], I0, I1, I2, ts3, reuse[e])[0])
                for e in ("pkl", "npz", "pkl"))
            if not torch.isfinite(w_npz).all():
                fail(f"host: {name} window from .npz not finite")
            if torch.equal(w_npz, w_pkl):
                how = "bitwise equal"
            elif torch.equal(w_pkl, w_pkl2):
                fail(f"host: {name} window from .npz differs from .pkl's, where two runs of the "
                     f".pkl model are bitwise equal")
            else:
                d = (w_npz.float() - w_pkl.float()).abs()
                mean, share = float(d.mean()), float((d > 1e-2).float().mean())
                if mean > GATES["bf16"][0] or share > GATES["bf16"][1]:
                    fail(f"host: {name} window from .npz vs .pkl: mean {mean:.3e}, "
                         f"share {share:.3e} beyond the bf16 gate")
                how = (f"within the bf16 gate (mean abs {mean:.3e}; two runs of the .pkl model "
                       f"also differ: the splat's atomics)")
            print(f"host cache: {name} from .npz and from .pkl ({len(a)} param tensors bitwise "
                  f"equal); built in {build['npz']:.2f} / {build['pkl']:.2f} s (npz / pkl, "
                  f"cli.load_model to the card); one bf16 T={len(ts3)} {size[0]}x{size[1]} "
                  f"window {how}  [{gpu_line}]")
            del models, m, reuse
            torch.cuda.empty_cache()


def respell_numpy(path, module):
    """Rewrite a ``torch.save`` file so that its pickle names numpy's
    multiarray module as ``module``: numpy 1 wrote ``numpy.core.multiarray``,
    numpy 2 writes ``numpy._core.multiarray``."""
    import io
    import zipfile

    with zipfile.ZipFile(path) as z:
        records = {n: z.read(n) for n in z.namelist()}
    for n, b in records.items():
        if n.endswith("/data.pkl"):
            for old in (b"numpy._core.multiarray", b"numpy.core.multiarray"):
                b = b.replace(old + b"\n", module.encode() + b"\n")
            records[n] = b
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for n, b in records.items():
            z.writestr(n, b)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def host_pkl(gpu_line):
    """The ``.pkl`` cases ``drba_tpu``'s loader reads, on this machine's
    torch and numpy: a partial state dict loaded at a seed other than 0
    (missing keys take the seed-0 init) against the ``.npz`` that
    ``convert_weights`` writes from it and against the expected params; a
    state dict of numpy arrays (slopes as numpy scalars and 0-d arrays),
    under numpy 2's and numpy 1's module names, against its tensor twin."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from drba_tpu_torch import convert, convert_weights
    from drba_tpu_torch.cli import _MODELS
    from drba_tpu_torch.models.layers import init_from_spec

    nets = [(sub, pkl, i) for _, _, sub in _MODELS.values()
            for i, pkl in enumerate(convert_weights.specs_for(sub))]
    seed = 7  # config.seed: network i of a model loads at seed + i

    def bad_keys(got, want):
        return [k for k in want
                if got[k].dtype != torch.float32 or not torch.equal(got[k], want[k])]

    with tempfile.TemporaryDirectory(prefix="drba_pkl_") as tmp:
        want, n_missing = {}, 0
        for sub, pkl, i in nets:
            spec = convert_weights.specs_for(sub)[pkl]
            full = convert.from_jax_params(init_from_spec(spec, seed=200 + 10 * i + len(sub)),
                                           spec)
            fill = convert.from_jax_params(init_from_spec(spec), spec)
            keep = {k for j, k in enumerate(spec) if j >= 3 and j % 7}
            want[(sub, pkl)] = {k: full[k] if k in keep else fill[k] for k in spec}
            n_missing += len(spec) - len(keep)
            os.makedirs(os.path.join(tmp, sub), exist_ok=True)
            sd = convert.to_torch_state_dict(full, spec)
            torch.save({k: v for k, v in sd.items() if k in keep}, os.path.join(tmp, sub, pkl))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            n = convert_weights.main(["--weights", tmp])
        if n != len(nets):
            fail(f"host: convert_weights converted {n} of {len(nets)} partial .pkl:\n"
                 f"{out.getvalue()}")
        for sub, pkl, i in nets:
            spec = convert_weights.specs_for(sub)[pkl]
            d = os.path.join(tmp, sub)
            npz = os.path.join(d, os.path.splitext(pkl)[0] + ".npz")
            from_npz = convert.load_network(d, pkl, spec, seed=seed + i)
            os.rename(npz, npz + ".off")
            from_pkl = convert.load_network(d, pkl, spec, seed=seed + i)
            bad = bad_keys(from_pkl, from_npz) + bad_keys(from_pkl, want[(sub, pkl)])
            if bad:
                fail(f"host: partial {sub}/{pkl} at seed {seed + i}: .pkl, its .npz and the "
                     f"seed-0 fill disagree at {bad[:3]}")
        print(f"host pkl: {len(nets)} partial .pkl ({n_missing} keys missing) loaded at seeds "
              f"{seed}-{seed + 4}, each bitwise equal to the .npz convert_weights wrote from it "
              f"and to its keys with the seed-0 fill  [{gpu_line}]")

        spellings = ("numpy._core.multiarray", "numpy.core.multiarray")
        for sub, pkl, _ in nets:
            spec = convert_weights.specs_for(sub)[pkl]
            d = os.path.join(tmp, "nd", sub)
            os.makedirs(d, exist_ok=True)
            sd = convert.to_torch_state_dict(want[(sub, pkl)], spec)
            torch.save(sd, os.path.join(d, "twin.pkl"))
            arrays, n_scalar = {}, 0
            for k, v in sd.items():
                v = v.numpy()
                if spec[k][0] == "scalar":  # a numpy scalar, a 0-d array, a (1,) array
                    v = (np.float32(v[0]), np.array(v[0], np.float32), v)[n_scalar % 3]
                    n_scalar += 1
                arrays[k] = v
            twin = convert.load_network(d, "twin.pkl", spec, strict=True)
            for module in spellings:
                path = os.path.join(d, f"{module}.pkl")
                torch.save(arrays, path)
                respell_numpy(path, module)
                if module not in str(torch.serialization.get_unsafe_globals_in_checkpoint(path)):
                    fail(f"host: {path} does not name {module}")
                got = convert.load_network(d, f"{module}.pkl", spec, strict=True)
                bad = bad_keys(got, twin)
                if bad:
                    fail(f"host: {sub}/{pkl} as numpy arrays ({module}) differs from its "
                         f"tensor twin at {bad[:3]}")
        print(f"host pkl: {len(nets)} state dicts of numpy arrays (slopes as numpy scalars and "
              f"0-d arrays), pickled under {' and '.join(spellings)}, each bitwise equal to its "
              f"tensor twin (numpy {np.__version__}, torch {torch.__version__})  [{gpu_line}]")


def phase_host(dev, gpu_line):
    """Phase 2b: the writers' host runtime and the parameter cache."""
    from drba_tpu_torch import _build
    from drba_tpu_torch.utils import native

    t0 = time.perf_counter()
    try:
        native.load()
    except RuntimeError as e:
        fail(f"host: {e}")
    print(f"build host: {_build.CSRC.name}/{_build.HOST.source} with {_build.find_cxx()} "
          f"{' '.join(_build.HOST_FLAGS)} in {time.perf_counter() - t0:.1f} s")
    host_converters(gpu_line)
    host_ring(gpu_line)
    host_cache(dev, gpu_line)
    host_pkl(gpu_line)


def phase_kernels(dev):
    """Kernel vs plain version at the 1080p path shapes; returns per-kernel summaries."""
    import torch
    import torch.nn.functional as F

    from drba_tpu_torch import bounds
    from drba_tpu_torch.ops.conv_chain import _step_plain, chain_step, conv3x3_cuda, conv3x3_path
    from drba_tpu_torch.ops.softsplat import softsplat
    from drba_tpu_torch.ops.warp import backwarp, backwarp2, sample_positions
    from drba_tpu_torch.ops.warp_cuda import warp_cuda

    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    summary = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "work": bounds.Work(0.0),
                   "library_ms": None, "ms_at_library": None, "library_call": LIBRARY[n]}
               for n in REPLACES}
    for n in F32_ROWS:
        summary[f"{n}_f32"] = dict(summary[n], library_call=LIBRARY[n].replace(
            "in bf16", "in f32") + " (f32, TF32 off)")

    def record(name, err, fn_kernel, fn_plain, iters, dt, work, library=None, summed=True):
        """Time kernel and plain version in turns; ``work``: the bounds.Work
        of this call; ``library``: (fn, label) of one PyTorch call computing
        the same function, or None; ``summed``: add the times to the
        kernel's summary (bf16), or to its f32 row (f32, F32_ROWS)."""
        s = summary[name]
        if dt == f32 and f"{name}_f32" in summary:
            s = summary[f"{name}_f32"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        # plain, kernel, kernel, plain: each side timed twice, in turns
        tp = timed(fn_plain, iters)
        tk = timed(fn_kernel, iters)
        tk = (tk + timed(fn_kernel, iters)) / 2
        tp = (tp + timed(fn_plain, iters)) / 2
        b_ms, b_by = bounds.bound_ms(work)
        line = (f"    time: kernel {tk:.4f} ms   plain {tp:.4f} ms   bound {b_ms:.4f} ms "
                f"({b_by}; {100 * b_ms / tk:.1f}% of it reached)")
        tl = None
        if library is not None:
            tl = timed(library[0], iters)
            line += f"   library {tl:.4f} ms ({library[1]}; kernel/library {tk / tl:.2f})"
        print(line)
        if summed and (dt == bf16 or s is not summary[name]):  # bf16, or an f32 row
            s["ms"] += tk
            s["plain_ms"] += tp
            s["work"] = s["work"] + work
            if tl is not None:  # and the kernel's time on the library call's shapes
                s["library_ms"] = (s["library_ms"] or 0.0) + tl
                s["ms_at_library"] = (s["ms_at_library"] or 0.0) + tk

    print("kernels vs plain PyTorch (1080p RIFE and GMFSS path shapes):")
    # splat: the path's softsplat calls of a T=3 window, each a scatter and a
    # normalise launch: RIFE's flow inversion (both directions' flows splat
    # themselves, full res) and DRM alignment (f32 maps along an f32 flow,
    # half res); GMFSS's three soft splats (image + features, both
    # directions, B = 2T) and its DRM alignment (f32 maps, bf16 flow and
    # metric, quarter res). Each in f32 and in the path's dtypes (summed).
    # Checked and timed, not summed: GMFSS_UNION's level-0 soft splat, whose
    # timestep map makes C = 3 + 64 + 1 = 68 (an accumulator stride of 72),
    # and its auxiliary RIFE's DRM alignment, at 1152x1920.
    for label, (n, c, h, w, mag, main, cov, path_dt, summed) in {
            "rife flow inversion": (2, 2, H, W, 24.0, "avg", True, (bf16, bf16, None), True),
            "rife drm alignment": (6, 1, H // 2, W // 2, 12.0, "avg", True, (f32, f32, None),
                                   True),
            "gmfss soft level 0": (6, 67, H // 2, W // 2, 12.0, "soft", True, (bf16,) * 3, True),
            "gmfss soft level 1": (6, 128, H // 4, W // 4, 6.0, "soft", False, (bf16,) * 3,
                                   True),
            "gmfss soft level 2": (6, 192, H // 8, W // 8, 3.0, "soft", False, (bf16,) * 3,
                                   True),
            "gmfss drm alignment": (6, 1, H // 4, W // 4, 6.0, "soft", True,
                                    (f32, bf16, bf16), True),
            "union soft level 0 + timestep": (6, 68, HU // 2, W // 2, 12.0, "soft", True,
                                              (bf16,) * 3, False),
            "union rife-aux drm alignment": (6, 1, HU // 4, W // 4, 6.0, "soft", True,
                                             (f32, bf16, bf16), False)}.items():
        for variant, (vdt, fdt, mdt) in (("f32", (f32, f32, f32)), ("path dtypes", path_dt)):
            flow = smooth_flow(gen, n, h, w, mag, dev, fdt)
            ten = flow if label == "rife flow inversion" else \
                torch.rand(n, h, w, c, generator=gen, device=dev).to(vdt)
            metric = None
            if main == "soft":
                metric = (torch.randn(n, h, w, 1, generator=gen, device=dev) * 0.5).to(mdt)
            kern = lambda: softsplat(ten, flow, metric, main, backend="cuda", return_coverage=cov)
            plain = lambda: softsplat(ten, flow, metric, main, backend="torch",
                                      return_coverage=cov)
            got, want = kern(), plain()
            tol = (1e-4, 1e-5, "f32 sums of <= ~10 terms in another order, divided alike") \
                if ten.dtype == f32 else (1e-2, 8e-3, "one bf16 output ulp (2^-8 relative)")
            err = 0.0
            for part, g, wt in zip(("result", "coverage"), got if cov else [got],
                                   want if cov else [want]):
                err = max(err, check_close(f"splat {label} {part} ({n},{h},{w},{c}) "
                                           f"{variant}", g, wt, *tol))
            work = bounds.splat_work(n, h, w, c, ten.element_size(), flow.element_size(),
                                     0 if metric is None else metric.element_size(), cov)
            record("splat", err, kern, plain, 10, f32 if variant == "f32" else bf16, work,
                   summed=summed)

    # warp, summed into the kernel's summary: the RIFE path's five launches
    # of a T=3 window, made as ifnet.stage_input and the merge make them,
    # each warping both directions of the 4-channel flow (B = 2T = 6 images)
    # from operands read where they lie (ops/planes.py): direction 0 the
    # frame I1 (3 channels) beside its 16 features, both shared by the T
    # planes with a batch stride of 0; direction 1 the B side, I0 or I2 and
    # its features picked per plane. The tap-grid warps of stages 1-3
    # (k = 2/4/8) write their slots, channels [0, 19) and [19, 38), of the
    # 56-channel block input ("in place": the whole buffer is compared, so a
    # write past a slot shows); stage 4 (k = 1) and the merge (the frames
    # alone, C = 3) stack the two directions. Checked and timed, not summed:
    # GMFSS_UNION's auxiliary IFNet at 576x960, which hands IFNet T distinct
    # frames (each direction a contiguous frame beside its features), one
    # direction at the two k = 1 shapes (backwarp, B = T = 3) and GMFSS's
    # zeros-padded warps (MetricNet C=5 at 544x960, GMFlow C=128 at 136x240)
    from drba_tpu_torch.models.ifnet import BLOCK_IN_PADDED, WARPED
    from drba_tpu_torch.ops.planes import Pick, dense, first_channels, shared

    T = 3
    take_b = torch.tensor([False, True, True], device=dev)
    for label, (form, c, k, mode, h, w, summed) in {
            "stage k=2 C=19 in place": ("window", 19, 2, "border", H, W, True),
            "stage k=4 C=19 in place": ("window", 19, 4, "border", H, W, True),
            "stage k=8 C=19 in place": ("window", 19, 8, "border", H, W, True),
            "stage 4 C=19": ("window", 19, 1, "border", H, W, True),
            "merge C=3": ("window", 3, 1, "border", H, W, True),
            "union aux k=2 C=19 in place": ("frames", 19, 2, "border", HU // 2, W // 2, False),
            "union aux k=4 C=19 in place": ("frames", 19, 4, "border", HU // 2, W // 2, False),
            "union aux k=8 C=19 in place": ("frames", 19, 8, "border", HU // 2, W // 2, False),
            "union aux stage 4 C=19": ("frames", 19, 1, "border", HU // 2, W // 2, False),
            "union aux merge C=3": ("frames", 3, 1, "border", HU // 2, W // 2, False),
            "one direction C=19": ("one", 19, 1, "border", H, W, False),
            "one direction C=3": ("one", 3, 1, "border", H, W, False),
            "metricnet zeros C=5": ("one", 5, 1, "zeros", H // 2, W // 2, False),
            "gmflow zeros C=128": ("one", 128, 1, "zeros", H // 8, W // 8, False)}.items():
        for dt in (f32, bf16):
            rnd = lambda *shape: torch.rand(*shape, generator=gen, device=dev).to(dt)
            b = 2 if mode == "zeros" else T  # GMFSS's pair, else the window's T planes
            flow = smooth_flow(gen, b, h, w, 16.0, dev, dt)
            out_k = out_p = None
            if form == "one":
                img = rnd(b, h, w, c)
                kern = lambda: warp_cuda(img, flow, k, mode)
                plain = lambda: backwarp(img, flow, mode, backend="torch")
                flows, frames = flow, None
            else:
                flow = torch.cat([flow, smooth_flow(gen, b, h, w, 16.0, dev, dt)], dim=-1)
                if form == "window":  # I0, I1, I2 and their features, one frame each
                    I0, I1, I2 = (rnd(1, h, w, 3) for _ in range(3))
                    f0, f1, f2 = (rnd(1, h, w, 16) * 2 - 1 for _ in range(3))
                    img0, feat0 = shared(I1, T), shared(f1, T)
                    img1 = Pick(shared(I0, T), shared(I2, T), take_b)
                    feat1 = Pick(shared(f0, T), shared(f2, T), take_b)
                    frames = [0] * T + [1 + int(t) for t in take_b]
                else:  # T frames a direction
                    img0, img1 = rnd(T, h, w, 3), rnd(T, h, w, 3)
                    feat0, feat1 = rnd(T, h, w, 16) * 2 - 1, rnd(T, h, w, 16) * 2 - 1
                    frames = None
                if c == WARPED:  # the frame's 3 channels beside its features
                    a = (first_channels(img0, 3), feat0)
                    bb = (first_channels(img1, 3), feat1)
                else:
                    a, bb = img0, img1
                if k > 1:
                    out_k = torch.zeros((T, h // k, w // k, BLOCK_IN_PADDED[1]), dtype=dt,
                                        device=dev)
                    out_p = torch.zeros_like(out_k)
                kern = lambda: backwarp2(a, bb, flow, k, mode, backend="cuda", out=out_k,
                                         offsets=(0, WARPED))
                plain = lambda: backwarp2(a, bb, flow, k, mode, backend="torch", out=out_p,
                                          offsets=(0, WARPED))
                flows = torch.cat([flow[..., 0:2], flow[..., 2:4]])
            tol = (1e-5, "same f32 arithmetic, FMA contraction") if dt == f32 else \
                (1e-2, "one bf16 ulp (2^-7) at values <= 1 from the output rounding")
            err = check_close(f"warp {label} ({flows.shape[0]},{h},{w},{c}) {dt}", kern(),
                              plain(), tol[0], 0.0, tol[1])
            px, py = sample_positions(flows, k)
            work = bounds.warp_work(flows.shape[0], h, w, c, k, dt.itemsize,
                                    bounds.warp_touched(px, py, h, w, frames))
            library = None
            if k == 1:  # grid_sample on the normalised grid of the same positions
                grid = torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1], -1).to(dt)
                # both directions' images, made dense and stacked outside the timing
                src = img if form == "one" else torch.cat(
                    [torch.cat([dense(x) for x in op], -1) if isinstance(op, tuple)
                     else dense(op) for op in (a, bb)])
                nchw = src.permute(0, 3, 1, 2)  # the NHWC data, channels_last
                library = (lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode=mode,
                                                 align_corners=True), "F.grid_sample")
            record("warp", err, kern, plain, 10, dt, work, library, summed)

    # conv chain: one ResConv step of each IFNet block at 1080p, N=T=3
    # (summed), and, not summed, block 0 at N=1 as the flow pass of
    # _calc_flow runs it and each block of GMFSS_UNION's auxiliary IFNet at
    # half resolution (576x960); weights packed once, as the model packs them
    for n, c, h, w, summed in ((3, 192, 17, 30, True), (3, 128, 34, 60, True),
                               (3, 96, 68, 120, True), (3, 64, 136, 240, True),
                               (3, 32, 272, 480, True), (1, 192, 17, 30, False),
                               (3, 192, 9, 15, False), (3, 128, 18, 30, False),
                               (3, 96, 36, 60, False), (3, 64, 72, 120, False),
                               (3, 32, 144, 240, False)):
        for dt in (f32, bf16):
            bound = 1.0 / (9 * c) ** 0.5
            x = (torch.rand(n, h, w, c, generator=gen, device=dev) * 2 - 1).to(dt)
            st = chain_step(
                ((torch.rand(c, c, 3, 3, generator=gen, device=dev) * 2 - 1) * bound).to(dt),
                ((torch.rand(c, generator=gen, device=dev) * 2 - 1) * 0.05).to(dt),
                (1 + 0.2 * torch.randn(c, generator=gen, device=dev)).to(dt))
            tol = (1e-4, 0.0, "f32 sums of 9*C terms in another order") if dt == f32 else \
                (2e-2, 2e-2, "bf16 rounding of conv output and of 3 epilogue ops")
            kern = lambda: conv3x3_cuda(x, st.w, st.b, st.beta, st.wp)
            want = _step_plain(x, st)
            err = check_close(f"conv_chain step {tuple(x.shape)} {dt} "
                              f"[{conv3x3_path(n, h, w, c, c, dt)}]", kern(), want, *tol)
            for path in other_designs(n, h, w, c, c, dt):
                err = max(err, check_close(
                    f"conv_chain step {tuple(x.shape)} {dt} [{path}, forced]",
                    conv3x3_cuda(x, st.w, st.b, st.beta, st.wp, path=path), want, *tol))
            nchw = x.permute(0, 3, 1, 2)  # the NHWC data, channels_last
            record("conv_chain", err, kern, lambda: _step_plain(x, st), 10, dt,
                   bounds.conv3x3_work(n, h, w, c, c, x.element_size()),
                   (lambda: F.conv2d(nchw, st.w, st.b, padding=1), "F.conv2d (cuDNN)"), summed)
    gmfss_conv_checks(dev, gen, record)
    attention_checks(dev, gen, record)
    block_input_checks(dev, gen, record)
    block_output_checks(dev, gen, record)
    return summary


def block_input_checks(dev, gen, record):
    """The IFBlock input assembly (``ops/block_input.assemble``: the
    channels the warps do not write in place) against its plain version, and
    timed beside the reference's expression for the same channels (LIBRARY).
    Summed: the RIFE window's five block inputs at 1088x1920, T = 3 (stage 0
    from the shared frame, the picked B side and an f32 timestep map; stages
    1-4 the timestep, mask, features and flow, and at stage 4 the warps'
    stacked halves). Checked and timed, not summed: the flow pass's block 0 (N = 1),
    the union's auxiliary IFNet at 576x960 and, at -scale 0.5 on 4K, at
    1152x1920 with scales 32-2, and RIFE at -scale 0.75 (non-integer
    scales). The kernel must equal the plain version bit for bit at integer
    scales (the same taps and weights, the same roundings); elsewhere
    within two ulps of the largest value (F.interpolate's kernel may fuse
    the bilinear multiply-adds in another order, and the flow's product
    with 1 / scale rounds once more)."""
    import torch

    from drba_tpu_torch import bounds
    from drba_tpu_torch.models.ifnet import BLOCK_IN, BLOCK_IN_PADDED, WARPED
    from drba_tpu_torch.ops.block_input import assemble
    from drba_tpu_torch.ops.planes import Pick, dense, first_channels, shared
    from drba_tpu_torch.ops.resize import resize_bilinear

    f32, bf16 = torch.float32, torch.bfloat16
    T = 3
    take_b = torch.tensor([False, True, True], device=dev)
    for label, (h, w, scales, summed) in {
            "rife": (H, W, (16.0, 8.0, 4.0, 2.0, 1.0), True),
            "union aux": (HU // 2, W // 2, (16.0, 8.0, 4.0, 2.0, 1.0), False),
            "union 4K aux": (HU, W, (32.0, 16.0, 8.0, 4.0, 2.0), False),
            "rife -scale 0.75": (H, W, tuple(s / 0.75 for s in (16.0, 8.0, 4.0, 2.0, 1.0)),
                                 False)}.items():
        for dt in (f32, bf16):
            rnd = lambda *shape: torch.rand(*shape, generator=gen, device=dev).to(dt)
            I0, I1, I2 = (rnd(1, h, w, 3) for _ in range(3))
            f0, f1, f2 = (rnd(1, h, w, 16) * 2 - 1 for _ in range(3))
            tmaps = [torch.rand(T, h, w, 1, generator=gen, device=dev) for _ in range(2)]
            img_b = Pick(shared(I0, T), shared(I2, T), take_b)
            f_b = Pick(shared(f0, T), shared(f2, T), take_b)
            t = Pick(*tmaps, take_b)
            tmp = rnd(T, h, w, 13) * 2 - 1
            flow = (rnd(T, h, w, 4) * 2 - 1) * 8
            # (name, parts as (operand, channels, distinct frames), scale, summed)
            cases = [("block 0", [(shared(I1, T), 3, 1), (img_b, 3, 2), (shared(f1, T), 16, 1),
                                  (f_b, 16, 2), (t, 1, 2)], scales[0], summed)]
            cases.append(("flow pass block 0",
                          [(I1, 3, 1), (I0, 3, 1), (f1, 16, 1), (f0, 16, 1),
                           (I1.new_full((1, 1, 1, 1), 0.5).expand(1, h, w, 1), 1, 1)],
                          scales[0], False))
            for i, sc in enumerate(scales[1:], 1):
                # at an even scale the warps write channels [0, 38) in place;
                # elsewhere their stacked halves, at full resolution, are parts
                in_place = float(sc).is_integer() and int(sc) % 2 == 0
                warps = [] if in_place else [(rnd(T, h, w, WARPED), WARPED, T) for _ in range(2)]
                cases.append((f"block {i}", warps + [(t, 1, 2), (tmp[..., 4:5], 1, T),
                                                     (tmp[..., 5:], 8, T), (flow, 4, T)],
                              sc, summed))
            for name, parts, sc, add in cases:
                n = 1 if name.startswith("flow pass") else T
                size = (int(h / sc), int(w / sc))
                cout = BLOCK_IN_PADDED[0 if name.endswith("block 0") else 1]
                mults = [1.0] * len(parts)
                if not name.endswith("block 0"):
                    mults[-1] = 1.0 / sc  # the flow over the scale
                ops = [((first_channels(x, 3) if c == 3 else x), m)
                       for (x, c, _), m in zip(parts, mults)]
                # the channels the warps write in place
                first = BLOCK_IN[0 if name.endswith("block 0") else 1] - sum(c for _, c, _ in parts)
                out_k = torch.zeros((n, *size, cout), dtype=dt, device=dev)
                out_p = torch.zeros_like(out_k)
                kern = lambda: assemble(out_k, ops, backend="cuda", first=first)
                plain = lambda: assemble(out_p, ops, backend="torch", first=first)
                got, want = kern(), plain()
                if sc == int(sc):
                    d = int((got.float() != want.float()).sum())
                    err = float((got.float() - want.float()).abs().max())
                    print(f"block_input {label} {name} (scale {sc:g}, {tuple(got.shape)}) {dt}: "
                          f"{d} values differ (max_abs {err:.3e}); must be bit for bit")
                    if d:
                        fail(f"block_input {label} {name} {dt}: kernel differs from plain")
                else:
                    ulp = 2 ** -7 if dt == bf16 else 2 ** -23
                    err = check_close(f"block_input {label} {name} (scale {sc:g}, "
                                      f"{tuple(got.shape)}) {dt}", got, want,
                                      2 * ulp * float(want.float().abs().max()), 0.0,
                                      "two ulps of the largest value: multiply-adds fused in "
                                      "another order, the flow's 1 / scale")

                # the warps' outputs the reference concatenated with the rest
                warped = [rnd(n, *size, WARPED) for _ in range(first // WARPED)]

                def reference(parts=parts, mults=mults, size=size, cout=cout, warped=warped):
                    # the old expression: the pieces concatenated (at full
                    # resolution), resized, beside the warps; the flow
                    # appended; cuDNN's pad
                    xs = [dense(first_channels(x, 3) if c == 3 else x).to(dt)
                          for x, c, _ in parts]
                    flow_apart = mults[-1] != 1.0
                    head = torch.cat(warped + [resize_bilinear(
                        torch.cat(xs[:-1] if flow_apart else xs, -1), size)], -1)
                    if flow_apart:
                        head = torch.cat([head, resize_bilinear(xs[-1], size) * mults[-1]], -1)
                    return torch.cat([head, head.new_zeros(*head.shape[:3],
                                                           cout - head.shape[-1])], -1)

                work = bounds.block_input_work(
                    n, *size, cout, first, got.element_size(),
                    [(frames if n == T else 1, *(x.a if isinstance(x, Pick) else x).shape[1:3],
                      c, (x.a if isinstance(x, Pick) else x).element_size())
                     for x, c, frames in parts])
                record("block_input", err, kern, plain, 10, dt, work,
                       (reference, "torch.cat + F.interpolate + pad"), add)


def block_output_checks(dev, gen, record):
    """The IFBlock output (``ops/block_output.block_output``: the lastconv's
    shuffle, the resize to full resolution, the flow's scale and sum) against
    its plain version, timed beside it (the plain version is the expression
    the kernel replaced: LIBRARY). Summed: the RIFE window's five block
    outputs at 1088x1920, T = 3 (block 0 with no running flow). Checked and
    timed, not summed: the flow pass's block 0 (N = 1), the union's
    auxiliary IFNet at 576x960 and, at -scale 0.5 on 4K, at 1152x1920 with
    scales 32-2, and RIFE at -scale 0.75 (non-integer scales). The kernel
    must equal the plain version bit for bit at integer scales; elsewhere
    within two ulps of each output's largest value, and the flow within two
    ulps of its largest resized product besides (F.interpolate's kernel may
    fuse the bilinear multiply-adds in another order)."""
    import torch

    from drba_tpu_torch import bounds
    from drba_tpu_torch.models.ifnet import LASTCONV_PADDED
    from drba_tpu_torch.ops.block_output import block_output

    f32, bf16 = torch.float32, torch.bfloat16
    T = 3
    half = lambda d: -(-d // 2)  # noqa: E731
    for label, (h, w, scales, summed) in {
            "rife": (H, W, (16.0, 8.0, 4.0, 2.0, 1.0), True),
            "union aux": (HU // 2, W // 2, (16.0, 8.0, 4.0, 2.0, 1.0), False),
            "union 4K aux": (HU, W, (32.0, 16.0, 8.0, 4.0, 2.0), False),
            "rife -scale 0.75": (H, W, tuple(s / 0.75 for s in (16.0, 8.0, 4.0, 2.0, 1.0)),
                                 False)}.items():
        for dt in (f32, bf16):
            ulp = 2 ** -7 if dt == bf16 else 2 ** -23
            flow = (torch.rand(T, h, w, 4, generator=gen, device=dev) * 24 - 12).to(dt)
            cases = [(f"block {i}", T, sc, i > 0, summed) for i, sc in enumerate(scales)]
            cases.append(("flow pass block 0", 1, scales[0], False, False))
            for name, n, sc, chained, add in cases:
                # two stride-2 convs, then the stride-2 transposed conv
                hl, wl = (2 * half(half(int(d / sc))) for d in (h, w))
                lc = (torch.rand(n, LASTCONV_PADDED, hl, wl, generator=gen, device=dev) * 2 - 1
                      ).to(dt).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                fl = flow[:n] if chained else None
                kern = lambda: block_output(lc, sc, fl, (h, w), backend="cuda")
                plain = lambda: block_output(lc, sc, fl, (h, w), backend="torch")
                got, want = kern(), plain()
                what = f"block_output {label} {name} (scale {sc:g}, N {n}) {dt}"
                err = max(float((g.float() - wt.float()).abs().max()) for g, wt in zip(got, want))
                if sc == int(sc):
                    d = sum(int((g.float() != wt.float()).sum()) for g, wt in zip(got, want))
                    print(f"{what}: {d} values differ (max_abs {err:.3e}); must be bit for bit")
                    if d:
                        fail(f"{what}: kernel differs from plain")
                else:
                    fd = block_output(lc, sc, None, (h, w), backend="torch")[0]
                    for part, g, wt in zip(("flow", "mask", "feat"), got, want):
                        tol = 2 * ulp * float(wt.float().abs().max())
                        if part == "flow":
                            tol += 2 * ulp * float(fd.float().abs().max())
                        check_close(f"{what} {part}", g, wt, tol, 0.0,
                                    "two ulps of the largest value: multiply-adds fused in "
                                    "another order")
                work = bounds.block_output_work(n, hl, wl, LASTCONV_PADDED, h, w,
                                                lc.element_size(), chained)
                record("block_output", err, kern, plain, 10, dt, work, summed=add)


def other_designs(n, h, w, cin, cout, dt):
    """The bf16 conv designs that take this shape besides the plan's: each
    is held against the plain version too (not timed)."""
    import torch

    from drba_tpu_torch.ops.conv_chain import conv3x3_path, wgmma_takes

    if dt != torch.bfloat16:
        return []
    plan = conv3x3_path(n, h, w, cin, cout, dt)
    return [p for p in ("mma", "wgmma") if p != plan and (p == "mma" or wgmma_takes(cin, cout))]


def gmfss_conv_checks(dev, gen, record):
    """The conv chain's GMFSS steps at their 1080p shapes (N = T = 3 in
    GridNet, 1 in MetricNet and FeatureNet), each one ``conv_chain`` step
    with its epilogue, against its plain version in f32 and bf16 (f32's
    own chain sites, GridNet's L2 and FeatureNet's levels 2-3, in f32);
    checked and timed, not summed (row 3's sum stays on the RIFE shapes).
    The library call is ``F.conv2d`` with bias (cuDNN; in f32 with TF32
    off, where it runs the L2 shapes by FFT) without the PReLU or the
    residual."""
    import torch
    import torch.nn.functional as F

    from drba_tpu_torch import bounds
    from drba_tpu_torch.ops.conv_chain import chain_step, conv3x3_cuda, conv3x3_path, conv_chain

    f32, bf16 = torch.float32, torch.bfloat16
    # label: (n, h, w, cin, cout, pre-PReLU, residual: none | plain | input |
    # extra); the last four are f32's chain sites only (bf16 runs them on cuDNN)
    f32_only = ("gridnet L2 pre + input", "gridnet head3 384->192 pre", "featurenet L2 pre",
                "featurenet L3 pre")
    for label, (n, h, w, cin, cout, pre, residual) in {
            "gridnet L0 pre + extra": (3, H // 2, W // 2, 64, 64, True, "extra"),
            "gridnet L1 pre + input": (3, H // 4, W // 4, 128, 128, True, "input"),
            "gridnet head 12->64 pre": (3, H // 2, W // 2, 12, 64, True, "none"),
            "gridnet head1 128->64 pre": (3, H // 2, W // 2, 128, 64, True, "none"),
            "gridnet head2 256->128 pre": (3, H // 4, W // 4, 256, 128, True, "none"),
            "gridnet tail 64->256 pre": (3, H // 2, W // 2, 64, 256, True, "none"),
            "metricnet in 14->64": (1, H // 2, W // 2, 14, 64, False, "none"),
            "metricnet pre + plain res": (1, H // 2, W // 2, 64, 64, True, "plain"),
            "metricnet out 64->2 pre": (1, H // 2, W // 2, 64, 2, True, "none"),
            "featurenet L1 pre": (1, H // 2, W // 2, 64, 64, True, "none"),
            "union head0 9->64 pre": (3, HU // 2, W // 2, 9, 64, True, "none"),
            "union L0 pre + extra": (3, HU // 2, W // 2, 64, 64, True, "extra"),
            "gridnet L2 pre + input": (3, H // 8, W // 8, 192, 192, True, "input"),
            "gridnet head3 384->192 pre": (3, H // 8, W // 8, 384, 192, True, "none"),
            "featurenet L2 pre": (1, H // 4, W // 4, 128, 128, True, "none"),
            "featurenet L3 pre": (1, H // 8, W // 8, 192, 192, True, "none")}.items():
        for dt in (f32,) if label in f32_only else (f32, bf16):
            bound = 1.0 / (9 * cin) ** 0.5
            x = (torch.rand(n, h, w, cin, generator=gen, device=dev) * 2 - 1).to(dt)
            res = (torch.rand(n, h, w, cout, generator=gen, device=dev) * 2 - 1).to(dt) \
                if residual == "extra" else None
            st = chain_step(
                ((torch.rand(cout, cin, 3, 3, generator=gen, device=dev) * 2 - 1) * bound).to(dt),
                ((torch.rand(cout, generator=gen, device=dev) * 2 - 1) * 0.05).to(dt),
                pre_alpha=torch.tensor(0.25, device=dev).to(dt) if pre else None,
                plain_res=residual == "plain")
            mode = residual if residual in ("input", "extra") else "none"
            kern = lambda: conv_chain(x, [st], mode, res, backend="cuda")
            plain = lambda: conv_chain(x, [st], mode, res, backend="torch")
            tol = (1e-4, 0.0, "f32 sums of 9*Cin terms in another order") if dt == f32 else \
                (2e-2, 2e-2, "bf16 rounding of the conv output and of the residual add")
            want = plain()
            err = check_close(f"conv_chain {label} {tuple(x.shape)}->{cout} {dt} "
                              f"[{conv3x3_path(n, h, w, cin, cout, dt)}]", kern(), want, *tol)
            # the other designs at this shape: one step, its residual the
            # operand the chain hands the kernel
            r = x if residual in ("plain", "input") else res
            for path in other_designs(n, h, w, cin, cout, dt):
                err = max(err, check_close(
                    f"conv_chain {label} {tuple(x.shape)}->{cout} {dt} [{path}, forced]",
                    conv3x3_cuda(x, st.w, st.b, None, st.wp, st.pre_alpha, r, path=path),
                    want, *tol))
            nchw = x.permute(0, 3, 1, 2)  # the NHWC data, channels_last
            record("conv_chain", err, kern, plain, 10, dt,
                   bounds.conv3x3_work(n, h, w, cin, cout, x.element_size(), beta=False,
                                       alpha=pre, res=res is not None),
                   (lambda: F.conv2d(nchw, st.w, st.b, padding=1), "F.conv2d (cuDNN)"),
                   summed=False)


def attention_checks(dev, gen, record):
    """The GMFSS kernels at GMFlow's 1080p shapes (544x960 half resolution:
    scale-0 features 68x120, scale-1 136x240, c = 128), and the (B, L, c)
    window attention at the 720p scale-0 shape."""
    import numpy as np
    import torch

    from drba_tpu_torch import bounds
    from drba_tpu_torch.convert import from_jax_params
    from drba_tpu_torch.models.gmflow_net import (GMFLOW_SPEC, pack_transformer_weights,
                                                  shift_region_labels)
    from drba_tpu_torch.models.layers import init_from_spec
    from drba_tpu_torch.ops.attention import (flash_attention, split_windows, window_attention,
                                              window_attention_nhwc)
    from drba_tpu_torch.ops.attn_layer import (layer_proj_cuda, layer_tail_cuda, layer_weights,
                                               layer_window_attention, transformer_layer)

    f32, bf16 = torch.float32, torch.bfloat16

    def attn_tol(dt):
        if dt == f32:
            return 2e-5, 0.0, "f32 sums of 128-deep products and the softmax in another order"
        return 2e-2, 2e-2, ("bf16 P in the tensor-core P.V (2^-9 relative per weight) and "
                            "the output's bf16 rounding (2^-8)")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def windows(t, ks):
        """(B, H, W, c) -> (B k^2, 1, L, c) contiguous, for SDPA"""
        s = split_windows(t, ks)
        return s.reshape(s.shape[0], 1, -1, s.shape[-1]).contiguous()

    def same_label(lab, b):
        """(b * windows, 1, L, L) bool: True where query and key share a label"""
        lab = torch.as_tensor(np.asarray(lab).reshape(-1, np.asarray(lab)[0].size), device=dev)
        return (lab[:, :, None] == lab[:, None, :]).repeat(b, 1, 1)[:, None]

    def sdpa(q, k, v, mask):
        fn, name = sdpa_call(q, k, v, mask)
        return fn, f"SDPA {name}"

    # NHWC windows at scale 0: (2, 68, 120, 128), 2x2 windows of 34x60 (L = 2040)
    # (summed); GMFSS_UNION's (2, 72, 120, 128), windows of 36x60 (L = 2160)
    # (not summed)
    for fh, summed in ((68, True), (72, False)):
        lab0 = shift_region_labels(fh, 120, 2)
        L0 = fh // 2 * 60
        pairs0 = 2 * bounds.live_pairs(lab0.reshape(4, -1))
        for masked in (False, True):
            for dt in (f32, bf16):
                q, k, v = (randn(2, fh, 120, 128).to(dt) for _ in range(3))
                kern = lambda: window_attention_nhwc(q, k, v, 2, lab0, masked, backend="cuda")
                plain = lambda: window_attention_nhwc(q, k, v, 2, lab0, masked, backend="torch")
                err = check_close(f"window nhwc (2,{fh},120,128) k=2 mask={masked} {dt}", kern(),
                                  plain(), *attn_tol(dt))
                work = bounds.attention_work(8, L0, q.element_size(),
                                             pairs=pairs0 if masked else None,
                                             labels=fh * 120 if masked else 0)
                record("window_attention", err, kern, plain, 5, dt, work,
                       sdpa(windows(q, 2), windows(k, 2), windows(v, 2),
                            same_label(lab0, 2) if masked else None), summed)

    # the window kernel alone at scale 1, as the transformer layer's cross
    # layer calls it: interleaved q|k|v rows (stride 3c), keys and values from
    # the other batch half (half = 2), shift labels; (4, 136, 240) k = 8,
    # windows of 17x30 (L = 510) (summed); GMFSS_UNION's (4, 144, 240),
    # windows of 18x30 (L = 540) (not summed)
    for fh, summed in ((136, True), (144, False)):
        lab1 = shift_region_labels(fh, 240, 8)
        pairs1 = 4 * bounds.live_pairs(lab1.reshape(64, -1))
        for dt in (f32, bf16):
            qkv = randn(4, fh, 240, 384).to(dt)
            q, k, v = qkv.split(128, dim=-1)
            swap = lambda t: torch.cat([t[2:], t[:2]])
            kern = lambda: layer_window_attention(qkv, 8, lab1, True, cross_swap=True)
            plain = lambda: window_attention_nhwc(q, swap(k), swap(v), 8, lab1, True,
                                                  backend="torch")
            err = check_close(f"window in layer (4,{fh},240,3x128) k=8 swap, masked {dt}",
                              kern(), plain(), *attn_tol(dt))
            work = bounds.attention_work(256, fh // 8 * 30, qkv.element_size(), pairs=pairs1,
                                         labels=fh * 240,
                                         qkv_bytes=qkv.numel() * qkv.element_size())
            record("window_attention", err, kern, plain, 5, dt, work,
                   sdpa(windows(q, 8), windows(swap(k), 8), windows(swap(v), 8),
                        same_label(lab1, 4)), summed)

    # (B, L, c) windows with region ids at the 720p scale-0 shape: 48x80
    # features, 2x2 windows of 24x40 (L = 960), two images
    lab720 = shift_region_labels(48, 80, 2).reshape(4, 960)
    rid = torch.as_tensor(lab720, device=dev).repeat(2, 1)
    for dt in (f32, bf16):
        q, k, v = (randn(8, 960, 128).to(dt) for _ in range(3))
        kern = lambda: window_attention(q, k, v, rid, True, backend="cuda")
        plain = lambda: window_attention(q, k, v, rid, True, backend="torch")
        err = check_close(f"window (8,960,128) region ids {dt}", kern(), plain(), *attn_tol(dt))
        work = bounds.attention_work(8, 960, q.element_size(),
                                     pairs=2 * bounds.live_pairs(lab720), labels=8 * 960)
        record("window_attention", err, kern, plain, 5, dt, work,
               sdpa(q[:, None], k[:, None], v[:, None], same_label(lab720, 2)))

    # flash: global correlation (value = the pixel grid, f32 out), one
    # direction (B = 1) and both stacked (B = 2), L = 68 * 120 = 8160
    # (summed) and GMFSS_UNION's L = 72 * 120 = 8640 (not summed); B = 1 in
    # bf16 splits the keys (two launches); and with region ids
    for fh, summed in ((68, True), (72, False)):
        L = fh * 120
        gy, gx = torch.meshgrid(torch.arange(float(fh), device=dev),
                                torch.arange(120.0, device=dev), indexing="ij")
        grid = torch.stack([gx, gy], dim=-1).reshape(1, L, 2)
        # the scale-0 shift regions (9) in raster order
        rid_l = torch.as_tensor(shift_region_labels(fh, 120, 2).reshape(2, 2, fh // 2, 60)
                                .transpose(0, 2, 1, 3).reshape(1, L), device=dev)
        for b in (1, 2):
            for masked in (False, True):
                for dt in (f32, bf16):
                    q, k = (randn(b, L, 128, scale=0.3).to(dt) for _ in range(2))
                    v = grid.expand(b, L, 2)
                    rid = rid_l.expand(b, L) if masked else None
                    kern = lambda: flash_attention(q, k, v, rid, masked, out_dtype=f32,
                                                   backend="cuda")
                    plain = lambda: flash_attention(q, k, v, rid, masked, out_dtype=f32,
                                                    backend="torch")
                    err = check_close(f"flash ({b},{L},128)/({b},{L},2) mask={masked} {dt}",
                                      kern(), plain(), 2e-3, 1e-5,
                                      f"P.V in f32 on both sides: sums of {L} weights of pixel "
                                      "coordinates <= 119 in another order")
                    pairs = b * bounds.live_pairs(rid_l.cpu().numpy()) if masked else None
                    work = bounds.attention_work(b, L, q.element_size(), value_width=2,
                                                 pairs=pairs, labels=b * L if masked else 0)
                    library = None
                    if not masked:  # SDPA with the value zero-padded, in q's dtype
                        best = None
                        for width in (8, 128):
                            vp = torch.zeros(b, 1, L, width, dtype=dt, device=dev)
                            vp[..., :2] = v[:, None].to(dt)
                            fn, name = sdpa_call(q[:, None], k[:, None], vp)
                            t = timed(fn, 3)
                            if best is None or t < best[0]:
                                best = (t, fn, f"SDPA {name}, value padded to {width}")
                        library = best[1:]
                    record("flash_attention", err, kern, plain, 5, dt, work, library, summed)

    # transformer layers: scale 1 (4, 136, 240, 128) k = 8 (windows 17x30,
    # L = 510) and scale 0 (2, 68, 120, 128) k = 2 (summed), GMFSS_UNION's
    # (4, 144, 240) and (2, 72, 120) (not summed); a self layer (no FFN,
    # unmasked) and a cross layer (FFN, shift mask, batch-half swap, target);
    # weights packed once, as GMFSS packs them
    params = from_jax_params(init_from_spec(GMFLOW_SPEC, seed=0), GMFLOW_SPEC)
    packed = {dt: pack_transformer_weights({kk: vv.to(dev, dt) for kk, vv in params.items()})
              for dt in (f32, bf16)}
    for (b, h, w, ks, summed) in ((4, 136, 240, 8, True), (2, 68, 120, 2, True),
                                  (4, 144, 240, 8, False), (2, 72, 120, 2, False)):
        lab = shift_region_labels(h, w, ks)
        for cross in (False, True):
            base = f"transformer.layers.1.{'cross_attn_ffn' if cross else 'self_attn'}"
            for dt in (f32, bf16):
                wt = layer_weights(packed[dt], base, cross)
                ffn = wt.ffn
                x, tgt = (randn(b, h, w, 128, scale=0.5).to(dt) for _ in range(2))
                kw = dict(labels=lab, with_mask=cross, cross_swap=cross,
                          target=tgt if cross else None)
                kern = lambda: transformer_layer(x, wt, ks, backend="cuda", **kw)
                plain = lambda: transformer_layer(x, wt, ks, backend="torch", **kw)
                tol = (1e-4, 1e-4, "f32 sums in another order") if dt == f32 else \
                    (6e-2, 6e-2, "the kernel keeps merge, norms and FFN sum in f32 where the "
                     "plain ops round each to bf16, and rounds P: a few bf16 ulps at |out| ~4")
                err = check_close(f"layer ({b},{h},{w},128) k={ks} "
                                  f"{'cross+ffn masked' if cross else 'self'} {dt}",
                                  kern(), plain(), *tol)
                work = bounds.layer_work(
                    b, h, w, ks, x.element_size(), hidden=ffn[0].shape[1] if cross else 0,
                    cross=cross, pairs=b * bounds.live_pairs(lab.reshape(ks * ks, -1))
                    if cross else None, labels=h * w if cross else 0)
                record("transformer_layer", err, kern, plain, 5, dt, work, summed=summed)
                if summed:  # the three launches alone (not summed)
                    t = tgt if cross else x
                    qkv = layer_proj_cuda(x, t, wt.qkv_p)
                    wkw = dict(labels=lab, with_mask=cross, cross_swap=cross)
                    av = layer_window_attention(qkv, ks, **wkw)
                    split = [timed(fn, 5) for fn in (lambda: layer_proj_cuda(x, t, wt.qkv_p),
                                                     lambda: layer_window_attention(qkv, ks, **wkw),
                                                     lambda: layer_tail_cuda(x, av, wt))]
                    print(f"    split {dt} (not summed): projection {split[0]:.4f} ms, window "
                          f"{split[1]:.4f} ms, tail {split[2]:.4f} ms")


MODELS = {"rife": "RIFE IFNet 4.26-heavy",
          "gmfss": "GMFSS (GMFlow, MetricNet, FeatureNet, GridNet)",
          "gmfss_union": "GMFSS_UNION (union GMFSS nets + half-resolution IFNet 4.26-heavy)"}


def n_params(model) -> int:
    """Parameters of ``model``, without the kernels' packed copies (.wp)."""
    trees = [getattr(model, t) for t in model.PARAM_TREES]
    nets = [p for tree in trees for p in ([tree] if isinstance(tree, dict) else tree)]
    return sum(v.numel() for p in nets for k, v in p.items() if not k.endswith(".wp"))


def phase_slice(name, dev, scdet=False, uhd=False):
    """run_pipeline with model ``name`` on the kernel path (``scdet``: RIFE
    with scene detection on a stream whose frame 4 alone is colour-inverted;
    ``uhd``: 4K frames at ``-scale 0.5``); returns the launch counts of that
    run."""
    import torch

    from drba_tpu_torch import _build, graphs
    from drba_tpu_torch.pipeline import planned_outputs, run_pipeline

    path = "scdet" if scdet else "uhd" if uhd else name
    src = UHD if uhd else (1080, 1920)
    model = make_model(name, dev, scale=0.5 if uhd else 1.0)
    size = padded_size(model, src)
    n_frames = N_UHD if uhd else N_FRAMES[path]
    checked = {"frames": 0}

    def finite(frames):
        for f in frames:
            if tuple(f.shape) != (1, *size, 3) or not bool(torch.isfinite(f).all()):
                fail(f"{path} window frame shape {tuple(f.shape)} (model size {size}) "
                     "or non-finite values")
        checked["frames"] += len(frames)
        return frames

    ts_fn, drba_fn = model.inference_ts, model.inference_ts_drba

    def checked_ts(*a, **k):  # a scene cut's window asks for the reuse back
        r = ts_fn(*a, **k)
        return (finite(r[0]), r[1]) if k.get("return_reuse") else finite(r)

    model.inference_ts = checked_ts
    model.inference_ts_drba = lambda *a, **k: (lambda r: (finite(r[0]), r[1]))(drba_fn(*a, **k))

    io = _FrameIO(synthetic_frames(N_UHD, *UHD) if uhd else stream(path))
    _build.reset_counts()
    t0 = time.perf_counter()
    try:
        stats = run_pipeline(model, io, enable_scdet=scdet, scdet_threshold=0.3)
        torch.cuda.synchronize()
    finally:
        del model.inference_ts, model.inference_ts_drba  # back to the class methods
    wall = time.perf_counter() - t0
    counts = _build.counts()

    plan = planned_outputs(n_frames, SRC_FPS, DST_FPS)
    what = " (scene detection, -s -st 0.3)" if scdet else " (4K, -scale 0.5)" if uhd else ""
    print(f"slice{what}: {MODELS[name]}, "
          f"{n_params(model)} params (seed 0), bf16, {n_frames} frames {src[0]}p at "
          f"{size[0]}x{size[1]} {SRC_FPS:g}->{DST_FPS:g}: frames_out {stats.frames_out} "
          f"(plan {plan}), {stats.windows} windows, {stats.scene_cuts} scene cuts, "
          f"{checked['frames']} frames checked finite, wall {wall:.2f} s "
          "(first run, includes warm-up)")
    print(f"slice {path}: kernel launches during the run: {counts}")
    print(f"slice {path}: graphs {graph_entries(model)}")
    if not any(e.replays for key, e in graphs.state(model).entries.items()
               if key[0] == "window"):
        fail(f"{path}: no window replayed a captured graph")
    if stats.frames_out != plan or len(io.written) != plan:
        fail(f"{path}: frames_out {stats.frames_out} / written {len(io.written)} != plan {plan}")
    if scdet and stats.scene_cuts != 2:
        fail(f"scdet: {stats.scene_cuts} scene cuts, expected 2")
    # the head's and the tail's source frames skip the model, and so do the
    # cut windows' source frames
    if not scdet and checked["frames"] < plan - 2:
        fail(f"{path}: fewer model frames checked than planned")
    for f in io.written:
        if f.shape != (*src, 3) or str(f.dtype) != "uint8":
            fail(f"{path}: written frame {f.shape} {f.dtype}")
    for k in PATH_KERNELS[path]:
        if counts[k] == 0:
            fail(f"kernel {k} was not launched on the {path} path")
    return counts


def eager_window(m, I0, I1, I2, ts, reuse):
    """The eager pieces ``inference_ts_drba`` runs as one graph on the card:
    the window's pass (with the chain's features), then its timesteps (the
    model's ``_fused_window``, called directly: no graph)."""
    from drba_tpu_torch import graphs

    host = graphs.host_timesteps(ts)
    out, nxt = m._fused_window(I0, I1, I2, m._ts(host), host, reuse, True)
    return list(out.unbind(0)), nxt


def graph_entries(m) -> str:
    """Model ``m``'s captured graphs by kind (``graphs.py``): each entry's T
    (or, for a pass, which features it takes), replays and pool."""
    from drba_tpu_torch import graphs

    parts = []
    for key, e in sorted(graphs.state(m).entries.items(), key=lambda kv: str(kv[0])):
        what = f"features given {key[-1]}" if key[0] == "pass" else f"T={key[1]}"
        parts.append(f"{key[0]} {what}: {e.replays} replays, pool {e.pool_bytes / 2**20:.1f} MiB")
    return "; ".join(parts) or "none"


def phase_window(name, dev, gpu_line, dnames):
    """One window of model ``name`` on the kernel path vs the plain path (in
    each dtype of ``dnames``), the window time both ways, and a profile of one kernel-path
    window's eager pieces. GMFSS and GMFSS_UNION are also timed with
    ``conv_backend="torch"`` alone: every conv on cuDNN (the union's IFNet
    too), the other kernels launched. The graphed window against its eager
    pieces (both dtypes), and in bf16 both timed and profiled
    (``graph_vs_eager``). In f32, GMFSS's and GMFSS_UNION's windows are
    timed both ways (``time_f32_paths``) and one replay profiled
    (``profile_f32_replay``). Returns the kernel-path window's launch counts
    per dtype."""
    import torch

    from drba_tpu_torch import _build
    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper, to_inp

    frames = synthetic_frames(3)
    tmap = TMapper(SRC_FPS, DST_FPS)
    ts2, ts3 = calc_ts(1, tmap, -1), calc_ts(0, tmap, -1)  # 24 -> 60 alternates T = 2, 3
    plain_cfg = dict(splat_backend="torch", warp_backend="torch", conv_backend="torch")
    if name != "rife":
        plain_cfg["attn_backend"] = "torch"

    launches = {}
    for dname in dnames:
        extra = {} if dname == "bf16" else {"compute_dtype": torch.float32}
        # same seed, same parameters; only the backends differ
        m = make_model(name, dev, **extra)
        plain = make_model(name, dev, **extra, **plain_cfg)
        size = padded_size(m)
        I0, I1, I2 = (to_inp(f, size, m.config.compute_dtype, dev) for f in frames)
        reuse = m.reuse(I1, I0)
        # the plain path's eager pieces (no graph of its own: in f32 the
        # plain window's graph would not fit beside the kernel path's), then
        # the kernel path's first call, which runs the window eagerly and
        # captures its T=3 graph
        out_p = torch.stack(eager_window(plain, I0, I1, I2, ts3, reuse)[0])
        f32_timed = dname == "f32" and name != "rife"
        if f32_timed:  # before any graph: its f32 pool would crowd the eager windows
            time_f32_paths(name, {"plain eager": plain, "kernel eager": m},
                           lambda mm, ts: eager_window(mm, I0, I1, I2, ts, reuse), (ts2, ts3),
                           gpu_line)
        torch.cuda.empty_cache()
        _build.reset_counts()
        out_k = torch.stack(m.inference_ts_drba(I0, I1, I2, ts3, reuse, linear=True)[0])
        if not torch.isfinite(out_k).all():
            fail(f"{name} window {dname}: non-finite output")
        d = (out_k.float() - out_p.float()).abs()
        mx, mean, share = float(d.max()), float(d.mean()), float((d > 1e-2).float().mean())
        print(f"window {name} {dname} (T={len(ts3)}, {size[0]}x{size[1]}): kernel vs plain path "
              f"max_abs {mx:.3e}  mean_abs {mean:.3e}  share(>1e-2) {share:.3e}")
        mean_tol, share_tol = GATES[dname]
        if mean > mean_tol or share > share_tol:
            fail(f"{name} {dname} window kernel vs plain: mean {mean:.3e} (tol {mean_tol:g}), "
                 f"share(>1e-2) {share:.3e} (tol {share_tol:g})")
        # the call above captured the T=3 graph; this one replays it
        out_g = torch.stack(m.inference_ts_drba(I0, I1, I2, ts3, reuse, linear=True)[0])
        out_e = torch.stack(eager_window(m, I0, I1, I2, ts3, reuse)[0])
        d = (out_g.float() - out_e.float()).abs()
        mx, mean, share = float(d.max()), float(d.mean()), float((d > 1e-2).float().mean())
        print(f"window {name} {dname} (T={len(ts3)}): graph replay vs eager pieces "
              f"max_abs {mx:.3e}  mean_abs {mean:.3e}  share(>1e-2) {share:.3e}")
        if not torch.isfinite(out_g).all() or mean > mean_tol or share > share_tol:
            fail(f"{name} {dname} graph vs eager: mean {mean:.3e} (tol {mean_tol:g}), "
                 f"share(>1e-2) {share:.3e} (tol {share_tol:g})")
        launches[dname] = _build.counts()  # the kernel path's windows: eager, capture, replay
        print(f"window {name} {dname}: kernel launches of the kernel-path window (eager and "
              f"captured T=3, one replay, its eager pieces): {launches[dname]}")
        if f32_timed:
            for k in F32_ROWS:
                if launches[dname][k] == 0:
                    fail(f"{name} f32 window: kernel {k} was not launched")
            time_f32_paths(name, {"kernel graphed": m},
                           lambda mm, ts: mm.inference_ts_drba(I0, I1, I2, ts, reuse, linear=True),
                           (ts2, ts3), gpu_line)
            profile_f32_replay(name, lambda: m.inference_ts_drba(I0, I1, I2, ts3, reuse,
                                                                 linear=True))
        if dname == "bf16":
            runs = [("plain", plain), ("kernel", m)]
            if name != "rife":
                runs.append(("cuDNN convs", make_model(name, dev, conv_backend="torch")))
            time_paths(name, runs, (I0, I1, I2), reuse, (ts2, ts3), gpu_line)
            del runs
            eager_kernels = profile_window(name, lambda: eager_window(m, I0, I1, I2, ts3, reuse))
            graph_vs_eager(name, m, (I0, I1, I2), reuse, (ts2, ts3), eager_kernels, gpu_line)
            calls_vs_eager(name, m, (I0, I1, I2), reuse, gpu_line)
        # each model's graphs hold their memory pools until the model goes
        del m, plain
        torch.cuda.empty_cache()
    return launches


def time_f32_paths(name, models, window, ts_pair, gpu_line):
    """f32 windows at T = 2 and 3, each (label, model) of ``models`` through
    ``window(model, ts)``, in turns (CUDA events). The plain path's and the
    kernel path's eager pieces are the like-for-like pair (no f32 plain
    graph fits beside the kernel path's) and are timed before any f32
    graph exists; the kernel path's graph after its capture."""
    times = {}
    for way in [*models, *reversed(models)]:  # each twice, in turns
        for ts in ts_pair:
            times.setdefault((way, len(ts)), []).append(  # f32 windows take ~1 s
                timed(lambda: window(models[way], ts), 2, warmup=1))
    for way in models:
        t2, t3 = (sum(times[(way, n)]) / 2 for n in (2, 3))
        print(f"window {name} f32 1080p {way} (steady state, reuse chained): T=2 {t2:.2f} ms, "
              f"T=3 {t3:.2f} ms, {5e3 / (t2 + t3):.2f} fps over a T=2+3 pair  [{gpu_line}]")


def phase_f32(dev):
    """Last, after the earlier phases' pools are freed: what holds an f32
    GMFSS and an f32 GMFSS_UNION graph's pool, from each first capture with
    the allocator's history on (``pool_holders``)."""
    import torch

    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper, to_inp

    ts3 = calc_ts(0, TMapper(SRC_FPS, DST_FPS), -1)
    for name in ("gmfss", "gmfss_union"):
        m = make_model(name, dev, compute_dtype=torch.float32)
        I0, I1, I2 = (to_inp(f, padded_size(m), torch.float32, dev) for f in synthetic_frames(3))
        reuse = m.reuse(I1, I0)
        torch.cuda.empty_cache()
        torch.cuda.memory._record_memory_history(max_entries=200000, stacks="python")
        try:
            m.inference_ts_drba(I0, I1, I2, ts3, reuse, linear=True)  # eager warm-up, capture
            pool_holders(name, m, torch.cuda.memory._snapshot())
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        del m, reuse
        torch.cuda.empty_cache()


def profile_f32_replay(name, fn):
    """One steady-state f32 window (a graph replay) under torch.profiler:
    its device time and top kernels; fails unless every window, flash and
    layer launch the capture recorded ran the 3xTF32 kernels, every conv
    launch ran the f32 conv design (``conv3x3_tf32_kernel``, the plan's for
    f32), and no cuDNN FFT convolution ran. A replay launches the same
    kernels each time, so where the profiler lost events (fewer launches
    than the capture recorded, a foreign design or an FFT kernel aside) the
    replay is profiled once more."""
    from drba_tpu_torch import _build

    _build.reset_counts()
    fn()  # the launches a replay adds: its capture's
    launches = _build.counts()
    for attempt in (1, 2):
        wall, busy, kernels = profile_call(fn)
        ran = {n: sum(e.count for e in kernels if f"::{n}" in e.key)
               for n in ("attn_tf32_kernel", "flash_combine_kernel", "layer_proj_tf32_kernel",
                         "layer_tail_tf32_kernel", "conv3x3_tf32_kernel")}
        convs = sum(e.count for e in kernels if "::conv3x3_" in e.key)
        fft = Counter({e.key[:90]: e.count for e in kernels
                       if any(mark in e.key.lower() for mark in FFT_MARKS)})
        print(f"profile {name} f32 graph replay T=3: wall {wall:.2f} ms, device busy {busy:.2f} "
              f"ms, {sum(e.count for e in kernels)} device kernels; 3xTF32 kernels (profiler) "
              f"{ran}, all conv kernels {convs}, cuDNN FFT kernels {sum(fft.values())}; the "
              f"replay's recorded launches {launches}; top device kernels:")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
        if fft:
            fail(f"{name} f32 window: cuDNN FFT convolutions ran: {dict(fft)}")
        if ran["conv3x3_tf32_kernel"] != convs:
            fail(f"{name} f32 window: {convs} conv kernels ran, {ran['conv3x3_tf32_kernel']} of "
                 f"them the f32 design")
        attn = (launches["window_attention"] + launches["flash_attention"]
                - ran["flash_combine_kernel"])
        if attn > 0 and ran["attn_tf32_kernel"] == attn and convs == launches["conv_chain"] \
                and ran["layer_proj_tf32_kernel"] + ran["layer_tail_tf32_kernel"] == \
                launches["transformer_layer"]:
            return
        if attempt == 1:
            print(f"profile {name} f32: fewer launches than the replay recorded (the profiler "
                  "lost events); profiling the replay again")
    fail(f"{name} f32 window: the 3xTF32 kernels ran {ran} ({convs} conv kernels), the replay "
         f"launched {launches}")


def pool_holders(name, m, snap):
    """What holds model ``m``'s graph pool after its first capture, from an
    allocator snapshot taken with the history on: the pool's segments, its
    live and free bytes, and the allocations that grew it (cudaMalloc'd
    segments) by the port's source line that asked for them."""
    from drba_tpu_torch import graphs

    pool = tuple(graphs.state(m).pool())
    segs = [sg for sg in snap["segments"] if tuple(sg.get("segment_pool_id", ())) == pool]
    total = sum(sg["total_size"] for sg in segs)
    live = sum(b["size"] for sg in segs for b in sg["blocks"] if b["state"].startswith("active"))
    sizes = sorted((sg["total_size"] for sg in segs), reverse=True)
    print(f"pool {name} f32 after the T=3 capture: {len(segs)} segments, {total} bytes "
          f"({total / 2**30:.2f} GiB): {live / 2**30:.2f} GiB live (the graph's outputs and "
          f"buffers it keeps), {(total - live) / 2**30:.2f} GiB free inside the pool; largest "
          f"segments (MiB) {[round(x / 2**20) for x in sizes[:12]]}")

    def site(frames):  # the port's three innermost frames
        own = [f for f in frames if "drba_tpu_torch" in f["filename"]][:3]
        if not own:
            return "unknown"
        return " < ".join(f"{f['filename'].split('drba_tpu_torch/')[-1]}:{f['line']} {f['name']}"
                          for f in own)

    grown = Counter()
    addrs = {sg["address"] for sg in segs}
    for ev in (ev for trace in snap.get("device_traces", []) for ev in trace):
        if ev["action"] == "segment_alloc" and ev["addr"] in addrs:
            grown[site(ev.get("frames", []))] += ev["size"]
    print(f"pool {name} f32: bytes of the segments each site's allocation grew it by "
          f"(top 12 of {len(grown)}):")
    for where, n in grown.most_common(12):
        print(f"  {n / 2**30:7.3f} GiB  {where}")


def time_paths(name, runs, frames, reuse, ts_pair, gpu_line):
    """Steady-state windows of each (label, model) of ``runs`` through its
    graphs, at T = 2 and 3, in turns (CUDA events)."""
    times = {}
    for label, mm in runs + runs[::-1]:
        for ts in ts_pair:
            t = timed(lambda: mm.inference_ts_drba(*frames, ts, reuse, linear=True), 5)
            times.setdefault((label, len(ts)), []).append(t)
    for label, _ in runs[::-1]:
        t2, t3 = (sum(times[(label, n)]) / 2 for n in (2, 3))
        print(f"window {name} bf16 1080p {label} path (graphed, steady state, reuse "
              f"chained): T=2 {t2:.2f} ms, T=3 {t3:.2f} ms, {5e3 / (t2 + t3):.2f} fps over "
              f"a T=2+3 pair  [{gpu_line}]")


def profile_call(fn, warm: bool = True):
    """One call of ``fn`` under torch.profiler, after a warm call where
    ``warm``: (wall ms of the call with its synchronise, device-busy ms,
    device kernels). Device kernels are the entries with device time and no
    host time of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    return wall, sum(e.self_device_time_total for e in kernels) / 1e3, kernels


def own_launches(kernels) -> int:
    """Launches of the hand-written kernels among profiled device kernels."""
    return sum(e.count for e in kernels if any(f"::{n}" in e.key for n in DEVICE_KERNELS))


def graph_vs_eager(name, m, frames, reuse, ts_pair, eager_kernels, gpu_line):
    """One steady-state window through the graph (``inference_ts_drba``,
    a replay) and through its eager pieces, bf16, at T = 2 and 3: ms a
    window back to back (CUDA events, in turns), then per single window its
    wall (host clock around the call and a synchronise), its host time (the
    call's return), its device-busy time (torch.profiler) and idle share
    (1 - busy / wall); and each captured graph's memory pool."""
    from drba_tpu_torch import graphs

    ways = {"graph": lambda ts: m.inference_ts_drba(*frames, ts, reuse, linear=True),
            "eager": lambda ts: eager_window(m, *frames, ts, reuse)}
    ev = {}
    for way in ("graph", "eager", "eager", "graph"):  # each side twice, in turns
        for ts in ts_pair:
            ev.setdefault((way, len(ts)), []).append(timed(lambda: ways[way](ts), 5))
    for ts in ts_pair:
        for way, fn in ways.items():
            wall_ms, host_ms, p_wall, busy, kernels = single_calls(lambda: fn(ts))
            ev_ms = sum(ev[(way, len(ts))]) / 2
            print(f"window {name} bf16 1080p T={len(ts)} {way}: {ev_ms:.2f} ms a window back to "
                  f"back (CUDA events, in turns); one window: wall {wall_ms:.2f} ms, host "
                  f"{host_ms:.2f} ms, device busy {busy:.2f} ms, idle "
                  f"{100 * (1 - busy / wall_ms):.1f}% (profiled call: wall {p_wall:.2f} ms, "
                  f"idle {100 * (1 - busy / p_wall):.1f}%)  [{gpu_line}]")
            if way == "graph" and len(ts) == 3:
                print(f"profile {name} graph replay T=3: the profiler reports "
                      f"{own_launches(kernels)} launches of the hand-written kernels (eager "
                      f"pieces: {own_launches(eager_kernels)}); top device kernels:")
                for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
                    print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
                          f"{e.key[:90]}")
    for key, e in graphs.state(m).entries.items():
        if key[0] == "window":
            print(f"window {name} graph T={key[1]} {key[2][1]}x{key[2][2]} {key[3]}: pool "
                  f"{e.pool_bytes} bytes ({e.pool_bytes / 2**20:.1f} MiB), launches a replay "
                  f"{dict(e.launches)}")


def single_calls(fn, n: int = 5):
    """Single calls of ``fn``, each from an idle card: (wall ms with its
    synchronise, host ms until it returns, both over ``n`` calls; then one
    profiled call's wall ms, device-busy ms and device kernels)."""
    import torch

    host, wall = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    p_wall, busy, kernels = profile_call(fn)
    return sum(wall) / n, sum(host) / n, p_wall, busy, kernels


def gated(label, got, want):
    """``got`` against ``want`` (tensors or trees of them) under the bf16
    gate; returns (max abs, mean abs, share off by more than 1e-2)."""
    import torch

    from drba_tpu_torch.graphs import _leaves

    def flat(x):  # a list of frames, a (T, ...) tensor or a reuse
        return torch.cat([t.float().reshape(-1) for t in _leaves(tuple(x) if isinstance(
            x, list) else x)])

    g, w = flat(got), flat(want)
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        fail(f"{label}: {tuple(g.shape)} values against {tuple(w.shape)}, or non-finite")
    d = (g - w).abs()
    mx, mean, share = float(d.max()), float(d.mean()), float((d > 1e-2).float().mean())
    mean_tol, share_tol = GATES["bf16"]
    if mean > mean_tol or share > share_tol:
        fail(f"{label}: mean {mean:.3e} (tol {mean_tol:g}), share(>1e-2) {share:.3e} (tol "
             f"{share_tol:g})")
    return mx, mean, share


def calls_vs_eager(name, m, frames, reuse, gpu_line):
    """drba_tpu's other programs as graphs against their eager bodies, bf16:
    ``inference_ts`` at T = 1 and 2 on a given reuse (``plain``), the chain
    start's ``pass``, and for GMFSS and GMFSS_UNION ``inference_ts`` without
    a reuse (a ``pass``, then a ``plain`` call). Each warmed (its first call
    eager, its second captures), then: outputs within the bf16 gate, the
    hand-written kernel launches of a replay equal to the eager call's (the
    launch counters; the profiler's count printed beside), ms back to back
    (CUDA events, in turns), and per single call wall, host and device-busy
    ms, idle share; the host ms of every replay below the eager call's."""
    from drba_tpu_torch import _build

    I0, I1, _ = frames
    r01 = reuse.swapped() if m.PLAIN_PASS else None  # the I0 -> I1 pass

    def plain(ts):
        return lambda: m._plain(I0, I1, m._ts(ts), r01)

    calls = {"inference_ts T=1": (lambda: m.inference_ts(I0, I1, [0.4], reuse=r01),
                                  plain([0.4])),
             "inference_ts T=2": (lambda: m.inference_ts(I0, I1, [0.2, 0.6], reuse=r01),
                                  plain([0.2, 0.6])),
             "chain-start pass": (lambda: m.reuse(I1, I0), lambda: m._pass(I1, I0))}
    if m.PLAIN_PASS:
        calls["inference_ts T=2, no reuse"] = (
            lambda: m.inference_ts(I0, I1, [0.2, 0.6]),
            lambda: m._plain(I0, I1, m._ts([0.2, 0.6]), m._pass(I0, I1)))
    for label, (graph, eager) in calls.items():
        for _ in range(2):  # a new kind's key: its first call eager, its second captures
            graph()
        mx, mean, share = gated(f"{name} {label} graph vs eager", graph(), eager())
        counts = {}
        for way, fn in (("graph", graph), ("eager", eager)):
            _build.reset_counts()
            fn()
            counts[way] = _build.counts()
        if counts["graph"] != counts["eager"]:
            fail(f"{name} {label}: a replay launched {counts['graph']}, the eager call "
                 f"{counts['eager']}")
        ev = {}
        for way, fn in (("graph", graph), ("eager", eager), ("eager", eager), ("graph", graph)):
            ev.setdefault(way, []).append(timed(fn, 5))
        host = {}
        for way, fn in (("graph", graph), ("eager", eager)):
            wall_ms, host[way], p_wall, busy, kernels = single_calls(fn)
            print(f"call {name} bf16 1080p {label} {way}: {sum(ev[way]) / 2:.2f} ms back to "
                  f"back (CUDA events, in turns); one call: wall {wall_ms:.2f} ms, host "
                  f"{host[way]:.2f} ms, device busy {busy:.2f} ms, idle "
                  f"{100 * (1 - busy / wall_ms):.1f}%; hand-written launches (profiler) "
                  f"{own_launches(kernels)}  [{gpu_line}]")
        print(f"call {name} {label}: graph vs eager max_abs {mx:.3e}  mean_abs {mean:.3e}  "
              f"share(>1e-2) {share:.3e}; launches a call {counts['graph']}")
        if host["graph"] >= host["eager"]:
            fail(f"{name} {label}: a replay's host time {host['graph']:.2f} ms is not below "
                 f"the eager call's {host['eager']:.2f} ms")
    print(f"call {name}: graphs {graph_entries(m)}")


def profile_window(name, fn):
    """Device time by op for one call of ``fn`` (the eager pieces of a
    window) under torch.profiler, the device's busy share of that call's
    wall time, the launches of each hand-written kernel in the call, and
    its conv launches by design against the plan's; returns the profiled
    device kernels."""
    import torch

    from drba_tpu_torch import _build

    conv_chain = importlib.import_module("drba_tpu_torch.ops.conv_chain")

    fn()
    torch.cuda.synchronize()
    # the design the plan gives each conv launch of the profiled call
    planned = Counter()
    conv3x3 = conv_chain.conv3x3_cuda

    def planning_conv3x3(x, w, *a, **k):
        planned[k.get("path") or conv_chain.conv3x3_path(*x.shape, w.shape[0], x.dtype)] += 1
        return conv3x3(x, w, *a, **k)

    conv_chain.conv3x3_cuda = planning_conv3x3
    _build.reset_counts()
    try:
        wall, busy, kernels = profile_call(fn, warm=False)
    finally:
        conv_chain.conv3x3_cuda = conv3x3
    counts = _build.counts()
    print(f"launches in one {name} kernel-path window T=3 (eager pieces): {counts}")
    # the conv kernel's launches by design (device kernel names under the
    # conv3x3_ prefix of DEVICE_KERNELS) against the plan's
    ran = {p: sum(e.count for e in kernels if f"::conv3x3_{p}_kernel" in e.key)
           for p in conv_chain.PATHS}
    print(f"conv launches in one {name} window T=3 by design: ran {ran}, planned "
          f"{dict(planned)}")
    if any(ran[p] != planned.get(p, 0) for p in ran) or \
            sum(ran.values()) != counts["conv_chain"]:
        fail(f"{name} window: conv kernels by design {ran} differ from the plan "
             f"{dict(planned)} or from the launch count {counts['conv_chain']}")
    print(f"profile {name} kernel-path window T=3 (eager pieces): wall {wall:.2f} ms, device "
          f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%), top device kernels:")
    # the twelve largest, then the rest of the hand-written kernels and the
    # memsets (the splat zeroes its accumulator with one)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    own = [e for e in ranked[12:]
           if any(f"::{n}" in e.key for n in DEVICE_KERNELS) or "Memset" in e.key]
    for e in ranked[:12] + own:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return kernels


def frames_vs(label, got, want):
    """Written uint8 frames against a reference run's: bitwise, or the
    bf16 gate on the [0, 1] scale; returns (bitwise, mean, share)."""
    import numpy as np

    if len(got) != len(want):
        fail(f"{label}: {len(got)} frames written against {len(want)}")
    if all(np.array_equal(a, b) for a, b in zip(got, want)):
        return True, 0.0, 0.0
    d = np.stack([np.abs(a.astype(np.float32) - b) / 255.0 for a, b in zip(got, want)])
    return False, float(d.mean()), float((d > 1e-2).mean())


def block_ends(n_frames):
    """Cumulative planned outputs at the end of the head, each window and
    the tail of an ``n_frames`` stream at SRC_FPS -> DST_FPS."""
    from itertools import accumulate

    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper

    tm = TMapper(SRC_FPS, DST_FPS)
    return list(accumulate(len(calc_ts(i, tm, -1)) for i in [0, *range(n_frames - 1)]))


def stream(path, n=None):
    frames = synthetic_frames(n or N_FRAMES[path])
    if path == "scdet":  # the pairs (3, 4) and (4, 5) are cuts
        frames[4] = 255 - frames[4]
    return frames


def phase_resume(dev):
    """``run_pipeline(skip_outputs=k)`` against the uninterrupted run;
    returns the resumed runs' launch counts."""
    import shutil

    import torch

    from drba_tpu_torch import _build
    from drba_tpu_torch.pipeline import planned_outputs, run_pipeline

    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    print(f"resume: skip_outputs driven through run_pipeline on in-memory frames (cv2 "
          f"{'present' if has_cv2 else 'absent'}, ffmpeg "
          f"{'present' if shutil.which('ffmpeg') else 'absent'} here); SegmentedVideoIO, its "
          "manifest and --resume are covered by tests/test_torch_resume.py on the CPU")
    launches = {k.name: 0 for k in _build.KERNELS}
    e10, e6 = block_ends(10), block_ends(6)
    for path, name, points in (
            ("rife", "rife", {"window boundary": e10[3], "inside a window": e10[5] + 1}),
            ("gmfss", "gmfss", {"inside a window": e6[2] + 1}),
            # inside window 4, the first past the cuts (its I0 and I1 cut apart)
            ("scdet", "rife", {"just past a cut": e10[4] + 1})):
        model = make_model(name, dev)
        scdet = path == "scdet"
        plan = planned_outputs(N_FRAMES[path], SRC_FPS, DST_FPS)
        full = []
        for _ in range(2):
            io = _FrameIO(stream(path))
            _build.reset_counts()
            run_pipeline(model, io, enable_scdet=scdet, scdet_threshold=0.3)
            torch.cuda.synchronize()
            full.append((io.written, sum(_build.counts().values())))
        same, mean, share = frames_vs(f"resume {path} two runs", full[1][0], full[0][0])
        print(f"resume {path}: two uninterrupted runs {'bitwise equal' if same else 'differ'}: "
              f"mean {mean:.3e}, share(>1e-2) {share:.3e}; {full[0][1]} launches each")
        for where, k in points.items():
            io = _FrameIO(stream(path))
            _build.reset_counts()
            stats = run_pipeline(model, io, enable_scdet=scdet, scdet_threshold=0.3,
                                 skip_outputs=k)
            torch.cuda.synchronize()
            counts = _build.counts()
            for kk, v in counts.items():
                launches[kk] += v
            if stats.frames_out != plan - k or len(io.written) != plan - k:
                fail(f"resume {path} at {k}: {stats.frames_out} frames written, plan {plan}")
            if sum(counts.values()) >= full[0][1]:
                fail(f"resume {path} at {k}: {sum(counts.values())} launches, not fewer than "
                     f"the uninterrupted run's {full[0][1]}")
            bit, mean, share = frames_vs(f"resume {path} at {k}", io.written, full[0][0][k:])
            print(f"resume {path} at k = {k} ({where}; plan {plan}): {len(io.written)} frames "
                  f"written, {sum(counts.values())} launches; against the uninterrupted tail: "
                  f"{'bitwise equal' if bit else f'mean {mean:.3e}, share(>1e-2) {share:.3e}'}")
            mean_tol, share_tol = GATES["bf16"]
            if (same and not bit) or mean > mean_tol or share > share_tol:
                fail(f"resume {path} at {k}: mean {mean:.3e} share {share:.3e} (two "
                     f"uninterrupted runs {'bitwise equal' if same else 'differ'})")
        del model
        torch.cuda.empty_cache()
    print(f"resume: kernel launches during the resumed runs: {launches}")
    return launches


def phase_scdet_twice(dev, gpu_line):
    """``run_pipeline -s -st 0.3`` twice on one model instance, RIFE and
    GMFSS, over a 16-frame stream whose frames 4 and 10 are colour-inverted
    (four cuts): the first run captures (head, cut windows' ``plain`` calls,
    chain starts' passes, tail, windows); in the second every ``plain``,
    ``pass`` and ``window`` call must replay (no call left eager or
    capturing); the two runs' written frames within the bf16 gate; every
    kernel of the path launched in each run. Returns both runs' launch
    counts."""
    import torch

    from drba_tpu_torch import _build, graphs
    from drba_tpu_torch.pipeline import planned_outputs, run_pipeline

    launches = {k.name: 0 for k in _build.KERNELS}
    n, cuts = 16, (4, 10)
    plan = planned_outputs(n, SRC_FPS, DST_FPS)
    frames = synthetic_frames(n)
    for i in cuts:
        frames[i] = 255 - frames[i]
    for name in ("rife", "gmfss"):
        model = make_model(name, dev)
        st = graphs.state(model)
        written, walls = [], []
        for run in range(2):
            calls = dict(st.calls)
            replays = {k: e.replays for k, e in st.entries.items()}
            io = _FrameIO(frames)
            _build.reset_counts()
            t0 = time.perf_counter()
            stats = run_pipeline(model, io, enable_scdet=True, scdet_threshold=0.3)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = _build.counts()
            for k, v in counts.items():
                launches[k] += v
            for k in PATH_KERNELS[name]:
                if counts[k] == 0:
                    fail(f"scdet twice {name} run {run + 1}: kernel {k} was not launched")
            if stats.frames_out != plan or len(io.written) != plan or \
                    stats.scene_cuts != 2 * len(cuts):
                fail(f"scdet twice {name} run {run + 1}: {stats.frames_out} frames (plan "
                     f"{plan}), {stats.scene_cuts} cuts")
            written.append(io.written)
        by_kind = Counter()
        for key, e in st.entries.items():
            by_kind[key[0]] += e.replays - replays.get(key, 0)
        left = {k[0]: st.calls[k] - calls.get(k, 0) for k in st.calls
                if st.calls[k] != calls.get(k, 0)}
        bit, mean, share = frames_vs(f"scdet twice {name}", written[1], written[0])
        print(f"scdet twice {name} bf16 1080p, {n} frames, frames {cuts} inverted: "
              f"{plan} frames a run, {2 * len(cuts)} cuts; wall {walls[0]:.2f} s (captures) "
              f"then {walls[1]:.2f} s; second run's replays by kind {dict(by_kind)}, calls "
              f"not replayed {left or 'none'}; second run against the first: "
              f"{'bitwise equal' if bit else f'mean {mean:.3e}, share(>1e-2) {share:.3e}'}"
              f"  [{gpu_line}]")
        print(f"scdet twice {name}: graphs {graph_entries(model)}")
        if left or set(by_kind) != {"window", "plain", "pass"} or not all(by_kind.values()):
            fail(f"scdet twice {name}: the second run's calls were not all replays: replays "
                 f"{dict(by_kind)}, calls eager or capturing {left}")
        mean_tol, share_tol = GATES["bf16"]
        if mean > mean_tol or share > share_tol:
            fail(f"scdet twice {name}: mean {mean:.3e} share {share:.3e} between the runs")
        del model, st
        torch.cuda.empty_cache()
    return launches


def replica_graphs(label, planner, must_replay: bool) -> None:
    """Each replica's graphs after a planned run; with ``must_replay`` fail
    where a replica's windows (its ``unfused`` graphs) did not replay."""
    from drba_tpu_torch import graphs

    for k, rep in enumerate(planner.replicas):
        print(f"{label} replica {k}: graphs {graph_entries(rep)}")
        ran = [e.replays for key, e in graphs.state(rep).entries.items() if key[0] == "unfused"]
        if must_replay and not (ran and all(ran)):
            fail(f"{label} replica {k}: its windows did not replay ({graph_entries(rep)})")


def phase_devices(dev, gpu_line):
    """``run_pipeline_parallel`` over two replicas on the one card against
    the serial loop; returns the parallel runs' launch counts."""
    import torch

    from drba_tpu_torch import _build
    from drba_tpu_torch.parallel.batch import WindowPlanner, exchange_accounting
    from drba_tpu_torch.parallel.pipeline import run_pipeline_parallel
    from drba_tpu_torch.pipeline import calc_ts, planned_outputs, run_pipeline
    from drba_tpu_torch.utils import TMapper, to_inp

    import drba_tpu_torch.parallel.pipeline as parallel_pipeline

    launches = {k.name: 0 for k in _build.KERNELS}
    devices = [dev, dev]
    runs = [(p, p if p != "scdet" else "rife", None) for p in N_FRAMES] + \
        [("gmfss", "gmfss", N_TIMING)]
    made = []  # the planners of the two-thread runs, for their replicas' graphs

    class Recorded(WindowPlanner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    for path, name, n in runs:
        model = make_model(name, dev)
        scdet = path == "scdet"
        n_frames = n or N_FRAMES[path]
        plan = planned_outputs(n_frames, SRC_FPS, DST_FPS)
        walls, written = {"serial": [], "two threads": []}, {}
        # serial, two threads, two threads, serial: each side timed twice, in turns
        for i, label in enumerate(("serial", "two threads", "two threads", "serial")):
            io = _FrameIO(stream(path, n_frames))
            _build.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "serial":
                stats = run_pipeline(model, io, enable_scdet=scdet, scdet_threshold=0.3)
            else:
                parallel_pipeline.WindowPlanner = Recorded
                try:
                    stats = run_pipeline_parallel(model, io, devices, enable_scdet=scdet,
                                                  scdet_threshold=0.3)
                finally:
                    parallel_pipeline.WindowPlanner = WindowPlanner
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            if stats.frames_out != plan or len(io.written) != plan:
                fail(f"devices {path} {label}: {stats.frames_out} frames, plan {plan}")
            if i == 1 and n is None:
                counts = _build.counts()
                for kk, v in counts.items():
                    launches[kk] += v
                for kk in PATH_KERNELS[path]:
                    if counts[kk] == 0:
                        fail(f"devices {path}: kernel {kk} was not launched")
                print(f"devices {path}: kernel launches during the two-thread run: {counts}")
            written.setdefault(label, io.written)
            if label != "serial":  # each run replicates the model: its replicas capture anew
                planner = made.pop()  # and their graphs' pools go with them
                if i == 1:  # each replica runs three or more windows of one T only here
                    replica_graphs(f"devices {path}{f' ({n_frames} frames)' if n else ''}",
                                   planner, must_replay=path == "rife" or n is not None)
                del planner
        bit, mean, share = frames_vs(f"devices {path}", written["two threads"], written["serial"])
        fps = {k: plan / (sum(v) / len(v)) for k, v in walls.items()}
        print(f"devices {path}{f' ({n_frames} frames)' if n else ''}: {plan} frames each; two "
              f"threads against serial: "
              f"{'bitwise equal' if bit else f'mean {mean:.3e}, share(>1e-2) {share:.3e}'}; "
              f"wall serial {walls['serial'][0]:.3f}/{walls['serial'][1]:.3f} s "
              f"({fps['serial']:.2f} fps), two threads {walls['two threads'][0]:.3f}/"
              f"{walls['two threads'][1]:.3f} s ({fps['two threads']:.2f} fps), "
              f"{fps['two threads'] / fps['serial']:.3f}x  [{gpu_line}]")
        mean_tol, share_tol = GATES["bf16"]
        if mean > mean_tol or share > share_tol:
            fail(f"devices {path}: mean {mean:.3e} share {share:.3e} against the serial run")
        if path == "gmfss" and n is None:
            size = padded_size(model)
            fr = [to_inp(f, size, model.config.compute_dtype, dev) for f in stream(path)[:4]]
            tm = TMapper(SRC_FPS, DST_FPS)
            windows = [(fr[k], fr[k + 1], fr[k + 2], calc_ts(k, tm, -1)) for k in range(2)]
            planner = WindowPlanner(devices, model)
            try:
                acc = exchange_accounting(planner, windows)
            finally:
                planner.close()
            print(f"devices gmfss: exchange in one group of two 1080p windows: {acc}")
            if acc["carries"] != [(0, 1)] or acc["frames"]:
                fail(f"devices gmfss: exchange {acc}, expected one carry and no frame")
            window_threads(model, devices, gpu_line)
        del model
        torch.cuda.empty_cache()
    print(f"devices: kernel launches during the two-thread runs: {launches}")
    return launches


def window_threads(model, devices, gpu_line):
    """Eight 1080p windows through the serial chain (one thread), the
    planner over one replica (its extra work: each window's own pass
    without the chain's features, a dispatch thread) and over ``devices``
    (a dispatch thread per replica), without the frame loop's other
    threads: wall per side, in turns, and the device time of one call of
    each (torch.profiler; kernels that overlap on two streams each count
    whole)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from drba_tpu_torch.parallel.batch import WindowPlanner
    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper, to_inp

    dev = devices[0]
    size = padded_size(model)
    fr = [to_inp(f, size, model.config.compute_dtype, dev) for f in synthetic_frames(10)]
    tm = TMapper(SRC_FPS, DST_FPS)
    windows = [(fr[k], fr[k + 1], fr[k + 2], calc_ts(k, tm, -1)) for k in range(8)]
    n_out = sum(len(w[3]) for w in windows)
    planners = {"planner x1": WindowPlanner(devices[:1], model),
                f"planner x{len(devices)}": WindowPlanner(devices, model)}

    def serial():
        reuse = None
        for w in windows:
            _, reuse = model.inference_ts_drba(*w, reuse, linear=True)

    def planned(planner):
        def run():
            planner.reset_chain()
            for _ in planner.run(windows):
                pass
        return run

    sides = {"serial": serial, **{k: planned(p) for k, p in planners.items()}}
    try:
        for fn in sides.values():  # warm
            fn()
        torch.cuda.synchronize()
        walls = {k: [] for k in sides}
        for label in [*sides, *reversed(sides)]:  # in turns, each side twice
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sides[label]()
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
        busy = {}
        for label, fn in sides.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            busy[label] = sum(e.self_device_time_total for e in prof.key_averages()
                              if e.self_device_time_total > 0 and e.self_cpu_time_total == 0) / 1e3
        for label, planner in planners.items():
            replica_graphs(f"devices {type(model).__name__} windows alone, {label}", planner,
                           must_replay=True)
    finally:
        for p in planners.values():
            p.close()
    fps = {k: n_out / (sum(v) / len(v)) for k, v in walls.items()}
    print(f"devices {type(model).__name__} windows alone (8 windows, {n_out} frames; "
          f"[{gpu_line}]): " + "; ".join(
              f"{k} {walls[k][0]:.3f}/{walls[k][1]:.3f} s, {fps[k]:.2f} fps "
              f"({fps[k] / fps['serial']:.3f}x), device {busy[k]:.1f} ms" for k in sides))


def release_memory(dev, before: str = "the 4K phase") -> None:
    """Free what the earlier phases left: their models (and with them their
    graph pools) are gone once collected; the cache goes back to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory before {before}: {torch.cuda.memory_allocated(dev) / 2**20:.1f} MiB "
          f"allocated, {torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB reserved")


def phase_uhd(dev, gpu_line):
    """RIFE and GMFSS at ``-scale 0.5`` on 4K frames: a T = 3 and a T = 2
    window through the graph against the plain path's eager pieces, their
    ms, pools and launches, then a 6-frame 4K RIFE ``run_pipeline``; returns
    the launch counts of the windows and the run."""
    import torch

    from drba_tpu_torch import _build, graphs
    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper, to_inp

    frames = synthetic_frames(3, *UHD)
    tmap = TMapper(SRC_FPS, DST_FPS)
    ts_pair = (calc_ts(0, tmap, -1), calc_ts(1, tmap, -1))  # T = 3, then T = 2
    launches = {k.name: 0 for k in _build.KERNELS}
    mean_tol, share_tol = GATES["bf16"]
    for name in ("rife", "gmfss"):
        plain_cfg = dict(splat_backend="torch", warp_backend="torch", conv_backend="torch")
        if name != "rife":
            plain_cfg["attn_backend"] = "torch"
        torch.cuda.reset_peak_memory_stats(dev)  # the peak printed below is this model's
        m = make_model(name, dev, scale=0.5)
        plain = make_model(name, dev, scale=0.5, **plain_cfg)
        size = padded_size(m, UHD)
        I0, I1, I2 = (to_inp(f, size, m.config.compute_dtype, dev) for f in frames)
        reuse = m.reuse(I1, I0)
        for ts in ts_pair:
            out_p = torch.stack(eager_window(plain, I0, I1, I2, ts, reuse)[0])
            torch.cuda.empty_cache()
            m.inference_ts_drba(I0, I1, I2, ts, reuse, linear=True)  # warm-up and capture
            _build.reset_counts()
            out_g = torch.stack(m.inference_ts_drba(I0, I1, I2, ts, reuse, linear=True)[0])
            torch.cuda.synchronize()
            counts = _build.counts()
            for k, n in counts.items():
                launches[k] += n
            d = (out_g.float() - out_p.float()).abs()
            mean, share = float(d.mean()), float((d > 1e-2).float().mean())
            ms = timed(lambda: m.inference_ts_drba(I0, I1, I2, ts, reuse, linear=True), 3)
            print(f"uhd {name} bf16 4K -scale 0.5 ({size[0]}x{size[1]}) T={len(ts)}: graph "
                  f"replay vs plain eager pieces max_abs {float(d.max()):.3e}  mean_abs "
                  f"{mean:.3e}  share(>1e-2) {share:.3e}; {ms:.2f} ms a window (graphed, CUDA "
                  f"events, 3 calls); launches in the replay {counts}  [{gpu_line}]")
            if not torch.isfinite(out_g).all() or mean > mean_tol or share > share_tol:
                fail(f"uhd {name} T={len(ts)} kernel vs plain: mean {mean:.3e} (tol "
                     f"{mean_tol:g}), share(>1e-2) {share:.3e} (tol {share_tol:g})")
            for k in PATH_KERNELS[name]:
                if counts[k] == 0:
                    fail(f"uhd {name} T={len(ts)}: kernel {k} was not launched in the replay")
            del out_p, out_g, d
        for key, e in graphs.state(m).entries.items():
            if key[0] == "window":
                print(f"uhd {name} graph T={key[1]} {key[2][1]}x{key[2][2]}: pool "
                      f"{e.pool_bytes} bytes ({e.pool_bytes / 2**20:.1f} MiB), launches a "
                      f"replay {dict(e.launches)}; peak allocated with the plain model beside "
                      f"it {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del m, plain, I0, I1, I2, reuse
        torch.cuda.empty_cache()
    for k, n in phase_slice("rife", dev, uhd=True).items():
        launches[k] += n
    return launches


def phase_gate(dev, gpu_line):
    """The composed-path quality gate of ``bench_torch`` (min frame SSIM
    >= 0.995, fast path against the exact plain path in bf16 and in f32),
    then one SSIM reading each, not gated, of a GMFSS and a GMFSS_UNION T = 3
    window (kernel path, bf16) against their f32 plain path; returns the
    launch counts of the gate's fast windows."""
    import torch

    import bench_torch
    from drba_tpu_torch import _build
    from drba_tpu_torch.ops.ssim import ssim
    from drba_tpu_torch.pipeline import calc_ts
    from drba_tpu_torch.utils import TMapper, to_inp

    _build.reset_counts()
    entry = bench_torch.gate_composed(bench_torch.Settings(dev))
    counts = _build.counts()
    print(f"gate: composed fast path vs exact, min frame SSIM of one T=3 RIFE window at "
          f"{entry['size'][0]}x{entry['size'][1]} (injected pans): {entry['ssim']}, gate "
          f">= {entry['gate']} on both readings: {'passed' if entry['passed'] else 'FAILED'}; "
          f"launches {counts}  [{gpu_line}]")
    if not entry["passed"]:
        fail(f"gate: min frame SSIM below {entry['gate']}: {entry['ssim']}")
    for k in PATH_KERNELS["rife"]:
        if counts[k] == 0:
            fail(f"gate: kernel {k} was not launched on the fast path")
    # a random GMFlow's correlation gives flows of the image's size and the
    # union's thresholds flip on rounding: these are readings, not gates
    frames = synthetic_frames(3)
    ts3 = calc_ts(0, TMapper(SRC_FPS, DST_FPS), -1)
    for name in ("gmfss", "gmfss_union"):
        outs = {}
        for label, cfg in (("kernel bf16", {}),
                           ("plain f32", dict(compute_dtype=torch.float32, splat_backend="torch",
                                              warp_backend="torch", conv_backend="torch",
                                              attn_backend="torch", drm_splat_scale=1.0))):
            m = make_model(name, dev, **cfg)
            I0, I1, I2 = (to_inp(f, padded_size(m), m.config.compute_dtype, dev) for f in frames)
            out = eager_window(m, I0, I1, I2, ts3, m.reuse(I1, I0))[0]
            outs[label] = torch.stack(out).float()
            del m, I0, I1, I2, out
            torch.cuda.empty_cache()
        s = [float(ssim(outs["kernel bf16"][t], outs["plain f32"][t], val_range=1.0))
             for t in range(len(ts3))]
        print(f"gate reading (not gated): {name} T=3 1080p window, kernel path bf16 vs plain "
              f"path f32 (full-resolution DRM splats): SSIM per frame "
              f"{', '.join(f'{v:.5f}' for v in s)}, min {min(s):.5f}")
    return counts


def main() -> None:
    # a crash in native code (a driver, a library) prints every thread's stack
    faulthandler.enable()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    try:
        from drba_tpu_torch import _build
    except ImportError as e:
        fail(f"cannot import drba_tpu_torch ({e}); run from the repository root")

    from drba_tpu_torch.config import full_f32_products

    full_f32_products()
    dev = torch.device("cuda", 0)
    gpu_line = cmd_line(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"])
    print(gpu_line)
    driver = cmd_line(["nvidia-smi", "-i", "0", "--query-gpu=driver_version",
                       "--format=csv,noheader"])
    import numpy as np

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, numpy "
          f"{np.__version__}, CUDA "
          f"{torch.version.cuda}, driver {driver}, "
          f"nvcc: {cmd_line([_build.find_nvcc(), '--version'])}, "
          f"device {torch.cuda.get_device_name(0)}, no Triton kernel used")

    secs = _build.build_all()
    for k in _build.KERNELS:
        regs = [ln.split(":", 1)[-1].strip() for ln in k.build_log.splitlines()
                if "registers" in ln]
        print(f"build {k.name}: {k.source_path} built in {secs[k.source]:.1f} s "
              f"(sources in parallel); {'; '.join(regs)}")

    from drba_tpu_torch.bounds import bound_ms

    phase_host(dev, gpu_line)
    summary = phase_kernels(dev)
    launches = {k.name: 0 for k in _build.KERNELS}
    for name, scdet in (("rife", False), ("gmfss", False), ("gmfss_union", False),
                        ("rife", True)):
        for k, n in phase_slice(name, dev, scdet).items():
            launches[k] += n
    # every bf16 window first (when cuDNN ran the f32 windows' convs by FFT,
    # ~300 000 launches a window, a later profile lost a kernel event)
    models = ("rife", "gmfss", "gmfss_union")
    for name in models:
        phase_window(name, dev, gpu_line, ("bf16",))
    launches_f32 = {k: 0 for k in F32_ROWS}
    for name in models:
        counts = phase_window(name, dev, gpu_line, ("f32",))["f32"]
        for k in launches_f32:
            launches_f32[k] += counts[k]
    for phase in (phase_resume(dev), phase_scdet_twice(dev, gpu_line),
                  phase_devices(dev, gpu_line)):
        for k, n in phase.items():
            launches[k] += n
    release_memory(dev)
    for phase in (phase_uhd(dev, gpu_line), phase_gate(dev, gpu_line)):
        for k, n in phase.items():
            launches[k] += n
    release_memory(dev, "the f32 phase")
    phase_f32(dev)

    kernels = []
    for k in _build.KERNELS:
        s = summary[k.name]
        b_ms, b_by = bound_ms(s["work"])
        kernels.append({"name": k.name, "route": "cuda", "source": k.source_path,
                        "replaces": REPLACES[k.name], "launches": launches[k.name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": s["library_ms"],
                        "library_call": s["library_call"],
                        "ms_at_library_shapes": s["ms_at_library"]})
        if k.name in F32_ROWS:  # the f32 design: the f32 windows' launches
            s = summary[f"{k.name}_f32"]
            b_ms, b_by = bound_ms(s["work"])
            kernels.append({"name": f"{k.name}_f32", "route": "cuda", "source": k.source_path,
                            "replaces": REPLACES[k.name], "launches": launches_f32[k.name],
                            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                            "plain_ms": s["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": s["library_ms"], "library_call": s["library_call"],
                            "ms_at_library_shapes": s["ms_at_library"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def leave() -> None:
    """Free what is left on the card while the CUDA runtime is whole, then
    exit 0 without the interpreter's teardown. Every check has passed by
    now; the teardown would only destroy CUDA graphs, the profiler's state
    and the kernels' statically linked CUDA runtimes in an order none of
    them chose."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
    leave()
