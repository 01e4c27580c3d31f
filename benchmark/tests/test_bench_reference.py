"""The frozen reference against the program's plain path, on the CPU, at a
tiny size, on the same seeded weights (read by the program from the
checkpoint tree the benchmark writes); its FLOP counts against the
program's; and the import rules of the benchmark's modules."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import cells, stream, work
from benchmark.reference import models, scene, weights

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SIZES = {"rife": (64, 128), "gmfss_union": (128, 256)}
CELL = {"rife": "rife-1080p-fastcut", "gmfss_union": "union-1080p-tv"}


def _program_and_reference(model_type, tmp_path, scale=1.0, seed=7):
    """The cell's configuration at the flow ``scale`` (``-scale``), the
    program loaded with it and the reference."""
    from drba_tpu_torch.cli import load_model
    from drba_tpu_torch.config import Config

    cfg = {**cells.load(CELL[model_type]).config, "scale": scale}
    specs = models.specs(model_type)
    params = weights.draw(specs, seed, "cpu")
    weights.write_tree(str(tmp_path), cfg["weights_dir"], models.files(model_type), specs, params)
    config = Config(compute_dtype=torch.float32, strict_load=True, flow_scale=scale,
                    drm_splat_scale=cfg["drm_splat_scale"])
    model = load_model(model_type, str(tmp_path), scale, config, "cpu")
    return cfg, model, models.Reference(cfg, params)


def _frames(model_type, n=4, scale=1.0):
    h, w = SIZES[model_type]
    traffic = cells.load(CELL[model_type]).traffic
    reel = stream.Reel(traffic, [2, 3], h, w, 11, "cpu")
    size = scene.net_size(h, w, scale, 64 if model_type == "rife" else 128)
    return [scene.to_input(reel.frame(j), size) for j in range(n)]


def _close(a, b, tol):
    a, b = torch.stack(list(a)).float(), torch.stack(list(b)).float()
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= tol


# f32 on both sides, the same operations in the same order but for a few
# spellings (the program's conv chains, its GridNet tail folded through the
# pixel shuffle, its stacked warps): the sums differ in their last bits
TOL = 2e-5


# (model type, flow scale); at -scale 0.5 GMFlow (the union) and IFNet's
# blocks run on the frames halved once more
SCALED = [pytest.param("rife", 1.0, id="rife"), pytest.param("gmfss_union", 1.0, id="gmfss_union"),
          pytest.param("rife", 0.5, id="rife-scale0.5"),
          pytest.param("gmfss_union", 0.5, id="gmfss_union-scale0.5")]


@pytest.mark.parametrize("model_type,scale", SCALED)
@pytest.mark.parametrize("block", ["head", "tail", "left", "right", "start", "chained"])
def test_reference_blocks_match_program(model_type, scale, block, tmp_path):
    torch.manual_seed(0)
    cfg, model, ref = _program_and_reference(model_type, tmp_path, scale)
    I0, I1, I2, _ = _frames(model_type, scale=scale)
    ts3 = np.array([0.6, 1.0, 1.4])
    if block == "head":
        got = [I0] + list(model.inference_ts(I0, I1, ts3[ts3 >= 1] - 1))
        want = ref.block("head", (I0, I1), ts3)
    elif block == "tail":
        got = list(model.inference_ts(I0, I1, ts3[ts3 <= 1])) + [I1]
        want = ref.block("tail", (I0, I1), ts3)
    elif block == "left":
        got = [I1] + list(model.inference_ts(I1, I2, ts3[ts3 >= 1] - 1))
        want = ref.block("window", (I0, I1, I2), ts3, left_cut=True)
    elif block == "right":
        got = list(model.inference_ts(I0, I1, ts3[ts3 <= 1])) + [I1]
        want = ref.block("window", (I0, I1, I2), ts3, right_cut=True)
    elif block == "start":
        got, _ = model.inference_ts_drba(I0, I1, I2, ts3, None, linear=True)
        want = ref.block("window", (I0, I1, I2), ts3, chain_start=True)
    else:
        chain = model.next_reuse(I0, I1)
        got, _ = model.inference_ts_drba(I0, I1, I2, np.array([0.8, 1.2]), chain, linear=True)
        want = ref.block("window", (I0, I1, I2), np.array([0.8, 1.2]))
    _close(got, want, TOL)


def _program_flops(model, kind, T, frames):
    I0, I1, I2 = frames
    ts = np.array([0.6, 1.0, 1.4]) if T == 3 else np.array([0.8, 1.2])[:T]
    given = None
    if kind == "window":
        given = model.next_reuse(I0, I1)
    elif kind == "plain" and hasattr(model, "reuse"):
        given = model.reuse(I0, I1)
    with FlopCounterMode(display=False) as fc:
        if kind.startswith("window"):
            model.inference_ts_drba(I0, I1, I2, ts, given, linear=True)
        else:
            model.inference_ts(I0, I1, np.array([0.2, 0.4, 0.6])[:T], given)
    return fc.get_total_flops()


FLOP_CASES = [
    ("rife", "window", 3), ("rife", "window", 2), ("rife", "window_start", 3), ("rife", "plain", 2),
    ("gmfss_union", "window", 3), ("gmfss_union", "window_start", 2),
    ("gmfss_union", "plain", 2), ("gmfss_union", "plain_pass", 1)]


@pytest.mark.parametrize("model_type,kind,T,scale", [
    pytest.param(m, k, T, 1.0, id=f"{m}-{k}-{T}") for m, k, T in FLOP_CASES] + [
    pytest.param(m, k, T, 0.5, id=f"{m}-{k}-{T}-scale0.5") for m, k, T in FLOP_CASES
    if m == "gmfss_union" or k == "window"])
def test_reference_flops_match_program(model_type, kind, T, scale, tmp_path):
    cfg, model, _ = _program_and_reference(model_type, tmp_path, scale)
    frames = _frames(model_type, 3, scale)
    h, w = frames[0].shape[1:3]
    got = _program_flops(model, kind, T, frames)
    want = work.call_work(cfg, kind, T, (h, w), torch.float32).flops
    # the program runs GridNet's last conv (64 -> 3) before the pixel shuffle
    # (a 256 -> 12 conv on a quarter of the pixels): 4x its FLOPs, counted
    # once at full resolution by the reference
    fold = 3 * 2 * 3 * 64 * 9 * h * w * T if model_type == "gmfss_union" else 0
    assert got == want + fold


def test_flops_at_the_cells_shapes():
    """The chained 1080p windows' model FLOPs (GFLOP): RIFE 185.84 (T=2) and
    272.40 (T=3)."""
    cfg = cells.load("rife-1080p-tv").config
    assert round(work.call_work(cfg, "window", 2, (1088, 1920)).flops / 1e9, 2) == 185.84
    assert round(work.call_work(cfg, "window", 3, (1088, 1920)).flops / 1e9, 2) == 272.40


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(BENCH, "reference")
    for f in sorted(os.listdir(ref_dir)):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir, f))}
            assert not tops & {"drba_tpu_torch", "drba_tpu", "jax", "jaxlib", "flax"}, f


def test_no_jax_on_the_commands_path():
    """Everything the command imports, the program's modules among them,
    leaves no module whose top-level name is jax, jaxlib, flax or drba_tpu
    (drba_tpu_torch is allowed: the names are compared whole)."""
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, benchmark.harness, "
            "benchmark.control; import drba_tpu_torch.cli, drba_tpu_torch.pipeline, "
            "drba_tpu_torch.models.rife, drba_tpu_torch.models.gmfss_union; "
            "from benchmark.harness import forbidden_modules; print(forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
