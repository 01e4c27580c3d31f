"""``bench_torch.py`` on the CPU at tiny sizes: every config's function, the
entry schema, the headline line, the sweep's failure handling, the
composed-path gate (and that it can fail), the CLI run of the e2e configs,
and that the bench imports nothing of JAX or of drba_tpu.

Numbers measured here are the CPU's; only their form is checked.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench_torch
from drba_tpu_torch.pipeline import planned_outputs

CPU = torch.device("cpu")
SMALL = bench_torch.Settings(CPU, (64, 128), 2)
WINDOW_CONFIGS = ["rife", "gmfss", "gmfss_union", "uhd", *bench_torch.PANS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per machine; keep this file's
    small PyTorch CPU ops on one thread instead of oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", WINDOW_CONFIGS)
def test_window_config_entry_schema(name):
    """64x128 frames (uhd: 128x256 at scale 0.5), two timed windows: the
    entry carries bench_breakdown.json's keys and the port's own."""
    entry = bench_torch.run_config(name, SMALL)
    assert "error" not in entry, entry.get("error")
    assert entry["label"] == bench_torch.CONFIGS[name][0]
    assert bench_torch._age_hours(entry["measured_at"]) < 1
    assert entry["fps"] > 0 and entry["frames"] == 5 and entry["windows"] == 2
    assert entry["size"] == ([128, 256] if name == "uhd" else [64, 128])
    assert set(entry["window_ms"]) == {"T2", "T3"}
    assert all(v > 0 for v in entry["window_ms"].values())
    # no graph and no kernel on the CPU
    assert entry["graphed"] is False and entry["pool_bytes"] == 0 and entry["launches"] == {}
    assert entry["device"] == "cpu"
    if name in bench_torch.PANS:
        assert entry["pan_px"] == bench_torch.PANS[name][1]
    json.dumps(entry)


def test_gate_readings_and_its_failure(monkeypatch):
    """Both readings per pan in [0, 1] and passing; a fast path replaced by a
    window of zeros fails the gate, and the sweep with it."""
    entry = bench_torch.gate_composed(SMALL)
    assert set(entry["ssim"]) == {"pan8", "pan20", "pan40"}
    for r in entry["ssim"].values():
        assert set(r) == {"exact", "exact_f32"}
        assert all(0.0 <= v <= 1.0 for v in r.values())
    assert entry["passed"] and entry["gate"] == 0.995

    real = bench_torch._gate_window

    def zeros_on_the_fast_path(model, frames, mag):
        out = real(model, frames, mag)
        return torch.zeros_like(out) if model.config.conv_backend == "auto" else out

    monkeypatch.setattr(bench_torch, "_gate_window", zeros_on_the_fast_path)
    broken = bench_torch.gate_composed(SMALL)
    assert not broken["passed"]
    assert all(v < 0.995 for r in broken["ssim"].values() for v in r.values())
    monkeypatch.setattr(bench_torch, "BREAKDOWN_PATH", "/nonexistent/never-written.json")
    with pytest.raises(SystemExit, match="gate"):
        bench_torch.main(["--config", "gate", "--device", "cpu", "--size", "64x128",
                          "--no-save"])


def test_e2e_runs_the_cli_and_parses_its_done_line():
    """The CLI as a process of its own on a 12-frame 108x192 cv2 clip."""
    entry = bench_torch.bench_e2e("rife", bench_torch.Settings(CPU, (108, 192)), n_frames=12,
                                  warm_frames=4)
    assert entry["frames_in"] == 12 and entry["scene_cuts"] == 0
    assert entry["frames_out"] == planned_outputs(12, 24.0, 60.0)
    assert entry["fps"] == pytest.approx(entry["frames_out"] / entry["wall_s"], rel=1e-2)
    assert "window" in entry["stages_s"]
    assert entry["encoder"] in ("ffmpeg", "cv2 mp4v")
    assert entry["wall_includes_graph_capture"] is False and entry["device"] == "cpu"


def test_headline_line_and_saved_breakdown(tmp_path, monkeypatch, capsys):
    """The default run prints one JSON line with bench.py's keys and keeps
    the fresh entries of the breakdown file, dropping the stale ones."""
    path = tmp_path / "bench_breakdown_torch.json"
    path.write_text(json.dumps({"gmfss": {"label": "old", "fps": 1.0,
                                          "measured_at": "2020-01-01T00:00:00Z"}}))
    monkeypatch.setattr(bench_torch, "BREAKDOWN_PATH", str(path))
    bench_torch.main(["--device", "cpu", "--size", "64x128", "--windows", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert {"metric", "value", "unit", "vs_baseline", "device", "breakdown"} <= set(line)
    assert line["vs_baseline"] == round(line["value"] / 36.0, 3)
    assert line["device"] == "cpu" and set(line["breakdown"]) == {"rife"}
    assert line["stale_omitted"] == ["gmfss"]
    assert set(json.loads(path.read_text())) == {"rife", "gmfss"}


def test_sweep_records_failures_and_keeps_pan_pairs_alike(tmp_path, monkeypatch):
    """A config that raises records its error and the run exits non-zero
    after the rest; a pan row that could not be captured makes its model's
    other row run eagerly too."""
    path = tmp_path / "b.json"
    monkeypatch.setattr(bench_torch, "BREAKDOWN_PATH", str(path))

    def boom(s):
        raise RuntimeError("kernel build failed")

    monkeypatch.setitem(bench_torch.CONFIGS, "rife", ("rife 1080p 24->60", boom))
    calls = []

    def fake_motion(model, mag, s, n_windows=16, eager=False):
        calls.append((model, mag, eager))
        return {"fps": 1.0, "graphed": mag == 8.0 and not eager, "device": "cpu"}

    monkeypatch.setattr(bench_torch, "bench_motion", fake_motion)
    bad = bench_torch.sweep(["rife", "rife_pan8", "rife_pan40"], SMALL, save=True)
    assert bad == ["rife"]
    saved = json.loads(path.read_text())
    assert saved["rife"]["error"] == "RuntimeError: kernel build failed"
    assert calls == [("rife", 8.0, False), ("rife", 40.0, False), ("rife", 8.0, True)]
    assert saved["rife_pan8"]["graphed"] is False and saved["rife_pan40"]["graphed"] is False


def test_refuses_to_run_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        bench_torch.main(["--no-save"])


def test_bench_imports_without_jax():
    """bench_torch imports with JAX made unimportable and pulls in no module
    of drba_tpu (nor bench.py)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import bench_torch\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and (k in ('jax', "
        "'drba_tpu', 'bench') or k.startswith(('jax.', 'drba_tpu.')))]\n"
        "assert not bad, bad\n"
        "print(len(bench_torch.CONFIGS))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 13
