"""The traffic generator, the benchmark's plan and its latency map, and the
data-driven lookup of cells, mixes and metrics."""

import json
import os
import shutil

import numpy as np
import pytest

from benchmark import cells, check, plan, stream, trace, work
from benchmark.reference import scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("mix", ["tv-shots", "fastcut-shots"])
def test_shot_lengths_are_the_files_range_in_a_seeded_order(mix):
    traffic = stream.load(os.path.join(ROOT, "benchmark", "traffic", f"{mix}.json"))
    s = traffic["shot_frames"]
    want = list(range(s["min"], s["max"] + 1, s.get("step", 1)))
    a, b = stream.shot_lengths(traffic, 2**31 + 11), stream.shot_lengths(traffic, 5)
    assert sorted(a) == sorted(b) == want
    assert a != b


def test_reel_frames_cuts_and_holds():
    traffic = cells.load("rife-1080p-fastcut").traffic
    reel = stream.Reel(traffic, [3, 4, 5], 64, 128, 1, "cpu")
    assert len(reel) == 12
    np.testing.assert_array_equal(np.flatnonzero(reel.cuts(30)), [2, 6, 11, 14, 18, 23, 26])
    same = np.shares_memory
    assert same(reel.frame(0), reel.frame(1)) and not same(reel.frame(2), reel.frame(1))
    assert same(reel.frame(13), reel.frame(1))
    src = stream.Source(reel, traffic, limit=5)
    got = [src.read_frame() for _ in range(6)]
    assert got[5] is None and len(src.read_at) == 5


@pytest.mark.parametrize("mix", ["tv-shots", "fastcut-shots"])
def test_reference_ssim_finds_exactly_the_reels_cuts(mix):
    """At the cells' own 1080p frame size: every pair across a shot
    boundary scores far below the threshold, every pair within a shot far
    above it."""
    traffic = stream.load(os.path.join(ROOT, "benchmark", "traffic", f"{mix}.json"))
    lengths = [8, 9, 10, 11] if mix == "fastcut-shots" else [12, 10, 11]
    reel = stream.Reel(traffic, lengths, 1080, 1920, 2**31 + 3, "cpu")
    n = len(reel) + 2
    x = [scene.to_input(reel.frame(j), (1088, 1920)) for j in range(n)]
    scores = np.array([scene.scene_score(x[k], x[k + 1]) for k in range(n - 1)])
    cuts = reel.cuts(n)
    thr = traffic["scdet_threshold"]
    np.testing.assert_array_equal(scores < thr, cuts)
    assert scores[cuts].max() < thr - 0.2 and scores[~cuts].min() > thr + 0.3


@pytest.mark.parametrize("n", [2, 3, 4, 7, 30, 31])
def test_plan_counts_equal_the_programs(n):
    from drba_tpu_torch.pipeline import planned_outputs

    blocks = plan.blocks(n, np.zeros(n - 1, bool), 24, 60, union=False)
    assert sum(len(b.ts) for b in blocks) == planned_outputs(n, 24, 60)
    assert [b.first_output for b in blocks] == list(np.cumsum([0] + [len(b.ts) for b in blocks])[:-1])


def test_plan_branches_chain_and_newest_inputs():
    # cuts between frames 2|3 and 6|7 of 10
    cuts = np.zeros(9, bool)
    cuts[[2, 6]] = True
    for union in (False, True):
        blocks = plan.blocks(10, cuts, 24, 60, union)
        head, body, tail = blocks[0], blocks[1:-1], blocks[-1]
        assert head.kind == "head" and head.newest == 1 and not head.left_cut
        assert tail.kind == "tail" and tail.newest == 9
        assert [b.newest for b in body] == [i + 2 for i in range(8)]
        classes = [check.window_class(b) for b in body]
        # window i reads frames i, i+1, i+2: the cut 2|3 lies right of I1 in
        # window 1, left of it in window 2
        assert classes[1] == "right" and classes[2] == "left"
        assert classes[5] == "right" and classes[6] == "left"
        assert classes[0] == "start"
        # after a left-cut window RIFE's chain starts again; GMFSS_UNION's
        # plain pass carries it
        assert classes[3] == ("fused" if union else "start")
        assert classes[7] == ("fused" if union else "start")


def test_output_index_maps_outputs_to_windows():
    idx = plan.OutputIndex(24, 60, windows=50)
    blocks = plan.blocks(40, np.zeros(39, bool), 24, 60, union=False)
    for b in blocks[1:-1]:
        for j in b.outputs:
            assert idx.window_of(j) == b.index
    assert all(idx.window_of(j) == -1 for j in blocks[0].outputs)


def test_latency_map_dates_each_frame_by_its_blocks_newest_input():
    cuts = np.zeros(11, bool)
    cuts[4] = True
    blocks = plan.blocks(12, cuts, 24, 60, union=False)
    newest = np.concatenate([np.full(len(b.ts), b.newest) for b in blocks])
    assert newest[0] == 1 and newest[-1] == 11
    assert (np.diff(newest) >= 0).all()
    assert len(newest) == sum(len(b.ts) for b in blocks)


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A later cell adds files and entries and edits none: a union
    configuration at ``-scale 0.5``, a mix, a metric of its own and a dotted
    entry (``mfu.x``) that reads an existing metric's reader."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    tv_metrics = sum("rife-1080p-tv" in m.get("workloads", ["rife-1080p-tv"])
                     for m in spec["per_layer"])
    (root / "benchmark" / "traffic" / "slow-pans.json").write_text(json.dumps(
        {**cells.load("union-1080p-tv").traffic, "pan_px_per_frame": 2}))
    cfg = {**cells.load("union-1080p-tv").config, "name": "gmfss-union-2160p",
           "frame": [2160, 3840], "scale": 0.5}
    (root / "benchmark" / "configs" / "gmfss-union-2160p.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "metrics" / "windows_seen.py").write_text(
        "def read(t):\n    return float(t.windows) or None\n")
    spec["configs"].append({"name": "gmfss-union-2160p", "source": "x", "why": "x", "reduced": [],
                            "file": "benchmark/configs/gmfss-union-2160p.json"})
    spec["workloads"].append({"name": "union-2160p-slow", "config": "gmfss-union-2160p",
                              "traffic": "slow-pans", "chips": 1, "why": "x"})
    for name, unit, layer in (("windows_seen", "1", "frame loop"), ("mfu.x", "%", "whole step")):
        spec["per_layer"].append({"name": name, "unit": unit, "better": "higher",
                                  "source": "program_counter", "layer": layer,
                                  "moves": "out_fps", "workloads": ["union-2160p-slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load("union-2160p-slow", str(root))
    assert cell.config["frame"] == [2160, 3840] and cell.config["scale"] == 0.5
    assert cell.traffic["pan_px_per_frame"] == 2
    assert [m["name"] for m in cell.per_layer] == ["windows_seen", "mfu.x"]

    t = trace.Trace(windows=3, window_s=2.0, calls=[trace.Call("window", 2, 0.001, None)] * 5,
                    work={("window", 2): work.CallWork(4e12, work.Work(), work.Work(), 0, 0)})
    assert cells.metric_reader("windows_seen", str(root))(t) == 3.0
    mfu_x = cells.metric_reader("mfu.x", str(root))
    assert mfu_x.__code__.co_filename == str(root / "benchmark" / "metrics" / "mfu.py")
    assert mfu_x(t) == pytest.approx(5 * 4e12 / 2.0 / work.PEAK_BF16_FLOPS * 100)
    # the cells already there keep their metrics
    assert len(cells.load("rife-1080p-tv", str(root)).per_layer) == tv_metrics > 0


def test_end_to_end_metrics_by_cell():
    """``out_fps.union`` is ``out_fps`` under the union cell's own bound;
    the other cells report ``out_fps`` and ``setup_s`` alone."""
    names = {c: [m["name"] for m in cells.load(c).end_to_end]
             for c in ("rife-1080p-tv", "rife-1080p-fastcut", "union-1080p-tv")}
    assert names["rife-1080p-tv"] == names["rife-1080p-fastcut"] == ["out_fps", "setup_s"]
    assert names["union-1080p-tv"] == ["out_fps", "out_fps.union", "setup_s"]
    assert {cells.quantity(n) for n in names["union-1080p-tv"]} == {"out_fps", "setup_s"}
