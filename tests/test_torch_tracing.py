"""The port's span recorder (drba_tpu_torch/utils/profiling.py) on the CPU.

A small ``run_pipeline`` with ``profile=True`` and a scene cut: each span's
count against ``PipelineStats``, the threads' names, one frame's spans
linked across threads by its index, block and output number; with no
recorder no span site reads the clock; the ``call`` spans and counters of
``graphs.WindowGraphs`` with a stand-in graph; spans on ``torch.profiler``'s
clock; the record bound and exact counts across threads; the ``--profile``
report, which ``benchmark/trace.parse_stages`` still reads into the old
stages. Seed-0 random-weight RIFE in float32 on 64x128 frames, 24 -> 60.
"""

import threading
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark.trace import parse_stages
from drba_tpu_torch import graphs
from drba_tpu_torch.config import F32
from drba_tpu_torch.ops.resize import scale_by
from drba_tpu_torch.pipeline import run_pipeline
from drba_tpu_torch.utils import get_valid_net_inp_size, profiling

H, W = 64, 128
N_FRAMES, CUT_AT = 9, 5
OLD_STAGES = ("window", "emit-wait", "prefetch-wait", "scdet", "finish")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=N_FRAMES, cut_at=(CUT_AT,)):
    """Smooth content panning 2 px a frame; frame ``cut_at`` inverts the
    colours (a hard cut)."""
    x = np.linspace(0, 6 * np.pi, W)[None, :, None]
    y = np.linspace(0, 4 * np.pi, H)[:, None, None]
    p = np.arange(3)[None, None, :]
    base = ((np.sin(x + p) * np.cos(y - p) * 0.5 + 0.5) * 255).astype(np.uint8)
    out = []
    for i in range(n):
        base = 255 - base if i in cut_at else np.roll(base, 2, axis=1)
        out.append(base.copy())
    return out


class _IO:
    src_fps, dst_fps = 24.0, 60.0

    def __init__(self, frames):
        self._frames = list(frames)
        self.written = []

    def read_frame(self):
        return self._frames.pop(0) if self._frames else None

    def write_frame(self, frame):
        self.written.append(frame)

    def finish_writing(self):
        return True


@pytest.fixture(scope="module")
def rife():
    from drba_tpu_torch.models.rife import RIFE

    return RIFE(weights=None, config=F32, device="cpu")


@pytest.fixture(scope="module")
def profiled(rife):
    stats = run_pipeline(rife, _IO(_frames()), enable_scdet=True, profile=True)
    assert profiling.active() is None  # the run closed the recorder it opened
    return stats


def _by(records, name):
    return [r for r in records if r.name == name]


def test_span_counts_match_the_stats(profiled):
    """``read`` and ``upload`` per frame read, ``window`` per block (head,
    body windows, tail), ``download`` and ``write`` per frame written; the
    exact aggregates agree with the records."""
    s = profiled
    assert s.scene_cuts >= 1 and s.frames_in == N_FRAMES
    n = Counter(r.name for r in s.records)
    assert n["read"] == n["upload"] == s.frames_in
    assert n["put-wait"] == s.frames_in - 2
    assert n["window"] == n["emit-wait"] == s.windows + 2
    assert n["scdet"] == s.windows
    assert n["download"] == n["write"] == s.frames_out == len(set(range(s.frames_out)))
    assert n["finish"] == 1
    agg = Counter()
    for r in s.records:
        agg[f"{r.thread.rsplit('-', 1)[0] if r.thread.startswith('download-') else r.thread}/"
            f"{r.name}"] += 1
    assert {k: c for k, (_, c) in s.spans.items()} == dict(agg)
    assert s.counters.get("records.dropped", 0) == 0


def test_spans_carry_their_threads_names(profiled):
    threads = {name: {r.thread for r in _by(profiled.records, name)}
               for name in ("read", "upload", "put-wait", "download", "write", *OLD_STAGES)}
    assert threads["read"] == threads["upload"] == {"loop", "prefetch"}
    assert threads["put-wait"] == {"prefetch"}
    assert threads["download"] and all(t.startswith("download-") for t in threads["download"])
    assert threads["write"] == {"writer"}
    for stage in OLD_STAGES:
        assert threads[stage] == {"loop"}
    # frames 0 and 1 are read and uploaded on the loop's thread, the rest on
    # the prefetch thread
    for r in _by(profiled.records, "read"):
        assert r.thread == ("loop" if r.attrs["frame"] < 2 else "prefetch")


def test_one_frames_spans_link_across_threads(profiled):
    """Frame k: read, uploaded and queued on the prefetch thread, taken by
    block k - 1 on the loop's thread (``prefetch-wait``, ``window``), whose
    outputs are downloaded and written under their sequence numbers; each
    step starts after the one before it ends, on one clock."""
    recs = profiled.records
    for k in range(2, N_FRAMES):
        read, = [r for r in _by(recs, "read") if r.attrs["frame"] == k]
        up, = [r for r in _by(recs, "upload") if r.attrs["frame"] == k]
        put, = [r for r in _by(recs, "put-wait") if r.attrs["frame"] == k]
        wait, = [r for r in _by(recs, "prefetch-wait") if r.attrs["frame"] == k]
        window, = [r for r in _by(recs, "window") if r.attrs["block"] == k - 1]
        assert wait.attrs["block"] == k - 1
        assert read.end_ns <= up.start_ns and up.end_ns <= put.start_ns
        assert put.start_ns <= wait.end_ns <= window.start_ns
        outs = {r.attrs["out"]: r for r in _by(recs, "download") if r.attrs["block"] == k - 1}
        writes = {r.attrs["out"]: r for r in _by(recs, "write") if r.attrs["block"] == k - 1}
        assert outs and set(outs) == set(writes)
        for seq, dl in outs.items():
            assert window.end_ns <= dl.start_ns and dl.end_ns <= writes[seq].start_ns
    # the outputs' sequence numbers run through the blocks in order
    seqs = [r.attrs["out"] for r in sorted(_by(recs, "write"), key=lambda r: r.start_ns)]
    assert seqs == list(range(profiled.frames_out))


def test_download_holds_its_wait_and_copy_out(profiled):
    """Each ``download`` holds one ``d2h-wait`` (asleep on the frame's
    event; nothing to wait for on the CPU) and then one ``copy-out``, as its
    children, on its thread and inside its interval."""
    recs = profiled.records
    downloads = {r.id: r for r in _by(recs, "download")}
    assert len(downloads) == profiled.frames_out
    for name in ("d2h-wait", "copy-out"):
        children = _by(recs, name)
        assert sorted(r.parent for r in children) == sorted(downloads)
        for r in children:
            dl = downloads[r.parent]
            assert r.thread == dl.thread
            assert dl.start_ns <= r.start_ns <= r.end_ns <= dl.end_ns
    wait = {r.parent: r for r in _by(recs, "d2h-wait")}
    for r in _by(recs, "copy-out"):
        assert wait[r.parent].end_ns <= r.start_ns
    for name in ("d2h-wait", "copy-out"):
        assert profiled.spans[f"download/{name}"][1] == profiled.frames_out


def test_download_wait_reader_reads_the_programs_report(profiled):
    """``benchmark/metrics/download_wait_ms.py`` gives the mean ``d2h-wait``
    in ms per frame written from the program's report, and nothing from a
    report without the span (the program before it had one)."""
    from benchmark import cells
    from benchmark.trace import Trace

    read = cells.metric_reader("download_wait_ms")
    stages = parse_stages(profiled.stage_report)
    total, count = profiled.spans["download/d2h-wait"]
    assert count == profiled.frames_out
    # the report rounds seconds to 1 ms
    assert read(Trace(stages=stages)) == pytest.approx(total / count * 1e3, abs=1.0 / count)
    without = {k: v for k, v in stages.items() if not k.endswith(("/d2h-wait", "/copy-out"))}
    assert "download/download" in without
    assert read(Trace(stages=without)) is None
    assert read(Trace(stages={**without, "download/d2h-wait": (0.0, 0)})) is None


def test_without_a_recorder_no_span_site_reads_the_clock(rife, monkeypatch):
    """``profile=False`` with no recorder active: nothing recorded, and no
    span site reads the clock (patched to raise)."""
    def clock():
        raise AssertionError("a span site read the clock")

    monkeypatch.setattr(profiling, "_clock", clock)
    stats = run_pipeline(rife, _IO(_frames()), enable_scdet=True)
    assert stats.frames_out > 0 and stats.scene_cuts >= 1
    assert stats.stage_report is None and stats.spans is None and stats.records is None
    # the patch bites where a recorder is active
    with pytest.raises(AssertionError, match="read the clock"):
        run_pipeline(rife, _IO(_frames()), enable_scdet=True, profile=True)
    assert profiling.active() is None


class _StandInGraph:
    """A replay reruns the captured callable into the static outputs."""

    def capture(self, fn, stream, pool):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        new = self.fn()
        for dst, src in zip(self.out, new):
            if dst is not None:
                dst.copy_(src)


class _Owner:
    pass


def test_graph_calls_are_spans_with_their_outcome():
    """``call`` spans: eager below ``CAPTURE_AT``, capture at it, replay
    after; the counters agree, captures add their seconds and pool bytes."""
    owner = _Owner()
    wg = graphs.WindowGraphs(owner, graph_factory=_StandInGraph)
    a, b = torch.rand(1, 8, 8, 3), torch.rand(1, 8, 8, 3)
    ts = np.array([0.25, 0.5, 0.75], np.float32)

    def plain(args, t):
        return args[0] + t.view(-1, 1, 1, 1) * (args[1] - args[0]), None

    def pass_(args, _t):
        return None, args[0] * 2 + args[1]

    calls = [("plain", plain, ts), ("pass", pass_, None), ("window", plain, ts)]
    with profiling.tracer() as st:
        for _ in range(3):
            for kind, fn, host in calls:
                wg.call(kind, (kind,), fn, (a, b), host)
    assert profiling.active() is None
    got = [(r.attrs["kind"], r.attrs["outcome"], r.attrs["T"]) for r in _by(st.records, "call")]
    want = []
    for i in range(3):
        for kind, _, host in calls:
            at = i + 1  # the key's call number
            outcome = ("eager" if at < graphs.CAPTURE_AT[kind]
                       else "capture" if at == graphs.CAPTURE_AT[kind] else "replay")
            want.append((kind, outcome, 0 if host is None else len(host)))
    assert got == want
    assert {r.thread for r in _by(st.records, "call")} == {"loop"}
    n = Counter(f"graphs.{outcome}.{kind}" for kind, outcome, _ in want)
    assert {k: v for k, v in st.counters.items() if k.split(".")[1] in
            ("eager", "capture", "replay")} == dict(n)
    captures = [r for r in _by(st.records, "call") if r.attrs["outcome"] == "capture"]
    assert st.counters["graphs.capture_s"] == pytest.approx(sum(r.seconds for r in captures))
    assert st.counters["graphs.pool_bytes"] == 0  # the CPU reserves nothing
    # a replay's frames are the eager body's
    frames, _ = wg.call("plain", ("plain",), plain, (a, b), ts)
    for f, w in zip(frames, plain((a, b), torch.from_numpy(ts))[0].unbind(0)):
        torch.testing.assert_close(f, w)


def test_spans_lie_on_the_profilers_clock():
    """Spans recorded inside ``record_function`` ranges, on the loop's
    thread and on another, lie within 0.5 ms of the ranges on the CPU
    profiler's clock; the loop's own spans are ranges named ``drba.<span>``."""
    from torch.profiler import ProfilerActivity, profile

    tol = 500_000  # ns
    with profiling.tracer() as st, profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            torch.ones(4).sum()
        for i in range(8):
            with torch.profiler.record_function(f"probe.main.{i}"):
                with st.span("probe", i=i):
                    torch.ones(64, 64).sum()

            def other(i=i):
                with st.span("other", i=i):
                    torch.ones(64, 64).sum()

            with torch.profiler.record_function(f"probe.other.{i}"):
                t = threading.Thread(target=other, name="other")
                t.start()
                t.join()
    all_events = prof.profiler.kineto_results.events()
    events = {e.name(): e for e in all_events}
    lags = []
    for r in st.records:
        e = events[f"probe.{'main' if r.name == 'probe' else 'other'}.{r.attrs['i']}"]
        lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        assert lo - tol <= r.start_ns <= r.end_ns <= hi + tol, (r, lo, hi)
        if r.name == "probe":
            lags.append(r.start_ns - lo)
    # a thread may be preempted between entering the range and reading the
    # clock: the clocks' offset is the least lag
    assert min(lags) < tol
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in all_events
                    if e.name() == "drba.probe")
    spans = [(r.start_ns, r.end_ns) for r in _by(st.records, "probe")]
    assert len(spans) == len(ranges) == 8
    for (s0, s1), (r0, r1) in zip(spans, ranges):
        assert r0 - tol <= s0 <= s1 <= r1 + tol
    assert min(abs(s0 - r0) for (s0, _), (r0, _) in zip(spans, ranges)) < tol
    assert {r.thread for r in _by(st.records, "other")} == {"other"}


def test_records_are_bounded_and_counts_exact_across_threads():
    st = profiling.StageTimes(max_records=100)

    def spans(name):
        st.name_thread(name)
        for j in range(500):
            with st.span("x", j=j):
                pass
            st.add("n")

    threads = [threading.Thread(target=spans, args=(f"w-{k}",)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert st.spans["w/x"][1] == 2000 and st.counters["n"] == 2000
    assert len(st.records) == 100 and st.counters["records.dropped"] == 1900
    # nested spans name their parent
    with st.span("outer") as outer, st.span("inner") as inner:
        pass
    assert inner.parent == outer.id and outer.parent is None


def test_report_parses_into_the_old_stages(profiled):
    """The ``--profile`` report: the five stages under their own names and
    counts, as ``benchmark/trace.parse_stages`` reads them, and every other
    span as ``<thread>/<span>`` lines of the same format."""
    got = parse_stages(profiled.stage_report)
    n = Counter(r.name for r in profiled.records)
    for stage in OLD_STAGES:
        assert got[stage][1] == n[stage]
        assert got[stage][0] == pytest.approx(
            sum(r.seconds for r in _by(profiled.records, stage)), abs=2e-3)
    assert got["prefetch-wait"][1] == profiled.windows + 1  # the last finds the end
    others = {k for k in got if k not in OLD_STAGES}
    assert others == set(profiled.spans) - {f"loop/{s}" for s in OLD_STAGES}
    for key in ("prefetch/read", "prefetch/upload", "prefetch/put-wait", "download/download",
                "writer/write", "loop/read", "loop/upload"):
        assert got[key][1] == profiled.spans[key][1]


def test_cli_profile_records_the_load(tmp_path, capsys):
    """``cli --profile`` opens one recorder over the model's load and the
    run: the report has the ``load`` span beside the threads' spans."""
    import cv2

    from drba_tpu_torch.cli import main

    inp = str(tmp_path / "in.mp4")
    vw = cv2.VideoWriter(inp, cv2.VideoWriter_fourcc(*"mp4v"), 12, (W, H))
    for f in _frames(5, cut_at=()):
        vw.write(f)
    vw.release()
    stats = main(["-m", "rife", "-i", inp, "-o", str(tmp_path / "out.mp4"), "-t", "2", "--fp32",
                  "--device", "cpu", "--weights", str(tmp_path / "none"), "--profile"])
    printed = capsys.readouterr().out
    got = parse_stages(printed)
    assert got["loop/load"][1] == 1 and stats.spans["loop/load"][1] == 1
    assert got["window"][1] == stats.windows + 2
    assert got["writer/write"][1] == stats.frames_out == 10
    assert profiling.active() is None
    load, = _by(stats.records, "load")
    assert load.attrs == {"model": "rife", "scale": 1.0}  # no GMFlow


@pytest.mark.parametrize("scale,frame,flow", [(1.0, (1080, 1920), "576x960"),
                                              (0.5, (2160, 3840), "576x960"),
                                              (0.5, (128, 256), "64x64")])
def test_load_span_names_the_flow_path(scale, frame, flow):
    """GMFSS_UNION's ``load`` span names its flow scale and GMFlow's input
    for the source frame size: at 4K and ``-scale 0.5`` the 1080p path's."""
    from drba_tpu_torch.cli import load_model
    from drba_tpu_torch.config import Config

    with profiling.tracer() as st:
        model = load_model("gmfss_union", "no-weights", scale,
                           Config(compute_dtype=torch.float32), "cpu", frame=frame)
    load, = _by(st.records, "load")
    assert load.attrs == {"model": "gmfss_union", "scale": scale, "flow_px": flow}
    # the program's own sizes: pad to the network size, halve, scale
    net = get_valid_net_inp_size(np.empty((*frame, 3), np.uint8), scale, model.pad_size)
    half = torch.empty(1, *(d // 2 for d in net["dst_size"]), 3)
    got = scale_by(half, scale) if scale != 1.0 else half
    assert f"{got.shape[1]}x{got.shape[2]}" == flow
