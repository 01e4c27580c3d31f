"""The ``plain``, ``pass`` and ``unfused`` graphs of drba_tpu_torch/graphs.py on the CPU.

The CPU never captures, so ``graphs.on`` is set True here and every graph
is the stand-in of tests/test_torch_graphs.py, which reruns the captured
callable at each replay: that checks the runner's own logic. Covered: the
``plain`` entries at T = 1 and 2 as they alternate, the second-call capture
rule (call counts, captures, replays), the pass with and without its
features, the ``unfused`` windows, the planner over two CPU replicas
through the runner, and a ``-s`` ``run_pipeline`` through the runner twice,
every call of the second run a replay. Each runs bitwise against the eager
call, and each kind against drba_tpu's jitted program on the same numpy
inputs (``_ts_batch``, ``_flow_jit``, ``_drba_window``): frames within 1e-3
but for at most 5e-3 of values, the reuse within 1e-4. Seed-0 random-weight
RIFE in float32 at 64x128, one torch thread; GMFSS in
tests/test_torch_graph_calls_gmfss.py.
"""

import copy
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import drba_tpu.models.gmfss as jgmfss
import drba_tpu.models.rife as jrife
from drba_tpu.config import F32 as JAX_F32
from drba_tpu.models.rife import RIFE as JaxRIFE
from drba_tpu_torch import graphs
from drba_tpu_torch.config import F32
from drba_tpu_torch.models.rife import RIFE
from drba_tpu_torch.graphs import _leaves
from drba_tpu_torch.models.base import Model
from drba_tpu_torch.parallel.batch import WindowPlanner
from drba_tpu_torch.pipeline import run_pipeline
from tests.test_torch_graphs import StandInGraph, _close_but_flips, _frames

H, W = 64, 128
# the share of frame values that may sit across a coverage threshold
# (tests/test_torch_gmfss.py's)
FLIP_SHARE = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the machine: one PyTorch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graphed(monkeypatch):
    """Every model call through the runner, every graph a stand-in."""
    monkeypatch.setattr(graphs, "on", lambda model: True)
    monkeypatch.setattr(graphs, "CudaGraph", StandInGraph)
    StandInGraph.made.clear()


@pytest.fixture(scope="module")
def rife():
    return RIFE(weights=None, config=F32, device="cpu")


@pytest.fixture(scope="module")
def jax_rife():
    return JaxRIFE(weights=None, config=JAX_F32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _kinds(st):
    """{kind: [(calls, replays) per entry or pending key]} of a runner."""
    out = {}
    for key in sorted(set(st.calls) | set(st.entries), key=str):
        e = st.entries.get(key)
        out.setdefault(key[0], []).append((st.calls[key], None if e is None else e.replays))
    return out


def _equal(got, want):
    assert len(_leaves(got)) == len(_leaves(want))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w)


def test_plain_entries_alternate_T_and_capture_at_their_second_call(rife, jax_rife, graphed):
    """``inference_ts`` at T = 1 and 2 in turns, the values changing: each
    key's first call runs eagerly (counted, nothing captured), its second
    warms up and captures, later ones replay; one entry per T whatever the
    values (they are data). Every call equals the eager ``_plain`` bitwise
    and drba_tpu's ``_ts_batch`` within 1e-3."""
    m = copy.copy(rife)
    st = graphs.state(m)
    fr = [_t(f) for f in _frames(2)]
    schedule = [[0.4], [0.2, 0.6], [0.7], [0.3, 0.5], [0.5], [0.1, 0.9]]
    key = {n: ("plain", n, (1, H, W, 3), torch.float32, torch.device("cpu")) for n in (1, 2)}
    seen = []
    for k, ts in enumerate(schedule):
        got = m.inference_ts(*fr, ts)
        want = m._plain(*fr, m._ts(ts)).unbind(0)
        jo = jax_rife.inference_ts(*(_j(f) for f in fr), ts)
        assert len(got) == len(ts)
        for g, w, j in zip(got, want, jo):
            assert torch.equal(g, w)
            _close_but_flips(g, j, 1e-3, what=f"plain call {k}")
        seen.append({n: (st.calls[key[n]], st.entries[key[n]].replays if key[n] in st.entries
                         else None) for n in (1, 2)})
    assert seen == [{1: (1, None), 2: (0, None)}, {1: (1, None), 2: (1, None)},
                    {1: (2, 0), 2: (1, None)}, {1: (2, 0), 2: (2, 0)},
                    {1: (2, 1), 2: (2, 0)}, {1: (2, 1), 2: (2, 1)}]
    assert len(StandInGraph.made) == 2 and set(st.entries) == set(key.values())


def test_pass_with_and_without_features(rife, jax_rife, graphed):
    """RIFE's chain-start pass (no features) and ``next_reuse`` (I1's
    features given) are two ``pass`` keys, each captured at its second
    call and replayed at its third; the features given come back as the
    caller's own tensors, the rest bitwise the eager ``_pass``'s and within
    1e-4 of drba_tpu's ``_flow_jit``."""
    m = copy.copy(rife)
    st = graphs.state(m)
    fr = [_t(f) for f in _frames(3, seed=1)]
    want0 = m._pass(fr[1], fr[0])
    f1 = want0[2]
    jf0 = jax_rife._calc_flow(_j(fr[1]), _j(fr[0]))
    jf1 = jax_rife._calc_flow(_j(fr[1]), _j(fr[2]), f0=_j(f1))
    for _ in range(3):
        got0 = m.reuse(fr[1], fr[0])
        got1 = m.next_reuse(fr[1], fr[2], f1)
        _equal(got0, want0)
        assert got1[3] is f1
        flow12, flow21, _, f2 = m._pass(fr[1], fr[2], f1)
        _equal(got1, (flow21, flow12, f2, f1))
        for g, j in zip(got0, jf0):
            _close_but_flips(g, j, 1e-4, share=0.0, what="chain-start pass")
        for g, j in zip((got1[1], got1[0], got1[3], got1[2]), jf1):
            _close_but_flips(g, j, 1e-4, share=0.0, what="next_reuse pass")
    shape, dt, cpu = (1, H, W, 3), torch.float32, torch.device("cpu")
    assert {k: (st.calls[k], e.replays) for k, e in st.entries.items()} == {
        ("pass", shape, dt, cpu, (False, False)): (2, 1),
        ("pass", shape, dt, cpu, (True, False)): (2, 1)}


def _jax_unfused(name, jm, I0, I1, I2, ts, reuse10, reuse21, linear):
    """drba_tpu's unfused window program on the port's inputs."""
    cfg = jm.config
    fr = [_j(x) for x in (I0, I1, I2)]
    tsv = jnp.asarray(np.float32(ts))
    if name == "rife":
        flow10, _, f1, f0 = (_j(x) for x in reuse10)
        _, flow12, f2, _ = (_j(x) for x in reuse21)
        return jrife._drba_window(jm.params, *fr, tsv, flow10, flow12, f0, f1, f2,
                                  jm.scale_list, linear, cfg.splat_backend, cfg.warp_backend,
                                  cfg.drm_splat_scale, cfg.conv_backend)
    to_j = type(reuse10)
    r10 = to_j(*(_j(x) if isinstance(x, torch.Tensor) else tuple(map(_j, x)) for x in reuse10))
    r12 = reuse21.swapped()
    r12 = to_j(*(_j(x) if isinstance(x, torch.Tensor) else tuple(map(_j, x)) for x in r12))
    return jgmfss._drba_window(jm.params, *fr, tsv, r10, r12, linear, cfg.splat_backend,
                               cfg.drm_splat_scale, cfg.conv_backend)


def check_unfused_windows(name, model, jm):
    """``drba_window`` over five windows of alternating T = 3 and 2 and a
    nonlinear one: per T the first call eager, the second captured, the
    third replayed; the nonlinear window a key of its own (its values).
    Frames bitwise the eager ``_window``, and the first and the nonlinear
    window within 1e-3 (at most 5e-3 of values beyond) of drba_tpu's
    ``_drba_window``."""
    m = copy.copy(model)
    st = graphs.state(m)
    fr = [_t(f) for f in _frames(7, seed=3)]
    reuses = [m._pass(fr[1], fr[0])]
    for k in range(5):
        feats = reuses[k][2] if name == "rife" else reuses[k].feat0
        nxt = m._pass(fr[k + 1], fr[k + 2], feats)
        reuses.append(nxt[1::-1] + nxt[3:1:-1] if name == "rife" else nxt.swapped())
    windows = [(k, [0.6, 1.0, 1.4] if k % 2 == 0 else [0.8, 1.2], True) for k in range(5)]
    windows.append((1, [0.55, 1.35], False))
    for k, ts, linear in windows:
        args = (*fr[k:k + 3], ts, reuses[k], reuses[k + 1])
        got = m.drba_window(*args, linear=linear)
        host = graphs.host_timesteps(ts)
        want = m._window(*fr[k:k + 3], m._ts(ts), host, reuses[k], reuses[k + 1],
                         linear).unbind(0)
        assert len(got) == len(ts)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if k == 0 or not linear:  # one drba_tpu compile per program signature
            for g, j in zip(got, _jax_unfused(name, jm, *args, linear)):
                _close_but_flips(g, j, 1e-3, share=FLIP_SHARE, what=f"window {k} {ts}")
    assert sorted((k[1], k[4], st.calls[k], e.replays) for k, e in st.entries.items()) == [
        (2, True, 2, 0), (3, True, 2, 1)]
    assert [st.calls[k] for k in st.calls if not k[4]] == [1]  # the nonlinear key, eager


def test_unfused_windows_match_drba_window(rife, jax_rife, graphed):
    check_unfused_windows("rife", rife, jax_rife)


def test_planner_over_two_cpu_replicas_through_the_runner_matches_serial(rife, graphed,
                                                                         monkeypatch):
    """The planner's replicas run ``next_reuse`` and ``drba_window`` through
    their own runners: over eight windows each replica's pass and its
    window's ``unfused`` key replay, and every window's frames and the
    final carry equal the serial eager chain's bitwise."""
    fr = [_t(f) for f in _frames(10, seed=4)]
    windows = [(*fr[k:k + 3], np.asarray([0.6, 1.0, 1.4] if k % 2 == 0 else [0.8, 1.2]))
               for k in range(8)]
    with monkeypatch.context() as eager:
        eager.setattr(graphs, "on", lambda model: False)
        reuse, want = None, []
        for w in windows:
            out, reuse = rife.inference_ts_drba(*w, reuse, linear=True)
            want.append(out)
    planner = WindowPlanner(["cpu", "cpu"], rife)
    try:
        got = list(planner.run(windows))
        carry = planner.carry
    finally:
        planner.close()
    for g, w in zip(got, want):
        _equal(g, w)
    _equal(carry, reuse)
    for rep in planner.replicas:
        kinds = _kinds(graphs.state(rep))
        assert set(kinds) == {"pass", "unfused"}
        assert all(r for calls in kinds.values() for _, r in calls)


def test_captures_on_several_threads_run_one_at_a_time(graphed):
    """Eight threads, each a model copy's runner, capture at once (a pass
    key's second call): a capture never starts while another is in flight,
    which a synchronise on one thread would break on the card."""
    import sys
    import threading

    class Overlap(StandInGraph):
        lock, active, most = threading.Lock(), 0, 0

        def capture(self, fn, stream, pool):
            with Overlap.lock:
                Overlap.active += 1
                Overlap.most = max(Overlap.most, Overlap.active)
            try:
                time.sleep(0.01)
                return super().capture(fn, stream, pool)
            finally:
                with Overlap.lock:
                    Overlap.active -= 1

    class Tiny(Model):
        device = torch.device("cpu")

        def _pass(self, a, b):
            return a + b, a - b

    models = [Tiny() for _ in range(8)]
    for m in models:
        graphs.state(m).graph_factory = Overlap
    x = torch.ones(1, 4, 4, 3)
    start = threading.Barrier(len(models))

    def work(m):
        start.wait(timeout=10)
        for _ in range(3):  # eager, capture, replay
            assert torch.equal(m.reuse(x, x)[0], x + x)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(m,)) for m in models]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert Overlap.most == 1
    assert all(e.replays == 1 for m in models for e in graphs.state(m).entries.values())


def _stream(n, cuts, h=H, w=W):
    """``n`` uint8 frames of a pan, frames ``cuts`` colour-inverted."""
    yy, xx = np.mgrid[0:h, 0:w + 6 * n].astype(np.float32)
    base = np.stack([np.sin(xx / 7.0 + k) * np.cos(yy / 5.0 - k) for k in range(3)], -1)
    base = ((base * 0.4 + 0.5) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(base[:, 6 * i:6 * i + w]) for i in range(n)]
    for i in cuts:
        frames[i] = 255 - frames[i]
    return frames


class _IO:
    src_fps, dst_fps = 24.0, 60.0

    def __init__(self, frames):
        self._frames, self.written = list(frames), []

    def read_frame(self):
        return self._frames.pop(0) if self._frames else None

    def write_frame(self, frame):
        self.written.append(frame)

    def finish_writing(self):
        return True


def check_scene_cut_pipeline(model, n, cuts, monkeypatch):
    """``run_pipeline -s`` twice on one model instance through the runner:
    the first run captures (head, cut windows, chain starts, tail, the
    windows), every ``plain``, ``pass`` and ``window`` call of the second
    replays, and both write the eager run's frames bitwise."""
    m = copy.copy(model)
    with monkeypatch.context() as eager:
        eager.setattr(graphs, "on", lambda model: False)
        io = _IO(_stream(n, cuts))
        run_pipeline(m, io, enable_scdet=True, scdet_threshold=0.3)
        want = io.written
    st = graphs.state(m)
    for run in range(2):
        calls = dict(st.calls)
        replays = {k: e.replays for k, e in st.entries.items()}
        io = _IO(_stream(n, cuts))
        stats = run_pipeline(m, io, enable_scdet=True, scdet_threshold=0.3)
        assert stats.scene_cuts == 2 * len(cuts)
        assert len(io.written) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(io.written, want))
    assert dict(st.calls) == calls  # no eager call, no capture in the second run
    kinds = {k[0] for k in st.entries}
    assert kinds == {"window", "plain", "pass"}
    assert all(e.replays > replays[k] for k, e in st.entries.items())


def test_scene_cut_pipeline_through_the_runner_matches_eager(rife, graphed, monkeypatch):
    """RIFE over 16 frames, frames 4 and 10 colour-inverted: four cuts."""
    check_scene_cut_pipeline(rife, 16, (4, 10), monkeypatch)
