"""The window graphs of drba_tpu_torch/graphs.py on the CPU, with a stand-in graph.

The CPU never captures a CUDA graph (the models run their eager window
there), so these tests hand ``graphs.WindowGraphs`` a stand-in graph that
records the captured callable and, at each replay, reruns it into the
static outputs it returned at capture. That checks the runner's own logic:
the cache key, the T = 2 and T = 3 entries reused as they alternate, fresh
outputs that outlive the next replay, the launch counts a replay adds, a
failing capture raising, and timesteps that are never read back from the
card; and the chain of windows through it against drba_tpu's fused window
(``_drba_window_fused`` behind ``inference_ts_drba``) on the same seed-0
parameters and numpy inputs, float32. The real capture runs on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import copy
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drba_tpu.config import F32 as JAX_F32
from drba_tpu.models.rife import RIFE as JaxRIFE
from drba_tpu_torch import _build, graphs
from drba_tpu_torch.config import F32
from drba_tpu_torch.drm import _retime_batched, calc_drm_rife
from drba_tpu_torch.graphs import _leaves
from drba_tpu_torch.models.rife import RIFE

H, W = 64, 128
TS2, TS3 = [0.7, 1.3], [0.6, 1.0, 1.4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the machine: one PyTorch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandInGraph:
    """Records the captured callable; a replay reruns it (its launches
    recorded apart: a real replay makes none through ``Kernel.launch``) and
    copies the results into the static outputs it returned at capture."""

    made = []

    def __init__(self):
        StandInGraph.made.append(self)
        self.replays = 0

    def capture(self, fn, stream, pool):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        with _build.recording():
            new = self.fn()
        for dst, src in zip(_leaves(self.out), _leaves(new)):
            dst.copy_(src)
        self.replays += 1


def _runner(model, factory=StandInGraph):
    st = graphs.state(model)
    st.graph_factory = factory
    return st


def _frames(n, h=H, w=W, seed=0, step=3):
    base = np.random.default_rng(seed).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [np.ascontiguousarray(base[:, :, step * i:step * i + w]) for i in range(n)]


def _t(x):
    return torch.from_numpy(x)


def _close_but_flips(got, want, atol, share=5e-3, what=""):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert float((d > atol).mean()) <= share, f"{what}: max {d.max():.3e}"


@pytest.fixture(scope="module")
def rife():
    return RIFE(weights=None, config=F32, device="cpu")


def _eager(model, I0, I1, I2, ts, reuse, linear=True):
    """The eager pieces the graph fuses: next_reuse, then the timesteps."""
    nxt = model.next_reuse(I1, I2, reuse.feat0)
    return model.drba_window(I0, I1, I2, ts, reuse, nxt, linear), nxt


def test_windows_alternating_T_reuse_two_entries_and_match_drba_tpu(rife):
    """Five chained windows at 24 -> 60's alternating T = 3, 2: two captures,
    three replays; every window equal to the eager pieces bitwise, and
    within drba_tpu's fused window's tolerance (the RIFE parity tests'
    1e-3 on frames, 1e-4 on the carried flows and features)."""
    StandInGraph.made.clear()
    m = copy.copy(rife)  # an instance of its own: an empty cache
    st = _runner(m)
    jm = JaxRIFE(weights=None, scale=1.0, config=JAX_F32)
    fr = _frames(7)
    tf = [_t(f) for f in fr]
    reuse = m.reuse(tf[1], tf[0])
    want_reuse, jr = reuse, None
    for k in range(5):
        ts = TS3 if k % 2 == 0 else TS2
        got, nxt = st.run(m._fused_window, *tf[k:k + 3], ts, reuse, True)
        want, want_nxt = _eager(m, *tf[k:k + 3], ts, want_reuse)
        jo, jr = jm.inference_ts_drba(*(jnp.asarray(f) for f in fr[k:k + 3]), ts, jr,
                                      linear=True)
        assert len(got) == len(ts)
        for g, w, j in zip(got, want, jo):
            assert torch.equal(g, w)
            _close_but_flips(g, j, 1e-3, what=f"window {k}")
        for g, w, j in zip(nxt, want_nxt, jr):
            assert torch.equal(g, w)
            _close_but_flips(g, j, 1e-4, what=f"window {k} reuse")
        reuse, want_reuse = nxt, want_nxt
    assert len(StandInGraph.made) == 2 and len(st.entries) == 2
    assert sorted(g.replays for g in StandInGraph.made) == [1, 2]


def test_cache_key(rife):
    """One entry per ("window", T, frame shape, dtype, linear, device); linear windows
    of other timestep values share it, nonlinear ones do not (their
    bisection schedule is host control flow)."""
    m = copy.copy(rife)
    st = _runner(m)
    tf = [_t(f) for f in _frames(3)]
    reuse = m.reuse(tf[1], tf[0])
    for ts, linear in ((TS3, True), ([0.7, 1.1, 1.3], True), (TS2, True), (TS3, False),
                       ([0.7, 1.1, 1.3], False), (TS3, False)):
        st.run(m._fused_window, *tf, ts, reuse, linear)
    shape, f32, cpu = (1, H, W, 3), torch.float32, torch.device("cpu")
    assert set(st.entries) == {
        ("window", 3, shape, f32, True, cpu), ("window", 2, shape, f32, True, cpu),
        ("window", 3, shape, f32, False, cpu, tuple(np.float32(TS3).tolist())),
        ("window", 3, shape, f32, False, cpu, tuple(np.float32([0.7, 1.1, 1.3]).tolist()))}


@pytest.mark.parametrize("name", ["rife", "gmfss"])
def test_window_outputs_survive_the_next_replay(rife, name):
    """Window k's frames and reuse are fresh tensors: window k+1's replay of
    the same entry leaves them unchanged, none shares memory with the
    entry's static buffers, and the features the chain passes through come
    back as the caller's own tensors."""
    if name == "rife":
        m, h, w = copy.copy(rife), H, W
    else:
        from drba_tpu_torch.models.gmfss import GMFSS

        m, h, w = GMFSS(weights=None, config=F32, device="cpu"), 64, 128
    st = _runner(m)
    tf = [_t(f) for f in _frames(5, h, w, seed=4)]
    reuse = m.reuse(tf[1], tf[0])
    outs = []
    for k in range(3):  # capture, then two replays of the one T = 2 entry
        frames, nxt = st.run(m._fused_window, *tf[k:k + 3], TS2, reuse, True)
        passed, given = _leaves(nxt.feat1), _leaves(reuse.feat0)
        assert len(passed) == len(given) and all(a is b for a, b in zip(passed, given))
        outs.append([(t, t.clone()) for t in frames + _leaves(nxt)])
        reuse = nxt
    (entry,) = st.entries.values()
    statics = [entry.out, entry.ts, *entry.inputs, *_leaves(entry.nxt)]
    for window in outs[1:]:
        for t, saved in window:
            assert torch.equal(t, saved)
            assert not any(t.untyped_storage().data_ptr() == s.untyped_storage().data_ptr()
                           for s in statics)


class _Launching:
    """A model whose window launches the splat kernel twice and the conv
    once (their C entries stubbed: the CPU has no card)."""

    device = torch.device("cpu")

    def _fused_window(self, I0, I1, I2, ts, ts_host, reuse, linear):
        for k in (_build.SPLAT, _build.SPLAT, _build.CONV):
            k.launch(device=torch.device("cuda"))
        return I1[None] * ts[:, None, None, None, None], (reuse[0] + 1,)


@pytest.fixture
def stub_kernels(monkeypatch):
    monkeypatch.setattr(_build.Kernel, "load", lambda self: None)
    for k in (_build.SPLAT, _build.CONV):
        monkeypatch.setattr(k, "_fns", {e: (lambda *a: 0) for e in k.entries})


def test_replay_counts_the_launches_its_capture_recorded(stub_kernels):
    """The warm-up's launches count (the card ran them), the capture's are
    recorded and not counted, and each replay adds what was recorded; a
    launch on another thread during a capture counts as usual."""
    m = _Launching()
    st = _runner(m)
    x = torch.ones(1, 4, 4, 3)
    n0 = _build.counts()

    def added():
        now = _build.counts()
        return {k: now[k] - n0[k] for k in now if now[k] != n0[k]}

    st.run(m._fused_window, x, x, x, TS3, (x,), True)
    assert added() == {"splat": 2, "conv_chain": 1}
    (entry,) = st.entries.values()
    assert entry.launches == {"splat": 2, "conv_chain": 1}
    for _ in range(3):
        st.run(m._fused_window, x, x, x, TS3, (x,), True)
    assert added() == {"splat": 8, "conv_chain": 4}
    with _build.recording() as rec:
        t = threading.Thread(target=lambda: _build.WARP.launch(device=torch.device("cuda")))
        _build.WARP.load = lambda: None
        _build.WARP._fns = {"drba_warp": lambda *a: 0}
        try:
            t.start()
            t.join()
        finally:
            del _build.WARP.load
            _build.WARP._fns = {}
        _build.SPLAT.launch(device=torch.device("cuda"))
    assert rec == {"splat": 1}
    assert added() == {"splat": 8, "conv_chain": 4, "warp": 1}
    _build.WARP.launches -= 1


def test_failed_capture_raises(stub_kernels):
    """A capture that fails raises and stores no entry, every time: no call
    falls back to the eager window. A replay on inputs of another shape
    than the captured ones raises too."""
    class Refusing(StandInGraph):
        def capture(self, fn, stream, pool):
            raise RuntimeError("operation not permitted when stream is capturing")

    m = _Launching()
    st = _runner(m, Refusing)
    x = torch.ones(1, 4, 4, 3)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing the window") as e:
            st.run(m._fused_window, x, x, x, TS2, (x,), True)
        assert "not permitted" in str(e.value.__cause__)
        assert st.entries == {}
    st.graph_factory = StandInGraph
    st.run(m._fused_window, x, x, x, TS2, (x,), True)
    with pytest.raises(ValueError, match="differs from the captured"):
        st.run(m._fused_window, x, x, x, TS2, (torch.ones(1, 4, 4, 2),), True)


class _OnCard(torch.Tensor):
    """A CPU tensor standing in for timesteps on the card: reading it back
    raises."""

    def tolist(self, *args, **kwargs):
        raise AssertionError("timesteps read back from the card")

    numpy = item = cpu = __array__ = __iter__ = __float__ = tolist


def test_ts_and_retime_never_read_the_card_back(rife, monkeypatch):
    """``_ts`` takes the host values the pipeline has, and the nonlinear
    retime builds its bisection schedule from them: given timesteps on the
    card, neither reads them back (a whole nonlinear window runs on them),
    and the maps equal those made from host timesteps."""
    ts = np.asarray([0.55, 1.0, 1.35])
    host = graphs.host_timesteps(ts)
    card = torch.from_numpy(host.copy()).as_subclass(_OnCard)
    with pytest.raises(AssertionError, match="read back"):
        rife._ts(card)  # a card tensor is refused, not read
    assert torch.equal(rife._ts(ts), torch.as_tensor(list(ts), dtype=torch.float32))

    tt = np.where(host < 1, 1 - host, host - 1)  # the retimed distances, in [0, 0.5]
    drm = torch.from_numpy(np.random.default_rng(2).uniform(0.1, 0.9, (1, 8, 8, 1))
                           .astype(np.float32))
    want = _retime_batched(drm, torch.from_numpy(tt), False)
    got = _retime_batched(drm, torch.from_numpy(tt).as_subclass(_OnCard), False, tt)
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    flows = [torch.from_numpy(np.random.default_rng(s).normal(0, 3, (1, H, W, 2))
                              .astype(np.float32)) for s in (5, 6)]
    for g, w in zip(calc_drm_rife(torch.from_numpy(tt).as_subclass(_OnCard), *flows,
                                  backend="torch", t_host=tt),
                    calc_drm_rife(torch.from_numpy(tt), *flows, backend="torch")):
        assert torch.equal(g.as_subclass(torch.Tensor), w)

    tf = [_t(f) for f in _frames(3, seed=3)]
    reuse = rife.reuse(tf[1], tf[0])
    nxt = rife.next_reuse(tf[1], tf[2], reuse.feat0)
    want = rife.drba_window(*tf, ts, reuse, nxt, linear=False)
    monkeypatch.setattr(rife, "_ts", lambda t: torch.from_numpy(
        graphs.host_timesteps(t)).as_subclass(_OnCard))
    got = rife.drba_window(*tf, ts, reuse, nxt, linear=False)
    for g, w in zip(got, want):
        assert torch.equal(g.as_subclass(torch.Tensor), w)


def test_the_cpu_never_captures_and_replicas_keep_their_own(rife):
    """On the CPU ``inference_ts_drba`` runs the eager window and makes no
    window cache; a shallow copy of a model (the planner's replicas) gets a
    cache of its own."""
    m = copy.copy(rife)
    tf = [_t(f) for f in _frames(3)]
    frames, nxt = m.inference_ts_drba(*tf, TS3, m.reuse(tf[1], tf[0]), linear=True)
    assert len(frames) == 3 and "_window_graphs" not in m.__dict__
    st = graphs.state(m)
    rep = copy.copy(m)
    assert graphs.state(rep) is not st and graphs.state(m) is st
