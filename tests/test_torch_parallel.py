"""The port's multi-device window planner and frame loop, on CPU replicas.

``WindowPlanner`` on two and three CPU replicas (one dispatch thread each)
against the port's serial ``inference_ts_drba`` chain, for RIFE, GMFSS and
GMFSS_UNION, within 1e-5 (f32; the same arithmetic, so it measures 0), and
against drba_tpu's planner on a 2-device virtual CPU mesh within 1e-4.
``run_pipeline_parallel`` against the serial ``run_pipeline`` on a stream
whose cuts take all four branches, bitwise on the written uint8 frames.
Seed-0 random-weight models in float32, one torch thread; RIFE and GMFSS at
64x128, GMFSS_UNION at 128x128 (its pad of 128).
"""

import importlib

import numpy as np
import pytest
import torch

from drba_tpu_torch.config import F32

# the consecutive windows' timesteps, as 24 -> 60 alternates T = 3 and 2
TS = [np.asarray(t) for t in ([0.6, 1.0, 1.4], [0.8, 1.2], [0.6, 1.0, 1.4], [0.8, 1.2])]
SIZES = {"rife": (64, 128), "gmfss": (64, 128), "gmfss_union": (128, 128)}
CLASSES = {"rife": "RIFE", "gmfss": "GMFSS", "gmfss_union": "GMFSS_UNION"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this file's small PyTorch CPU ops on one thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stills(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    return [np.roll(base, 3 * i, axis=2).copy() for i in range(n)]


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        cls = getattr(importlib.import_module(f"drba_tpu_torch.models.{name}"), CLASSES[name])
        _MODELS[name] = cls(config=F32, device="cpu")
    return _MODELS[name]


_SERIAL = {}


def _serial(name):
    """The serial chain over len(TS) windows: (windows, frames, final reuse)."""
    if name not in _SERIAL:
        m = _model(name)
        fr = [torch.from_numpy(f) for f in _stills(len(TS) + 2, *SIZES[name])]
        windows = [(fr[k], fr[k + 1], fr[k + 2], ts) for k, ts in enumerate(TS)]
        outs, reuse = [], None
        for w in windows:
            out, reuse = m.inference_ts_drba(*w, reuse, linear=True)
            outs.append(out)
        _SERIAL[name] = windows, outs, reuse
    return _SERIAL[name]


def _planner(name, n):
    from drba_tpu_torch.parallel.batch import WindowPlanner

    return WindowPlanner(["cpu"] * n, _model(name))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", list(CLASSES))
def test_planner_equals_serial_chain(name, n):
    """Four windows: two groups of two, or a group of three and a tail
    window through ``inference_ts_drba``; the planner's carry afterwards is
    the serial chain's reuse."""
    windows, want, reuse = _serial(name)
    planner = _planner(name, n)
    try:
        got = list(planner.run(windows))
        assert [len(g) for g in got] == [len(ts) for ts in TS]
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        for a, b in zip(_leaves(planner.carry), _leaves(reuse)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    finally:
        planner.close()


def _leaves(tree):
    from drba_tpu_torch.graphs import _leaves as leaves

    return leaves(tree)


def test_tail_group_smaller_than_the_devices():
    """One window on three devices runs through ``inference_ts_drba`` on the
    first, with the carry converted in; the next group takes its pass."""
    windows, want, _ = _serial("rife")
    planner = _planner("rife", 3)
    try:
        got = [list(planner.run(windows[:1])), list(planner.run(windows[1:]))]
        for g, w in zip(got[0] + got[1], want):
            for a, b in zip(g, w):
                assert torch.equal(a, b)
    finally:
        planner.close()


@pytest.mark.parametrize("name", ["rife", "gmfss"])
def test_planner_matches_jax_planner(name):
    """drba_tpu's planner on a 2-device virtual CPU mesh (a ppermute of the
    chain carry) against the port's on two CPU replicas, two windows."""
    import jax.numpy as jnp

    from drba_tpu.config import F32 as JAX_F32
    from drba_tpu.parallel.batch import WindowPlanner as JaxPlanner
    from drba_tpu.parallel.mesh import make_mesh

    jm = getattr(importlib.import_module(f"drba_tpu.models.{name}"),
                 CLASSES[name])(weights=None, config=JAX_F32)
    windows, _, _ = _serial(name)
    windows = windows[:2]
    mesh = make_mesh(2)
    with mesh:
        want = list(JaxPlanner(mesh, jm, ts_bucket=3).run(
            [tuple(jnp.asarray(x.numpy()) for x in w[:3]) + (w[3].astype(np.float32),)
             for w in windows]))
    planner = _planner(name, 2)
    try:
        got = list(planner.run(windows))
    finally:
        planner.close()
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [2, 3])
def test_exchange_accounting_counts_one_carry_per_boundary(n):
    from drba_tpu_torch.parallel.batch import exchange_accounting

    windows, _, _ = _serial("rife")
    planner = _planner("rife", n)
    try:
        acc = exchange_accounting(planner, windows)
    finally:
        planner.close()
    assert acc["carries"] == [(k, k + 1) for k in range(n - 1)]
    # RIFE's carry: flow21, flow12 (2 channels each), f2, f1 (the encoder's features)
    assert acc["carry_tensors"] == 4 * (n - 1)
    h, w = SIZES["rife"]
    f_ch = _model("rife").next_reuse(windows[0][1], windows[0][2])[2].shape[-1]
    assert acc["carry_bytes"] == (n - 1) * h * w * (2 + 2 + 2 * f_ch) * 4
    assert acc["frames"] == 0 and acc["frame_bytes"] == 0
    assert planner._carry is None  # the chain left as it was


def test_replicate_shares_the_parameters_on_the_same_device():
    from drba_tpu_torch.parallel.batch import replicate

    m = _model("gmfss")
    rep = replicate(m, "cpu")
    assert rep is not m and rep.device == torch.device("cpu")
    for net, rnet in zip(m.params, rep.params):
        assert net.keys() == rnet.keys()
        assert all(rnet[k] is net[k] for k in net)
    assert any(k.endswith(".wp") for k in rep.params.flownet)  # the packed layer weights


# ----------------------------------------------------------------------------- the frame loop


def _frames(n, cut_at=(), h=64, w=128):
    """Smooth content panning 2 px per frame; frames in ``cut_at`` invert
    the colours (as in tests/test_torch_scdet.py)."""
    x = np.linspace(0, 6 * np.pi, w)[None, :, None]
    y = np.linspace(0, 4 * np.pi, h)[:, None, None]
    p = np.arange(3)[None, None, :]
    base = ((np.sin(x + p) * np.cos(y - p) * 0.5 + 0.5) * 255).astype(np.uint8)
    out = []
    for i in range(n):
        base = 255 - base if i in cut_at else np.roll(base, 2, axis=1)
        out.append(base.copy())
    return out


class _FakeIO:
    src_fps, dst_fps = 24.0, 60.0
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


# 10 frames, frames 5 and 6 inverted: windows 0-2 clean (a group of three),
# 3 a right cut, 4 both, 5 a left cut (its pass is the chain), 6-7 clean
_N, _CUTS = 10, (5, 6)


@pytest.mark.parametrize("name,n", [("rife", 2), ("rife", 3), ("gmfss", 2)])
def test_parallel_pipeline_equals_serial(name, n):
    from drba_tpu_torch.parallel.pipeline import run_pipeline_parallel
    from drba_tpu_torch.pipeline import planned_outputs, run_pipeline

    m = _model(name)
    serial, par = _FakeIO(_frames(_N, _CUTS)), _FakeIO(_frames(_N, _CUTS))
    s = run_pipeline(m, serial, enable_scdet=True, scdet_threshold=0.3)
    p = run_pipeline_parallel(m, par, ["cpu"] * n, enable_scdet=True, scdet_threshold=0.3)
    assert (p.frames_in, p.frames_out, p.windows, p.scene_cuts) == \
        (s.frames_in, s.frames_out, s.windows, s.scene_cuts) == (_N, planned_outputs(_N, 24, 60),
                                                                  _N - 2, 2)
    for i, (a, b) in enumerate(zip(par.written, serial.written)):
        assert np.array_equal(a, b), f"output {i}"


def test_devices_above_the_card_count_raise_before_a_model_is_built(monkeypatch, tmp_path):
    from drba_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(cli, "load_model", no_model)
    with pytest.raises(RuntimeError, match="2 devices asked for, but PyTorch sees 1"):
        cli.main(["-i", str(tmp_path / "in.mp4"), "--devices", "2"])


def test_cli_devices_on_cpu_replicas(tmp_path, monkeypatch):
    """``--device cpu --devices 2`` runs the planner over two CPU replicas."""
    import cv2

    from drba_tpu_torch import cli
    from drba_tpu_torch.parallel.batch import WindowPlanner

    inp, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    vw = cv2.VideoWriter(inp, cv2.VideoWriter_fourcc(*"mp4v"), 12, (128, 64))
    for f in _frames(6):
        vw.write(f)
    vw.release()
    groups = []
    run = WindowPlanner.run
    monkeypatch.setattr(WindowPlanner, "run",
                        lambda self, w: (groups.append((self.batch, len(w))), run(self, w))[1])
    stats = cli.main(["-m", "rife", "-i", inp, "-o", out, "-t", "2", "--fp32", "--device", "cpu",
                      "--devices", "2", "--weights", str(tmp_path / "none")])
    assert stats.frames_out == 12 and groups == [(2, 2), (2, 2)]
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 12
    cap.release()
