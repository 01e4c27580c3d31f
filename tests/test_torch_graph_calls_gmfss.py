"""GMFSS's ``plain``, ``pass`` and ``unfused`` graphs (drba_tpu_torch/graphs.py) on the CPU.

The checks of tests/test_torch_graph_calls.py, with its stand-in graph, on a
seed-0 random-weight GMFSS in float32 at 64x128: ``inference_ts`` without a
reuse as a ``pass`` and a ``plain`` call, the pass with I1's features given,
the ``unfused`` windows, and a ``-s`` ``run_pipeline`` twice through the
runner. Bitwise against the eager calls; against drba_tpu's ``_reuse_jit``,
``_ts_batch`` and ``_drba_window`` at tests/test_torch_gmfss.py's tolerances
(flows 2e-3 px, metrics 1e-4, frames 1e-3 but for at most 5e-3 of values).
"""

import copy

import pytest
import torch

from drba_tpu.config import F32 as JAX_F32
from drba_tpu.models.gmfss import GMFSS as JaxGMFSS
from drba_tpu_torch import graphs
from drba_tpu_torch.config import F32
from drba_tpu_torch.models.gmfss import GMFSS
from tests.test_torch_graph_calls import (FLIP_SHARE, _close_but_flips, _equal, _frames, _j, _t,
                                          check_scene_cut_pipeline, check_unfused_windows)
from tests.test_torch_graph_calls import _one_torch_thread, graphed  # noqa: F401 (fixtures)

FLOW_TOL = 2e-3  # flows in pixels (tests/test_torch_gmfss.py)


@pytest.fixture(scope="module")
def gmfss():
    return GMFSS(weights=None, config=F32, device="cpu")


@pytest.fixture(scope="module")
def jax_gmfss():
    return JaxGMFSS(weights=None, config=JAX_F32)


def test_gmfss_inference_ts_without_reuse_is_a_pass_then_a_plain_call(gmfss, jax_gmfss,
                                                                      graphed):
    """GMFSS's ``inference_ts`` with no reuse runs the ``pass`` (no features)
    and then the ``plain`` call on its reuse: at the third call both
    replay. Frames bitwise the eager ``_pass`` + ``_plain`` and, like the
    reuse handed back, within test_torch_gmfss.py's tolerances of
    drba_tpu's ``_reuse_jit`` + ``_ts_batch``; the pass with features
    (``next_reuse``) a key of its own, its features handed back as the
    caller's."""
    m = copy.copy(gmfss)
    st = graphs.state(m)
    fr = [_t(f) for f in _frames(3, seed=2)]
    ts = [0.3, 0.7]
    reuse = m._pass(fr[0], fr[1])
    want = m._plain(fr[0], fr[1], m._ts(ts), reuse).unbind(0)
    jo, jr = jax_gmfss.inference_ts(_j(fr[0]), _j(fr[1]), ts, return_reuse=True)
    for _ in range(3):
        got, got_reuse = m.inference_ts(fr[0], fr[1], ts, return_reuse=True)
        _equal(got_reuse, reuse)
        for g, w, j in zip(got, want, jo):
            assert torch.equal(g, w)
            _close_but_flips(g, j, 1e-3, share=FLIP_SHARE, what="inference_ts")
    for i, (g, j) in enumerate(zip(got_reuse[:4], jr[:4])):
        _close_but_flips(g, j, FLOW_TOL if i < 2 else 1e-4, share=0.0, what=f"reuse field {i}")
    assert sorted((k[0], st.calls[k], e.replays) for k, e in st.entries.items()) == [
        ("pass", 2, 1), ("plain", 2, 1)]

    for _ in range(3):  # the pass with I1's features given, as next_reuse runs it
        nxt = m.next_reuse(fr[1], fr[2], reuse.feat1)
        assert all(a is b for a, b in zip(nxt.feat1, reuse.feat1))
        _equal(nxt, m._pass(fr[1], fr[2], reuse.feat1).swapped())
    assert sorted((k[0], k[-1], st.calls[k], e.replays) for k, e in st.entries.items()
                  if k[0] == "pass") == [("pass", (False,), 2, 1), ("pass", (True,), 2, 1)]


def test_unfused_windows_match_drba_window(gmfss, jax_gmfss, graphed):
    check_unfused_windows("gmfss", gmfss, jax_gmfss)


def test_scene_cut_pipeline_through_the_runner_matches_eager(gmfss, graphed, monkeypatch):
    """GMFSS over 6 frames, frame 3 colour-inverted: two cuts."""
    check_scene_cut_pipeline(gmfss, 6, (3,), monkeypatch)
