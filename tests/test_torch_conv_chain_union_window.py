"""One GMFSS_UNION window, its nets' convs on the conv chain, against
drba_tpu's model built with ``conv_backend='pallas'`` on the CPU (its Pallas
conv chain in interpret mode, at MetricNet, FeatureNet level 1, GridNet's
L0/L1 and tail, and the auxiliary IFNet's ResConvs). GMFSS's window is
test_torch_conv_chain_windows.py.

Both packages run the same seeded random parameters in float32 on frames
made with numpy at 128x256 (union's pad of 128), as tests/test_torch_union.py
runs them, and are held to its tolerances: frames 1e-3 with a largest share
of values beyond it (the coverage < 0.999 hole fill and the 25x timestep
swap can flip a pixel on rounding), flows at FLOW_TOL pixels, the tanh * 10
metrics at 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drba_tpu.config import F32 as JAX_F32
from drba_tpu_torch.config import F32

FLIP_SHARE = 5e-3
FLOW_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per machine; keep this file's
    small PyTorch CPU ops on one thread instead of oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _frames(n, h, w, step=3):
    base = np.random.default_rng(0).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [np.ascontiguousarray(base[:, :, step * i:step * i + w]) for i in range(n)]


def test_union_chain_window_matches_jax_pallas():
    from drba_tpu.models.gmfss_union import GMFSS_UNION as JaxUnion
    from drba_tpu_torch.models.gmfss_union import GMFSS_UNION

    h, w, metric_tol = 128, 256, 1e-3
    jm = JaxUnion(weights=None, config=JAX_F32.replace(conv_backend="pallas"))
    m = GMFSS_UNION(config=F32, device="cpu")
    fr = _frames(3, h, w)
    ts = [0.5, 1.0, 1.3]
    jo, jr = jm.inference_ts_drba(*map(jnp.asarray, fr), ts, None, linear=True)
    to, tr = m.inference_ts_drba(*map(torch.from_numpy, fr), ts, None, linear=True)
    assert len(to) == len(jo) == len(ts)
    for i, (g, v) in enumerate(zip(to, jo)):
        assert tuple(g.shape) == (1, h, w, 3)
        d = np.abs(_np(g).astype(np.float64) - np.asarray(v))
        share = float((d > 1e-3).mean())
        assert share <= FLIP_SHARE, f"t={ts[i]}: {share:.2e} beyond 1e-3 (max {d.max():.3e})"
    for i, (g, v) in enumerate(zip(tr[:4], jr[:4])):
        np.testing.assert_allclose(_np(g), np.asarray(v), rtol=0,
                                   atol=FLOW_TOL if i < 2 else metric_tol,
                                   err_msg=f"reuse field {i}")
