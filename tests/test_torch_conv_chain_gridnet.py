"""GridNet with its L0/L1 blocks and tail on the conv chain (the counterpart
of drba_tpu's ``_gridnet_fused``) against drba_tpu's ``conv_backend='pallas'``
lattice on the CPU (its Pallas conv chain in interpret mode), plain
(12-channel head) and union (9-channel head); and the port's lattice and its
GMFSS and GMFSS_UNION windows against the same nets spelled with eager layers
as FusionNet.py and FeatureNet.py write them.

Inputs are made with numpy from a seed, in float32, at the geometry of
tests/test_conv_chain.py (W % 16 == 0, H % 4 == 0, where drba_tpu takes the
chain).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import drba_tpu.models.gmfss_nets as jnets
from drba_tpu.models.layers import init_from_spec as jax_init
from drba_tpu_torch.config import F32
from drba_tpu_torch.convert import from_jax_params
from drba_tpu_torch.models import gmfss_core
from drba_tpu_torch.models import gmfss_nets as nets
from drba_tpu_torch.models.layers import conv2d, conv_transpose2d, prelu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per machine; keep this file's
    small PyTorch CPU ops on one thread instead of oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seq(p, prefix, x, stride=1, transpose=False):
    """Sequential(PReLU, Conv, PReLU, Conv) (FusionNet.py:7-33), eager."""
    a = prelu(p, f"{prefix}.0", x)
    y = (conv_transpose2d(p, f"{prefix}.1", a, stride=2, padding=1) if transpose
         else conv2d(p, f"{prefix}.1", a, stride=stride, padding=1))
    return conv2d(p, f"{prefix}.3", prelu(p, f"{prefix}.2", y), padding=1)


def _eager_gridnet(p, x, x1, x2, x3, union=False, conv_backend=None):
    """GridNet.forward (FusionNet.py:106-145) with eager layers."""
    head = "residual_model_head0" if union else "residual_model_head"
    X00 = _seq(p, head, x) + _seq(p, "residual_model_head1", x1)
    X01 = _seq(p, "residual_model_01", X00) + X00
    X10 = _seq(p, "downsample_model_10", X00, 2) + _seq(p, "residual_model_head2", x2)
    X20 = _seq(p, "downsample_model_20", X10, 2) + _seq(p, "residual_model_head3", x3)
    X11 = (_seq(p, "residual_model_11", X10) + X10) + _seq(p, "downsample_model_11", X01, 2)
    X21 = (_seq(p, "residual_model_21", X20) + X20) + _seq(p, "downsample_model_21", X11, 2)
    X24 = _seq(p, "residual_model_24", X21) + X21
    X25 = _seq(p, "residual_model_25", X24) + X24
    X14 = (_seq(p, "upsample_model_14", X24, transpose=True)
           + (_seq(p, "residual_model_14", X11) + X11))
    X04 = (_seq(p, "upsample_model_04", X14, transpose=True)
           + (_seq(p, "residual_model_04", X01) + X01))
    X15 = (_seq(p, "upsample_model_15", X25, transpose=True)
           + (_seq(p, "residual_model_15", X14) + X14))
    X05 = (_seq(p, "upsample_model_05", X15, transpose=True)
           + (_seq(p, "residual_model_05", X04) + X04))
    t = conv2d(p, "residual_model_tail.conv_before_upsample.0", X05, padding=1)
    t = prelu(p, "residual_model_tail.conv_before_upsample.1", t)
    return nets._tail_out(p, conv2d(p, "residual_model_tail.upsample.0", t, padding=1))


def _eager_featurenet(p, x, conv_backend=None):
    """FeatureNet.forward (FeatureNet.py:29-34) with eager layers."""
    outs = []
    for i in (1, 2, 3):
        x = conv2d(p, f"block{i}.1", prelu(p, f"block{i}.0", x), stride=2, padding=1)
        outs.append(conv2d(p, f"block{i}.3", prelu(p, f"block{i}.2", x), padding=1))
        x = outs[-1]
    return tuple(outs)


@pytest.mark.parametrize("union", [False, True])
def test_gridnet_chain_matches_jax_pallas(union):
    """The whole lattice at (2, 16, 32): 14 L0 and 12 L1 chain steps, the
    stride-2 and transposed convs and L2 on the plain convs. Held at rtol /
    atol 5e-4, as tests/test_conv_chain.py holds drba_tpu's chain lattice to
    its XLA lattice (f32 sums in another order through ~40 convs)."""
    spec = nets.GRIDNET_UNION_SPEC if union else nets.GRIDNET_SPEC
    jp = jax_init(spec, seed=3)
    p = from_jax_params({k: np.asarray(v) for k, v in jp.items()}, spec)
    rng = np.random.default_rng(8)
    cin = 9 if union else 12
    xs = [rng.normal(0, 1, s).astype(np.float32)
          for s in ((2, 16, 32, cin), (2, 16, 32, 128), (2, 8, 16, 256), (2, 4, 8, 384))]
    want = jnets.gridnet_apply(jp, *map(jnp.asarray, xs), union=union, conv_backend="pallas")
    got = nets.gridnet_apply(p, *map(_t, xs), union=union, conv_backend="torch")
    assert tuple(got.shape) == want.shape == (2, 32, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)
    # and the eager lattice to rounding (the same adds in the same order)
    torch.testing.assert_close(got, _eager_gridnet(p, *map(_t, xs), union), atol=1e-5, rtol=0)


def _frames(n, h, w, step=3):
    base = np.random.default_rng(0).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [_t(base[:, :, step * i:step * i + w]) for i in range(n)]


@pytest.mark.parametrize("model", ["gmfss", "gmfss_union"])
def test_chain_window_equals_the_eager_window(model, monkeypatch):
    """One T=3 window and its reuse, same seeded weights, f32: the models as
    they are against the same models with GridNet and FeatureNet spelled
    with eager layers (MetricNet's chain is held to its eager net in
    test_torch_conv_chain_gmfss.py): atol 1e-5 (the chain rounds where the
    eager convs and adds do; in practice bit-equal)."""
    from drba_tpu_torch.models.gmfss import GMFSS
    from drba_tpu_torch.models.gmfss_union import GMFSS_UNION

    cls, h, w = {"gmfss": (GMFSS, 128, 192), "gmfss_union": (GMFSS_UNION, 128, 256)}[model]
    m = cls(config=F32, device="cpu")
    fr = _frames(3, h, w)
    got, r_got = m.inference_ts_drba(*fr, [0.5, 1.0, 1.3], None, linear=True)
    monkeypatch.setattr(gmfss_core, "gridnet_apply", _eager_gridnet)
    monkeypatch.setattr(gmfss_core, "featurenet_apply", _eager_featurenet)
    want, r_want = m.inference_ts_drba(*fr, [0.5, 1.0, 1.3], None, linear=True)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, atol=1e-5, rtol=0)
    for g, v in zip(r_got[:4] + r_got.feat0 + r_got.feat1,
                    r_want[:4] + r_want.feat0 + r_want.feat1):
        torch.testing.assert_close(g, v, atol=1e-5, rtol=0)
