"""The f32 (``--fp32``) conv chain sites of the GMFSS nets, on the CPU.

In f32 the stride-1 convs of GridNet's 192-channel L2 blocks and of
FeatureNet's levels 2-3 run as one-step chains with their pre-PReLU (the
f32 kernel, 3xTF32 on the tensor cores, on the card), where bf16 leaves
them on cuDNN. Here:

* with the kernel launch replaced by a counting stand-in that computes the
  plain step, f32 sends exactly the chain sites' convs to ``conv3x3_cuda``,
  each with weights split for the f32 kernel, and bf16 sends the same
  sites less L2 and FeatureNet's levels 2-3, each with the bf16 layout;
* f32 ``gridnet_apply`` and ``featurenet_apply`` on that path stay within
  1e-5 of drba_tpu's plain XLA nets at a small size.

Inputs come from numpy seeds.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import drba_tpu.models.gmfss_nets as jnets
from drba_tpu.models.layers import init_from_spec as jax_init
from drba_tpu_torch.convert import from_jax_params
from drba_tpu_torch.models import gmfss_nets as nets
from drba_tpu_torch.ops.conv_chain import ChainStep, _step_plain

conv_chain_mod = importlib.import_module("drba_tpu_torch.ops.conv_chain")

L2_CONVS = {"residual_model_head3.1", "residual_model_head3.3", "residual_model_21.1",
            "residual_model_21.3", "residual_model_24.1", "residual_model_24.3",
            "residual_model_25.1", "residual_model_25.3", "downsample_model_20.3",
            "downsample_model_21.3"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this file's small PyTorch CPU ops on one thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(spec, seed, dtype=torch.float32):
    jp = jax_init(spec, seed=seed)
    p = from_jax_params({k: np.asarray(v) for k, v in jp.items()}, spec)
    return jp, {k: v.to(dtype) for k, v in p.items()}


def _gridnet_inputs(seed, cin):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((1, 16, 32, cin), (1, 16, 32, 128), (1, 8, 16, 256), (1, 4, 8, 384))]


@pytest.fixture
def kernel_steps(monkeypatch):
    """``conv_chain`` on CPU tensors as on the card: the kernel branch taken,
    ``conv3x3_cuda`` replaced by the plain step; the list of (weight
    tensor, packed weights) of each call."""
    calls = []

    def stand_in(x, w, b, beta=None, wp=None, alpha=None, res=None, path=None):
        calls.append((w, wp))
        return _step_plain(x, ChainStep(w=w, b=b, beta=beta, pre_alpha=alpha), res)

    monkeypatch.setattr(conv_chain_mod, "use_kernel", lambda backend, t: True)
    monkeypatch.setattr(conv_chain_mod, "conv3x3_cuda", stand_in)
    return calls


def _names(p, calls):
    """The conv of each call, by its weight tensor's storage."""
    by_ptr = {v.data_ptr(): k[:-len(".weight")] for k, v in p.items() if k.endswith(".weight")}
    return [by_ptr[w.data_ptr()] for w, _ in calls]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("union", [False, True])
def test_gridnet_l2_reaches_the_kernel_in_f32_only(kernel_steps, dtype, union):
    """GridNet's chain sites on the kernel path: f32 adds L2's ten convs
    (the four stride-1 blocks' two, the stride-2 blocks' trailing one) to
    the L0/L1/tail sites; each call carries the packing of its dtype (split,
    five dims, for f32: a bf16 layout never reaches the f32 kernel)."""
    f32 = dtype == torch.float32
    spec = nets.GRIDNET_UNION_SPEC if union else nets.GRIDNET_SPEC
    _, p = _params(spec, 3, dtype)
    p = nets.pack_chain_weights(p, nets.gridnet_chain_convs(union, f32))
    xs = [_t(a).to(dtype) for a in _gridnet_inputs(8, 9 if union else 12)]
    nets.gridnet_apply(p, *xs, union=union)
    reached = _names(p, kernel_steps)
    assert len(reached) == (36 if f32 else 26)
    assert set(reached) == set(nets.gridnet_chain_convs(union, f32))
    assert (set(reached) & L2_CONVS) == (L2_CONVS if f32 else set())
    assert all(wp is not None and wp.dtype == dtype and wp.dim() == (5 if f32 else 4)
               for _, wp in kernel_steps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_featurenet_levels_2_3_reach_the_kernel_in_f32_only(kernel_steps, dtype):
    f32 = dtype == torch.float32
    _, p = _params(nets.FEATURENET_SPEC, 2, dtype)
    p = nets.pack_chain_weights(p, nets.featurenet_chain_convs(f32))
    x = _t(np.random.default_rng(13).uniform(0, 1, (1, 32, 64, 3)).astype(np.float32))
    outs = nets.featurenet_apply(p, x.to(dtype))
    assert [tuple(o.shape) for o in outs] == [(1, 16, 32, 64), (1, 8, 16, 128), (1, 4, 8, 192)]
    assert _names(p, kernel_steps) == (["block1.3", "block2.3", "block3.3"] if f32
                                       else ["block1.3"])
    assert all(wp.dim() == (5 if f32 else 4) for _, wp in kernel_steps)


@pytest.mark.parametrize("union", [False, True])
def test_f32_gridnet_with_l2_chains_matches_jax(kernel_steps, union):
    """The f32 lattice with every chain site on the kernel path (L2's
    included) against drba_tpu's plain XLA lattice: the same convs and sums
    (one sum's terms swapped where a chain carries the first: the same
    value), f32 sums in another order."""
    spec = nets.GRIDNET_UNION_SPEC if union else nets.GRIDNET_SPEC
    jp, p = _params(spec, 3)
    p = nets.pack_chain_weights(p, nets.gridnet_chain_convs(union, True))
    xs = _gridnet_inputs(8, 9 if union else 12)
    want = jnets.gridnet_apply(jp, *map(jnp.asarray, xs), union=union, conv_backend="xla")
    got = nets.gridnet_apply(p, *map(_t, xs), union=union)
    assert len(kernel_steps) == 36
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_f32_featurenet_with_level_2_3_chains_matches_jax(kernel_steps):
    jp, p = _params(nets.FEATURENET_SPEC, 2)
    p = nets.pack_chain_weights(p, nets.featurenet_chain_convs(True))
    x = np.random.default_rng(13).uniform(0, 1, (1, 32, 64, 3)).astype(np.float32)
    want = jnets.featurenet_apply(jp, jnp.asarray(x), conv_backend="xla")
    got = nets.featurenet_apply(p, _t(x))
    assert len(kernel_steps) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
