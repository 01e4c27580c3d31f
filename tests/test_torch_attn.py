"""The port's attention ops (drba_tpu_torch.ops.attention, ops.attn_layer) against
drba_tpu on the CPU.

Inputs come from numpy seeds and go through both packages in float32. JAX's
Pallas attention kernels run in interpret mode, as its own tests run them
(tests/test_attn_mxu.py, tests/test_attn_layer.py), and the port's plain
versions are also held against the einsum path of drba_tpu/models/gmflow_net.
Tolerances are of the order of JAX's own 2e-4 for these comparisons: f32
sums of 128-deep products and of up to a few thousand softmax terms, in
another order. The kernels themselves run only on a CUDA device
(tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import drba_tpu.models.gmflow_net as jgm
from drba_tpu.models.layers import init_from_spec as jax_init
from drba_tpu.ops.attn_layer import transformer_layer_mxu
from drba_tpu.ops.attn_mxu import flash_attention_mxu, window_attention_mxu, window_attention_nhwc
from drba_tpu_torch import _build
from drba_tpu_torch.convert import from_jax_params
from drba_tpu_torch.models import gmflow_net as gm
from drba_tpu_torch.ops import attention as attn
from drba_tpu_torch.ops.attn_layer import (layer_weights, pack_layer_weights,
                                           transformer_layer, unpack_layer_weights)

# f32 attention outputs of unit-scale inputs: sums in another order
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per machine; keep this file's
    small PyTorch CPU ops on one thread instead of oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jax_init(jgm.GMFLOW_SPEC, seed=3)
    return jp, from_jax_params({k: np.asarray(v) for k, v in jp.items()}, gm.GMFLOW_SPEC)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


# ------------------------------------------------------------------------------ window / flash


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax_kernel_and_einsum(masked):
    """(B, L, c) with L not a multiple of the JAX kernel's 512-row chunk;
    region ids against the -100 additive mask of the einsum path."""
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 3, 300, 128) for _ in range(3))
    rid = rng.integers(0, 4, (3, 300)).astype(np.int32)
    got = attn.window_attention(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(rid) if masked else None, masked)
    want = window_attention_mxu(*map(jnp.asarray, (q, k, v)),
                                jnp.asarray(rid) if masked else None, with_mask=masked)
    _close(got, want)
    s = np.einsum("blc,bmc->blm", q, k) / np.sqrt(128.0)
    if masked:
        s = s + np.where(rid[:, :, None] != rid[:, None, :], -100.0, 0.0)
    p = np.exp(s - s.max(-1, keepdims=True))
    _close(got, np.einsum("blm,bmc->blc", p / p.sum(-1, keepdims=True), v))


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_nhwc_matches_jax_kernel_and_einsum(masked):
    """The shifted layer's pattern: roll, NHWC windows with the shift labels,
    roll back, against gmflow_net._window_attention (einsum path)."""
    rng = np.random.default_rng(1)
    b, h, w, c, ks = 2, 16, 24, 128, 2
    q, k, v = (_rand(rng, b, h, w, c) for _ in range(3))
    lab = gm.shift_region_labels(h, w, ks)
    sh, sw = (h // ks) // 2, (w // ks) // 2
    roll = (lambda x: np.roll(x, (-sh, -sw), axis=(1, 2))) if masked else (lambda x: x)
    got = attn.window_attention_nhwc(*(torch.from_numpy(roll(x)) for x in (q, k, v)), ks, lab,
                                     masked)
    want = window_attention_nhwc(*(jnp.asarray(roll(x)) for x in (q, k, v)), ks,
                                 lab if masked else None, with_mask=masked)
    _close(got, want)
    if masked:
        got = torch.roll(got, (sh, sw), dims=(1, 2))
    _close(got, jgm._window_attention(*map(jnp.asarray, (q, k, v)), ks, h, w, masked))


@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_matches_jax_kernel(masked):
    """L spans two of the JAX kernel's 1024-key chunks; value width 2."""
    rng = np.random.default_rng(2)
    q, k = (_rand(rng, 2, 1100, 128, scale=0.3) for _ in range(2))
    v = rng.uniform(0, 60, (2, 1100, 2)).astype(np.float32)
    rid = rng.integers(0, 3, (2, 1100)).astype(np.int32)
    got = attn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(rid) if masked else None, masked,
                               out_dtype=torch.float32)
    want = flash_attention_mxu(*map(jnp.asarray, (q, k, v)), jnp.asarray(rid) if masked else None,
                               with_mask=masked, out_dtype=jnp.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1100, 2)
    # values up to 60 px: f32 sums of 1100 weights in another order
    _close(got, want, atol=1e-4)


def test_global_correlation_and_propagation_match_jax(params):
    """Both flash call sites of GMFlow against the einsum path (correlation
    transposed for the backward direction) and against the flash kernel."""
    jp, p = params
    rng = np.random.default_rng(3)
    f0, f1 = (_rand(rng, 1, 8, 12, 128) for _ in range(2))
    flow = _rand(rng, 2, 8, 12, 2, scale=3.0)
    got_corr = gm.global_correlation_flow(torch.from_numpy(f0), torch.from_numpy(f1), bidir=True)
    got_prop = gm.flow_prop_global(p, torch.from_numpy(np.concatenate([f0, f1])),
                                   torch.from_numpy(flow))
    for fused in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jgm, "_fused_attention_on", lambda fused=fused: fused)
            _close(got_corr, jgm.global_correlation_flow(jnp.asarray(f0), jnp.asarray(f1),
                                                          bidir=True))
            _close(got_prop, jgm.flow_prop_global(jp, jnp.asarray(np.concatenate([f0, f1])),
                                                  jnp.asarray(flow)))


# ------------------------------------------------------------------------------ transformer


@pytest.mark.parametrize("cross", [False, True])
def test_transformer_layer_matches_jax_kernel(params, cross):
    """A self layer (no FFN, unmasked) and a cross layer (FFN, shift mask,
    batch-half swap, separate target) against transformer_layer_mxu."""
    jp, p = params
    rng = np.random.default_rng(4)
    b, h, w, c, ks = 4, 16, 24, 128, 2
    x, tgt = (_rand(rng, b, h, w, c, scale=0.5) for _ in range(2))
    base = f"transformer.layers.1.{'cross_attn_ffn' if cross else 'self_attn'}"
    wt = layer_weights(p, base, cross)
    lab = gm.shift_region_labels(h, w, ks)
    got = transformer_layer(torch.from_numpy(x), wt, ks, lab, with_mask=cross, cross_swap=cross,
                            target=torch.from_numpy(tgt) if cross else None)
    jw = [jnp.asarray(np.concatenate([_np(wt.wq), _np(wt.wk), _np(wt.wv)], axis=1)),
          jnp.asarray(_np(wt.wmerge))]
    jn = tuple(jnp.asarray(_np(t)) for t in wt.norm1)
    jffn = None if wt.ffn is None else tuple(jnp.asarray(_np(t)) for t in wt.ffn)
    want = transformer_layer_mxu(jnp.asarray(x), *jw, jn, ks, labels=lab, with_mask=cross,
                                 cross_swap=cross, target=jnp.asarray(tgt) if cross else None,
                                 ffn=jffn)
    _close(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_transformer_apply_matches_jax(params, fused, monkeypatch):
    """The 6-block stack (roll per shifted block, cross target = the state
    before the block) against JAX's einsum stack and its fused-layer stack."""
    jp, p = params
    rng = np.random.default_rng(5)
    f0, f1 = (_rand(rng, 1, 16, 24, 128, scale=0.5) for _ in range(2))
    monkeypatch.setattr(jgm, "_fused_attention_on", lambda: fused)
    want = jgm.transformer_apply(jp, jnp.asarray(f0), jnp.asarray(f1), attn_splits=2)
    got = gm.transformer_apply(p, torch.from_numpy(f0), torch.from_numpy(f1), 2)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-3)  # twelve layers of outputs of size ~5


def test_layer_weights_concatenate_qkv(params):
    """The natural weights are the dict's own tensors (no copy per call);
    q|k|v is concatenated once, when the weights are packed."""
    _, p = params
    base = "transformer.layers.0.cross_attn_ffn"
    wt = layer_weights(p, base, True)
    assert wt.wk is p[f"{base}.k_proj.weight"] and wt.wmerge is p[f"{base}.merge.weight"]
    assert tuple(wt.ffn[0].shape) == (256, 1024) and tuple(wt.ffn[1].shape) == (1024, 128)
    assert wt.qkv_p is None and wt.merge_p is None and wt.ffn_p is None  # not packed yet
    packed = layer_weights({**p, **pack_layer_weights(p, base, True)}, base, True)
    assert tuple(packed.qkv_p.shape) == (3, 16, 16, 32, 4)  # f32: the 3xTF32 fragments
    torch.testing.assert_close(unpack_layer_weights(packed)[0][:, 128:256], wt.wk, rtol=0,
                               atol=0)
    assert layer_weights(p, "transformer.layers.0.self_attn", False).ffn is None


# ------------------------------------------------------------------------------------ guards


def test_attention_cuda_backend_on_cpu_tensor_raises(params):
    _, p = params
    launches = _build.counts()
    q = torch.zeros(1, 8, 128)
    v2 = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn.window_attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn.flash_attention(q, q, v2, backend="cuda")
    x = torch.zeros(2, 4, 4, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn.window_attention_nhwc(x, x, x, 2, backend="cuda")
    wt = layer_weights(p, "transformer.layers.0.self_attn", False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        transformer_layer(x, wt, 2, backend="cuda")
    with pytest.raises(ValueError, match="split"):
        attn.window_attention_nhwc(x, x, x, 3)
    with pytest.raises(ValueError, match="with_mask"):
        attn.window_attention(q, q, q, None, with_mask=True)
    from drba_tpu_torch.config import Config

    with pytest.raises(ValueError, match="valid"):
        Config(attn_backend="pallas")
    assert _build.counts() == launches
