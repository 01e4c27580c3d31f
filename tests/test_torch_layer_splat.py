"""The Python side of the port's fused splat and transformer-layer kernels, on the CPU.

* The fused softsplat's plain counterpart (the f32 accumulator padded to
  ``acc_stride(C)`` channels, then the normalise step) against drba_tpu's
  exact scatter softsplat, every normalised mode and denominator, with
  coverage, at C = 2, 67 and 129 in f32 and bf16, with non-finite and
  out-of-frame flows; the accumulator's stride plan; the wrapper's two
  launches (mocked: the kernels run only on a CUDA device).
* The layer kernels' weight packing: the round trip, the element layout the
  kernels index, the FFN chunks; ``transformer_layer`` on the weights a
  packed model carries against drba_tpu's ``transformer_layer_mxu`` (its
  Pallas kernel in interpret mode, as tests/test_attn_layer.py runs it) fed
  the unpacked copies; ``GMFSS.__init__`` packing once; the kernel path
  raising without packed weights and passing the packed ones to its two
  launches (mocked).

Inputs come from numpy seeds. tests/test_torch_gpu.py holds the kernels
against these plain versions on the card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import drba_tpu.models.gmflow_net as jgm
from drba_tpu.models.layers import init_from_spec as jax_init
from drba_tpu.ops.attn_layer import transformer_layer_mxu
from drba_tpu.ops.softsplat import softsplat as jax_softsplat
from drba_tpu_torch import _build
from drba_tpu_torch.convert import from_jax_params
from drba_tpu_torch.models import gmflow_net as gm
from drba_tpu_torch.ops import attn_layer as al
from drba_tpu_torch.ops import splat_cuda

# the module (the package exports its function under the same name)
ss = importlib.import_module("drba_tpu_torch.ops.softsplat")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this file's small PyTorch CPU ops on one thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(a: np.ndarray, dtype: torch.dtype):
    """The same values as a torch tensor in ``dtype`` and a JAX array in its
    counterpart (bf16 values rounded once, on the torch side)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                    else jnp.float32)


# ------------------------------------------------------------------------------------ splat


@pytest.mark.parametrize("c", [1, 2, 3, 4, 67, 128, 129, 192])
def test_acc_stride_keeps_rows_aligned(c):
    s = splat_cuda.acc_stride(c)
    assert s % 4 == 0 and c + 1 <= s < c + 5  # the weight channel fits; 16-byte rows
    assert (s == 4) == (c + 1 <= 4)  # one group a pixel: the kernel's narrow form


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 67, 129])
@pytest.mark.parametrize("main", ["avg", "linear", "soft"])
def test_fused_softsplat_plain_matches_jax_scatter(main, c, dtype):
    """Each denominator rule with coverage. Large random flows put many
    targets out of frame, a NaN and an inf flow are dropped, and image 1's
    flow sends every pixel out of frame; linear metrics of 1e-9 give
    denominators near eps, where the three rules differ."""
    rng = np.random.default_rng(c)
    n, h, w = 2, 9, 13
    ten, jten = _pair(rng.standard_normal((n, h, w, c)).astype(np.float32), dtype)
    flow = (rng.standard_normal((n, h, w, 2)) * 4).astype(np.float32)
    flow[0, 2, 3, 0] = np.nan
    flow[0, 4, 5, 1] = np.inf
    flow[1] += 60.0
    tflow, jflow = _pair(flow, dtype)
    tm = jm = None
    if main != "avg":
        m = rng.uniform(0.1, 1.0, (n, h, w, 1)).astype(np.float32)
        if main == "linear":
            m[rng.uniform(size=m.shape) < 0.5] = 1e-9
        tm, jm = _pair(m, dtype)
    for sub in ("", "-addeps", "-zeroeps", "-clipeps"):
        mode = main + sub
        acc = ss._scatter_plain(ten, tflow, tm, ss.FACTOR[main])
        assert tuple(acc.shape) == (n, h, w, splat_cuda.acc_stride(c))
        assert not acc[..., c + 1:].any() and not acc[1].any()
        got = ss._normalise_plain(acc, c, ss.DENOM[sub[1:] or None], dtype, True)
        # softsplat's plain path is these two steps
        for g, t in zip(got, ss.softsplat(ten, tflow, tm, mode, backend="torch",
                                          return_coverage=True)):
            assert torch.equal(g, t)
        want = jax_softsplat(jten, jflow, jm, mode, backend="scatter", return_coverage=True)
        for g, wt in zip(got, want):
            assert g.dtype == dtype and tuple(g.shape) == wt.shape
            # f32: sums in another order, scaled up by denominators down to
            # ~1e-3 (relative); bf16: one output ulp (2^-8 relative) on top
            tol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-2, 8e-3)
            np.testing.assert_allclose(_np(g), np.asarray(wt, np.float32), atol=tol[0],
                                       rtol=tol[1], err_msg=mode)


def test_softsplat_cuda_path_runs_two_launches(monkeypatch):
    """The kernel path's arguments, mocked on the CPU: the scatter with the
    mode's factor and each input's dtype, then the normalise step with the
    denominator rule and the output dtype; the raw ``splat`` runs the
    scatter alone."""
    calls = []
    monkeypatch.setattr(ss, "use_kernel", lambda backend, t: True)
    monkeypatch.setattr(splat_cuda, "check_cuda_input", lambda *a, **k: None)
    monkeypatch.setattr(splat_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(splat_cuda.SPLAT, "launch",
                        lambda *a, device, entry: calls.append((entry, a)))
    ten = torch.zeros(2, 5, 7, 67)
    flow = torch.zeros(2, 5, 7, 2, dtype=torch.bfloat16)
    metric = torch.zeros(2, 5, 7, 1, dtype=torch.bfloat16)
    out, cov = ss.softsplat(ten, flow, metric, "soft-clipeps", return_coverage=True)
    assert tuple(out.shape) == (2, 5, 7, 67) and tuple(cov.shape) == (2, 5, 7, 1)
    (e0, a0), (e1, a1) = calls
    assert e0 == "drba_splat_scatter" and a0[4:12] == (2, 5, 7, 67, 2, 0, 1, 1)
    assert e1 == "drba_splat_normalise" and a1[3:7] == (70, 67, 3, 0)
    calls.clear()
    ss.softsplat(ten.to(torch.bfloat16), flow, None, "sum")
    assert calls[0][1][8] == 0 and calls[0][1][2] is None  # factor 1, no metric
    assert calls[1][1][2] is None and calls[1][1][5:7] == (0, 1)  # no coverage, bf16 out
    calls.clear()
    raw = ss.splat(ten, flow)  # the raw f32 sum: the scatter alone, the accumulator's values
    assert [e for e, _ in calls] == ["drba_splat_scatter"] and tuple(raw.shape) == (2, 5, 7, 67)


# ------------------------------------------------------------------------------ layer weights


@pytest.mark.parametrize("k,n", [(128, 384), (128, 128), (256, 64), (64, 128), (19, 192)])
def test_pack_slabs_round_trips_in_the_kernel_layout(k, n):
    g = torch.Generator().manual_seed(k + n)
    w = torch.randn(k, n, generator=g)
    p = al.pack_slabs(w)
    assert tuple(p.shape) == (n // 64, k, 64)
    assert torch.equal(al.unpack_slabs(p), w)
    flat = p.reshape(-1)
    for kk, nn in ((0, 0), (k - 1, n - 1), (k // 2, n // 3), (7, 9)):
        kk, nn = min(kk, k - 1), min(nn, n - 1)
        # csrc/attn_layer.cu: element (k, n) at ((n/64) K + k) 64 + (((n%64)/8) ^ (k%8)) 8 + n%8
        at = ((nn // 64) * k + kk) * 64 + (((nn % 64) // 8) ^ (kk % 8)) * 8 + nn % 8
        assert flat[at] == w[kk, nn]


def test_pack_ffn_chunks_hold_their_hidden_columns():
    g = torch.Generator().manual_seed(0)
    w0, w2 = torch.randn(256, 1024, generator=g), torch.randn(1024, 128, generator=g)
    p = al.pack_ffn(w0, w2)
    assert tuple(p.shape) == (16, 256 * 64 + 64 * 128)
    for j in (0, 7, 15):
        assert torch.equal(al.unpack_slabs(p[j, :256 * 64].reshape(1, 256, 64)),
                           w0[:, 64 * j:64 * j + 64])
        assert torch.equal(al.unpack_slabs(p[j, 256 * 64:].reshape(2, 64, 64)),
                           w2[64 * j:64 * j + 64])


def _gmflow_params(seed):
    """Seed ``seed``'s GMFlow parameters, each in its own (aligned) buffer."""
    jp = jax_init(jgm.GMFLOW_SPEC, seed=seed)
    return {k: v.clone() for k, v in
            from_jax_params({k: np.asarray(v) for k, v in jp.items()}, gm.GMFLOW_SPEC).items()}


@pytest.fixture(scope="module")
def packed_params():
    return gm.pack_transformer_weights(_gmflow_params(3))


@pytest.mark.parametrize("cross,masked", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_packed_layer_matches_jax_kernel(packed_params, cross, masked):
    """``transformer_layer`` on a packed model's weights against
    transformer_layer_mxu fed the packed copies unpacked: the packed
    tensors carry exactly the layer's weights. f32 attention outputs of
    unit-scale inputs: sums in another order."""
    rng = np.random.default_rng(5)
    b, h, w, ks = 4, 16, 24, 2
    x, tgt = (rng.normal(size=(b, h, w, 128)).astype(np.float32) * 0.5 for _ in range(2))
    base = f"transformer.layers.1.{'cross_attn_ffn' if cross else 'self_attn'}"
    wt = al.layer_weights(packed_params, base, cross)
    assert wt.qkv_p is packed_params[f"{base}.qkv.wp"]
    lab = gm.shift_region_labels(h, w, ks)
    got = al.transformer_layer(torch.from_numpy(x), wt, ks, lab, with_mask=masked,
                               cross_swap=cross, target=torch.from_numpy(tgt) if cross else None)
    jffn = None
    wqkv, wmerge, w0, w2 = al.unpack_layer_weights(wt)  # f32: the TF32 hi + lo fragments
    if cross:
        hidden = wt.ffn_p.shape[0] * al.TF32_H_CHUNK
        assert tuple(w0.shape) == (256, hidden) and tuple(w2.shape) == (hidden, 128)
        jffn = (jnp.asarray(_np(w0)), jnp.asarray(_np(w2)),
                *(jnp.asarray(_np(t)) for t in wt.ffn[2:]))
    want = transformer_layer_mxu(jnp.asarray(x), jnp.asarray(_np(wqkv)),
                                 jnp.asarray(_np(wmerge)),
                                 tuple(jnp.asarray(_np(t)) for t in wt.norm1), ks, labels=lab,
                                 with_mask=masked, cross_swap=cross,
                                 target=jnp.asarray(tgt) if cross else None, ffn=jffn)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-4, rtol=0)


def test_gmfss_packs_its_layer_weights_once(monkeypatch):
    """``GMFSS.__init__`` packs every layer's weights once, into the flownet
    parameters in their dtype, and ``layer_weights`` hands the model's own
    packed tensors to the layers (no packing per call)."""
    from drba_tpu_torch.config import F32
    from drba_tpu_torch.models import gmfss

    n = {"packs": 0}

    def counting(p):
        n["packs"] += 1
        return gm.pack_transformer_weights(p)

    monkeypatch.setattr(gmfss, "pack_transformer_weights", counting)
    m = gmfss.GMFSS(config=F32, device="cpu")
    assert n["packs"] == 1
    p = m.params.flownet
    assert sum(k.endswith(".wp") for k in p) == 12 + 12 + 6  # qkv, merge per layer; 6 FFNs
    for i in range(gm.NUM_LAYERS):
        for attn, cross in (("self_attn", False), ("cross_attn_ffn", True)):
            base = f"transformer.layers.{i}.{attn}"
            wt = al.layer_weights(p, base, cross)
            assert wt.qkv_p is p[f"{base}.qkv.wp"] and wt.merge_p.dtype == torch.float32
            assert (wt.ffn_p is p.get(f"{base}.mlp.wp")) and (wt.ffn_p is None) == (not cross)
            assert torch.equal(al.unpack_layer_weights(wt)[1], wt.wmerge)
    for packer in ("pack_slabs", "pack_frags"):
        monkeypatch.setattr(al, packer, lambda w: pytest.fail("packed during a pass"))
    f = torch.zeros(1, 8, 12, 128)
    gm.transformer_apply(p, f, f, 2)


def _mock_layer_kernels(monkeypatch):
    """Let CPU tensors through the kernel path; record the launches."""
    calls = []
    monkeypatch.setattr(al, "use_kernel", lambda backend, t: True)
    monkeypatch.setattr(al, "check_cuda_input", lambda *a, **k: None)
    monkeypatch.setattr(al, "stream_of", lambda t: 0)
    monkeypatch.setattr(al.LAYER, "launch", lambda *a, device, entry: calls.append((entry, a)))
    monkeypatch.setattr(al, "layer_window_attention",
                        lambda qkv, *a, **k: torch.zeros(qkv.shape[:-1] + (128,)))
    return calls


def test_layer_kernels_raise_without_packed_weights(monkeypatch, packed_params):
    """Mocked on the CPU: the kernel path refuses natural weights before any
    launch, and passes the packed ones to its two launches."""
    calls = _mock_layer_kernels(monkeypatch)
    natural = _gmflow_params(4)
    x = torch.zeros(2, 8, 12, 128)
    base = "transformer.layers.0.cross_attn_ffn"
    launches = _build.counts()
    with pytest.raises(ValueError, match="packed weights"):
        al.transformer_layer(x, al.layer_weights(natural, base, True), 2)
    half = {**natural, **{k: v for k, v in al.pack_layer_weights(natural, base, True).items()
                          if not k.endswith(".mlp.wp")}}
    with pytest.raises(ValueError, match="packed weights"):  # the FFN's chunks are missing
        al.transformer_layer(x, al.layer_weights(half, base, True), 2)
    assert not calls and _build.counts() == launches

    wt = al.layer_weights(packed_params, base, True)
    out = al.transformer_layer(x, wt, 2, cross_swap=True, target=x + 1)
    assert tuple(out.shape) == tuple(x.shape)
    (e0, a0), (e1, a1) = calls
    assert e0 == "drba_layer_proj" and a0[2] == wt.qkv_p.data_ptr() and a0[4:6] == (192, 0)
    assert a0[1] != a0[0]  # k and v from the target
    assert e1 == "drba_layer_tail" and a1[2] == wt.merge_p.data_ptr()
    assert a1[5] == wt.ffn_p.data_ptr() and a1[9:12] == (1024, 192, 0)
