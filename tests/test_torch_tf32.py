"""The f32 (``--fp32``) side of the port's tensor-core kernels that the CPU reaches.

* ``split_tf32``, the split of the 3xTF32 products (csrc/tf32.cuh): hi has
  its low 13 mantissa bits zero, hi + lo == x exactly, |lo| <= 2^-11 |x|.
* The f32 layer weights packed in the kernels' fragment order
  (``pack_frags``, ``pack_ffn_frags``, ``pack_layer_weights``): unpacking
  returns the weights, hi + lo == w, each element where the kernel reads it.
* A plain-PyTorch emulation of the kernels' product at the layer's depths
  (K = 128, 256, 1024) against float64: 3xTF32 stays within the f32
  tolerances that chip_smoke.py holds the kernels to (attention 2e-5, the
  layer 1e-4 + 1e-4 |ref|); one TF32 product does not.
* The f32 conv weights split in the conv kernel's fragment order
  (``pack_weights_tf32``): hi + lo == w, each element where the kernel
  reads it, Cin and Cout padded to 8 with zeros; ``pack_step_weights`` by
  dtype.
* The conv kernel's 3xTF32 products (``conv3x3_tf32_plain``) at the conv
  depths K = 9 Cin of the f32 chain steps (Cin 9 to 384) against float64:
  within chip_smoke.py's f32 conv tolerance (1e-4); one TF32 product not.
* ``cli.main --fp32`` leaves cuDNN and matmuls in full f32 (both TF32 flags
  False), on a tiny cv2 clip on the CPU.

Inputs come from numpy seeds.
"""

import importlib
import os

import numpy as np
import pytest
import torch

from drba_tpu_torch.ops import attn_layer as al

ATTN_TOL = 2e-5          # chip_smoke.py attention_checks: f32 window attention
LAYER_TOL = (1e-4, 1e-4)  # chip_smoke.py attention_checks: f32 transformer layer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this file's small PyTorch CPU ops on one thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(seed, *shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=shape) * scale)
                            .astype(np.float32))


# ------------------------------------------------------------------------------------ the split


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e5, 1e30])
def test_split_tf32_is_exact_and_hi_is_tf32(scale):
    x = _randn(scale.as_integer_ratio()[0] % 1000, 4096, scale=scale)
    x[:4] = torch.tensor([0.0, -0.0, 1.0 + 2 ** -11, -(1.0 + 3 * 2 ** -12)])
    hi, lo = al.split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0  # 10 mantissa bits left
    assert torch.equal(hi + lo, x)
    assert bool((lo.abs() <= x.abs() * 2 ** -11).all())
    # to nearest, ties away from zero (cvt.rna): 1 + 2^-11 lies halfway
    assert hi[2] == 1.0 + 2 ** -10 and hi[3] == -(1.0 + 2 ** -10)


def test_split_tf32_rounds_to_nearest():
    x = _randn(1, 10000)
    hi, _ = al.split_tf32(x)
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 11)  # 2^-10 of the binade
    assert bool(((x - hi).abs() <= ulp / 2).all())


# ---------------------------------------------------------------------------------- the packing


@pytest.mark.parametrize("k,n", [(128, 128), (256, 16), (16, 128), (24, 40)])
def test_pack_frags_round_trips_in_the_fragment_layout(k, n):
    w = _randn(k + n, k, n, scale=0.1)
    p = al.pack_frags(w)
    assert tuple(p.shape) == (k // 8, n // 8, 32, 4) and p.is_contiguous()
    hi, lo = al.unpack_frags(p)
    assert torch.equal(hi + lo, w) and torch.equal(hi, al.split_tf32(w)[0])
    # csrc/tf32.cuh: lane 4 g + t of (kk, nt) holds rows 8 kk + 2 t, + 1 of column 8 nt + g
    for kk, nt, lane in ((0, 0, 0), (k // 8 - 1, n // 8 - 1, 31), (k // 16, n // 16, 13)):
        g, t = lane // 4, lane % 4
        r, c = 8 * kk + 2 * t, 8 * nt + g
        assert p[kk, nt, lane, 0] == hi[r, c] and p[kk, nt, lane, 1] == hi[r + 1, c]
        assert p[kk, nt, lane, 2] == lo[r, c] and p[kk, nt, lane, 3] == lo[r + 1, c]


def test_pack_ffn_frags_chunks_hold_their_hidden_columns():
    w0, w2 = _randn(2, 256, 1024, scale=0.05), _randn(3, 1024, 128, scale=0.05)
    p = al.pack_ffn_frags(w0, w2)
    assert tuple(p.shape) == (64, (256 * 16 + 16 * 128) * 2)  # 48 KB chunks
    for j in (0, 21, 63):
        c0 = p[j, :256 * 16 * 2].reshape(32, 2, 32, 4)
        c2 = p[j, 256 * 16 * 2:].reshape(2, 16, 32, 4)
        assert torch.equal(sum(al.unpack_frags(c0)), w0[:, 16 * j:16 * j + 16])
        assert torch.equal(sum(al.unpack_frags(c2)), w2[16 * j:16 * j + 16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cross", [False, True])
def test_pack_layer_weights_by_dtype_unpacks_to_the_weights(dtype, cross):
    """f32 layers get the split fragments, bf16 the wgmma slabs; either
    unpacks to the layer's weights exactly."""
    base = "layer"
    names = ["q_proj", "k_proj", "v_proj", "merge"]
    p = {f"{base}.{nm}.weight": _randn(i, 128, 128, scale=0.1).to(dtype)
         for i, nm in enumerate(names)}
    p.update({f"{base}.norm1.weight": torch.ones(128, dtype=dtype),
              f"{base}.norm1.bias": torch.zeros(128, dtype=dtype)})
    if cross:
        p.update({f"{base}.mlp.0.weight": _randn(8, 256, 1024, scale=0.05).to(dtype),
                  f"{base}.mlp.2.weight": _randn(9, 1024, 128, scale=0.05).to(dtype),
                  f"{base}.norm2.weight": torch.ones(128, dtype=dtype),
                  f"{base}.norm2.bias": torch.zeros(128, dtype=dtype)})
    wt = al.layer_weights({**p, **al.pack_layer_weights(p, base, cross)}, base, cross)
    f32 = dtype == torch.float32
    assert tuple(wt.qkv_p.shape) == ((3, 16, 16, 32, 4) if f32 else (6, 128, 64))
    assert wt.qkv_p.dtype == dtype
    qkv, merge, w0, w2 = al.unpack_layer_weights(wt)
    assert torch.equal(qkv, torch.cat([wt.wq, wt.wk, wt.wv], dim=1))
    assert torch.equal(merge, wt.wmerge)
    if cross:
        assert wt.ffn_p.shape[0] == 1024 // (al.TF32_H_CHUNK if f32 else al.H_CHUNK)
        assert torch.equal(w0, wt.ffn[0]) and torch.equal(w2, wt.ffn[1])
    else:
        assert w0 is None and wt.ffn_p is None


@pytest.mark.parametrize("cin,cout", [(9, 64), (14, 2), (64, 64), (192, 192), (384, 192)])
def test_pack_weights_tf32_round_trips_in_the_conv_fragment_layout(cin, cout):
    cc = importlib.import_module("drba_tpu_torch.ops.conv_chain")

    w = _randn(cin * cout, cout, cin, 3, 3, scale=0.1)
    p = cc.pack_weights_tf32(w)
    assert tuple(p.shape) == (-(-cin // 8), 9, -(-cout // 8), 32, 4) and p.is_contiguous()
    assert torch.equal(cc.unpack_weights(p, cin, cout), w)
    hi, lo = al.split_tf32(w)
    # csrc/conv_chain.cu: lane 4 g + t of (chunk c, tap, n8 tile nt) holds
    # input channels 8 c + 2 t, + 1 of output channel 8 nt + g
    for c, tap, nt, lane in ((0, 0, 0, 0), (p.shape[0] - 1, 8, p.shape[2] - 1, 31),
                             (p.shape[0] // 2, 4, p.shape[2] // 2, 13)):
        g, t = lane // 4, lane % 4
        o, i, ky, kx = 8 * nt + g, 8 * c + 2 * t, tap // 3, tap % 3
        for e, src in ((0, hi), (2, lo)):
            for d in (0, 1):
                want = src[o, i + d, ky, kx] if o < cout and i + d < cin else 0.0
                assert p[c, tap, nt, lane, e + d] == want


def test_pack_step_weights_takes_the_layout_of_the_dtype():
    cc = importlib.import_module("drba_tpu_torch.ops.conv_chain")

    w = _randn(0, 64, 32, 3, 3, scale=0.1)
    assert cc.pack_step_weights(w).dim() == 5
    wb = cc.pack_step_weights(w.to(torch.bfloat16))
    assert wb.dtype == torch.bfloat16 and torch.equal(wb, cc.pack_weights(w.to(torch.bfloat16)))
    assert torch.equal(cc.chain_step(w, torch.zeros(64)).wp, cc.pack_weights_tf32(w))


# --------------------------------------------------------------------- the product's accuracy


CONV_TOL = 1e-4  # chip_smoke.py: f32 conv steps against their plain version (max abs)


@pytest.mark.parametrize("cin", [9, 14, 64, 128, 192, 256, 384])
def test_three_tf32_conv_keeps_the_f32_conv_tolerance_and_one_does_not(cin):
    """A 3x3 step at K = 9 Cin as the f32 conv kernel computes it, inputs in
    [-1, 1) and weights within 1 / sqrt(9 Cin) as chip_smoke.py draws them,
    against float64: 3xTF32 within the f32 conv tolerance with room to
    spare; one TF32 product (x and w rounded to TF32) beyond it."""
    import torch.nn.functional as F

    cc = importlib.import_module("drba_tpu_torch.ops.conv_chain")

    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 12, 20, cin)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (64, cin, 3, 3)) / (9 * cin) ** 0.5)
                         .astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.05, 0.05, 64).astype(np.float32))
    want = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), b.double(),
                    padding=1).permute(0, 2, 3, 1)
    wp = cc.pack_weights_tf32(w)
    err3 = float((cc.conv3x3_tf32_plain(x, wp, b).double() - want).abs().max())
    one = wp.clone()
    one[..., 2:] = 0  # no lo terms: x_hi w_hi alone
    err1 = float((cc.conv3x3_tf32_plain(al.split_tf32(x)[0], one, b).double() - want)
                 .abs().max())
    assert err3 <= CONV_TOL / 20, err3
    assert err1 > CONV_TOL, err1


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What a tensor core reads of an f32 word as TF32, taken at its worst:
    the low 13 mantissa bits dropped (truncation)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mma_emulated(a: torch.Tensor, b: torch.Tensor, terms) -> torch.Tensor:
    """(M, K) x (K, N) as the kernels run it: k-steps of 8, each step's
    products summed exactly (float64; TF32 x TF32 is exact there) and added
    to an f32 accumulator, one rounding per step and term. ``terms``: pairs
    of (A part, B part) per step, in the order they are issued."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        for ta, tb in terms:
            step = ta[:, k0:k0 + 8].double() @ tb[k0:k0 + 8].double()
            acc = (acc.double() + step).float()
    return acc


def _three_tf32(a, b):
    ah, al_ = al.split_tf32(a)
    bh, bl = al.split_tf32(b)
    # csrc/tf32.cuh mma_3xtf32: al bh, ah bl, then ah bh; lo read as TF32
    return _mma_emulated(a, b, [(_tf32_read(al_), bh), (ah, _tf32_read(bl)), (ah, bh)])


def _one_tf32(a, b):
    return _mma_emulated(a, b, [(al.split_tf32(a)[0], al.split_tf32(b)[0])])


@pytest.mark.parametrize("k", [128, 256, 1024])
def test_three_tf32_products_keep_f32_tolerances_and_one_does_not(k):
    """The layer's depths: the projection and merge (128), the FFN's first
    product (256) and its second (1024). Unit-variance activations against
    weights of variance 1/K (outputs of size ~1, as the layer's are before
    its LayerNorms)."""
    a = _randn(k, 64, k)
    b = _randn(k + 1, k, 64, scale=k ** -0.5)
    want = a.double() @ b.double()
    err3 = (_three_tf32(a, b).double() - want).abs()
    err1 = (_one_tf32(a, b).double() - want).abs()
    atol, rtol = LAYER_TOL
    assert bool((err3 <= atol + rtol * want.abs()).all()), float(err3.max())
    assert float(err3.max()) <= ATTN_TOL
    assert not bool((err1 <= atol + rtol * want.abs()).all()), float(err1.max())
    assert float(err1.max()) > 10 * float(err3.max())


def test_three_tf32_scores_keep_the_attention_tolerance():
    """q k^T / sqrt(128) over 128 channels, then the softmax-weighted sum of
    values (P V over 512 keys): the attention kernel's two products in
    3xTF32 stay within chip_smoke's f32 attention tolerance of 2e-5; one
    TF32 product does not."""
    q, k, v = _randn(11, 64, 128), _randn(12, 512, 128), _randn(13, 512, 128)
    want = torch.softmax((q.double() @ k.double().T) / 128 ** 0.5, -1) @ v.double()
    out = {}
    for name, mm in (("3xTF32", _three_tf32), ("1xTF32", _one_tf32)):
        p = torch.softmax(mm(q, k.T.contiguous()) / 128 ** 0.5, -1)
        out[name] = float((mm(p, v).double() - want).abs().max())
    assert out["3xTF32"] <= ATTN_TOL < out["1xTF32"], out


# ------------------------------------------------------------------------------------- the CLI


def test_cli_fp32_turns_tf32_off(tmp_path, monkeypatch):
    """``cli.main --fp32`` sets cuDNN's and matmul's TF32 flags False before
    it builds a model (``config.full_f32_products``): a float32 convolution
    would otherwise run in TF32 on the card."""
    cv2 = pytest.importorskip("cv2")
    from drba_tpu_torch import cli

    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    vw = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 12, (64, 32))
    base = cv2.GaussianBlur(np.random.default_rng(0).uniform(0, 255, (32, 64, 3))
                            .astype(np.uint8), (5, 5), 2)
    for i in range(3):
        vw.write(np.roll(base, 2 * i, axis=1))
    vw.release()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = {}
    load_model = cli.load_model

    def recording(*a, **k):  # the flags as the model is built
        seen["flags"] = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        return load_model(*a, **k)

    monkeypatch.setattr(cli, "load_model", recording)
    cli.main(["-m", "rife", "-i", src, "-o", dst, "-t", "2", "--fp32", "--device", "cpu",
              "--weights", os.path.join(str(tmp_path), "none")])
    assert seen["flags"] == (False, False)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert os.path.exists(dst)
