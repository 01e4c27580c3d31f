"""One GMFlow TransformerLayer over swin windows (counterpart of
drba_tpu/ops/attn_layer.py).

    q/k/v projection -> window attention (shift mask) -> merge -> LayerNorm
    [-> concat-FFN -> LayerNorm] -> residual add

``transformer_layer`` takes the (B, H, W, 128) map already rolled for a
shifted layer (the projections and norms are per token, so rolling the input
equals the reference's rolling of q/k/v). Cross-attention attends to the
batch-half-swapped ``target`` (GMFlow's concat0/concat1 layout).

On a CUDA tensor it runs three hand-written launches: the q|k|v projection
and the token-wise tail (csrc/attn_layer.cu), with the window-attention
kernel (csrc/attention.cu) between them, reading k/v from the other batch
half in place. The two layer kernels read their weights packed once per
model (``pack_layer_weights``, stored in the model's parameters by
``models/gmflow_net.pack_transformer_weights`` in ``GMFSS.__init__``) and
raise without them: bf16 weights as wgmma's swizzled slabs
(``pack_slabs``), f32 weights split into TF32 hi and lo parts in the
fragment order of the 3xTF32 kernels (``pack_frags``). On a CPU tensor
(or ``backend='torch'``) it runs the plain version,
``gmflow_net._transformer_layer``'s ops in order, on the natural weights.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from drba_tpu_torch._build import LAYER, check_cuda_input, dtype_code, stream_of, use_kernel
from drba_tpu_torch.models.layers import gelu, layer_norm, linear
from drba_tpu_torch.ops.attention import (
    HEAD_DIM,
    device_labels,
    launch_window,
    window_attention_nhwc,
)
from drba_tpu_torch.ops.tf32 import pack_frags, split_tf32, unpack_frags  # noqa: F401

SLAB = 64      # columns of a packed slab
H_CHUNK = 64   # hidden columns of a packed bf16 FFN chunk
TF32_H_CHUNK = 16  # hidden columns of a packed f32 FFN chunk (csrc/attn_layer.cu kHT)


class LayerWeights(NamedTuple):
    """One TransformerLayer's parameters. Linear weights stored (in, out):
    wq, wk, wv, wmerge (C, C); norm1 (gamma, beta); ffn (w0 (2C, hidden),
    w2 (hidden, C), gamma2, beta2) for the cross layer's concat-FFN, or
    None. ``qkv_p``, ``merge_p``, ``ffn_p``: the copies packed for the
    kernels (``pack_layer_weights``), or None."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wmerge: torch.Tensor
    norm1: tuple
    ffn: tuple | None = None
    qkv_p: torch.Tensor | None = None
    merge_p: torch.Tensor | None = None
    ffn_p: torch.Tensor | None = None


def _swizzle_index(k: int, device) -> torch.Tensor:
    """(K, 8): the 8-element group that lands at position p of row k."""
    return torch.arange(8, device=device)[None, :] ^ (torch.arange(k, device=device)[:, None] % 8)


def pack_slabs(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) weight stored (in, out), N a multiple of 64 -> (N/64, K, 64):
    64-column slabs, the 8-element groups of row k XOR-permuted by k % 8
    (position p holds group p ^ (k % 8)). In bf16 this is wgmma's MN-major B
    operand with the 128-byte swizzle, byte for byte."""
    k, n = w.shape
    t = w.reshape(k, n // SLAB, 8, 8).permute(1, 0, 2, 3)
    idx = _swizzle_index(k, w.device)[None, :, :, None].expand(t.shape)
    return t.gather(2, idx).reshape(n // SLAB, k, SLAB).contiguous()


def unpack_slabs(p: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_slabs``: (N/64, K, 64) -> (K, N)."""
    s, k, _ = p.shape
    t = p.reshape(s, k, 8, 8)
    idx = _swizzle_index(k, p.device)[None, :, :, None].expand(t.shape)  # XOR is its own inverse
    return t.gather(2, idx).permute(1, 0, 2, 3).reshape(k, s * SLAB)


def pack_ffn(w0: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The concat-FFN's w0 (2C, hidden) and w2 (hidden, C) -> (hidden/64,
    2C*64 + 64*C): chunk j is [pack_slabs(w0[:, 64j:64j+64]) |
    pack_slabs(w2[64j:64j+64])], the weights one hidden chunk needs, in the
    order the tail kernel streams them."""
    hidden = w0.shape[1]
    return torch.stack([torch.cat([pack_slabs(w0[:, j:j + H_CHUNK]).reshape(-1),
                                   pack_slabs(w2[j:j + H_CHUNK]).reshape(-1)])
                        for j in range(0, hidden, H_CHUNK)])


def pack_ffn_frags(w0: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The f32 concat-FFN -> (hidden/16, 2C*16*2 + 16*C*2): chunk j is
    [pack_frags(w0[:, 16j:16j+16]) | pack_frags(w2[16j:16j+16])], flat, in
    the order the f32 tail kernel streams them."""
    return torch.stack([torch.cat([pack_frags(w0[:, j:j + TF32_H_CHUNK]).reshape(-1),
                                   pack_frags(w2[j:j + TF32_H_CHUNK]).reshape(-1)])
                        for j in range(0, w0.shape[1], TF32_H_CHUNK)])


def _ffn_chunk(dtype: torch.dtype) -> int:
    return TF32_H_CHUNK if dtype == torch.float32 else H_CHUNK


def pack_layer_weights(p: Mapping[str, torch.Tensor], base: str, cross: bool) -> dict:
    """The packed weights of TransformerLayer ``base`` for the kernels:
    ``{base}.qkv.wp`` ([Wq | Wk | Wv], packed once here), ``{base}.merge.wp``
    and, for a cross layer, ``{base}.mlp.wp``; in the parameters' dtype and
    device. bf16: ``pack_slabs`` of the (C, 3C) q|k|v and ``pack_ffn``;
    f32: ``pack_frags`` of each of Wq, Wk, Wv (stacked) and
    ``pack_ffn_frags``."""
    wq, wk, wv = (p[f"{base}.{n}.weight"] for n in ("q_proj", "k_proj", "v_proj"))
    if wq.dtype == torch.float32:
        out = {f"{base}.qkv.wp": torch.stack([pack_frags(w) for w in (wq, wk, wv)]),
               f"{base}.merge.wp": pack_frags(p[f"{base}.merge.weight"])}
        ffn = pack_ffn_frags
    else:
        out = {f"{base}.qkv.wp": pack_slabs(torch.cat([wq, wk, wv], dim=1)),
               f"{base}.merge.wp": pack_slabs(p[f"{base}.merge.weight"])}
        ffn = pack_ffn
    if cross:
        out[f"{base}.mlp.wp"] = ffn(p[f"{base}.mlp.0.weight"], p[f"{base}.mlp.2.weight"])
    return out


def unpack_layer_weights(wt: "LayerWeights") -> tuple:
    """The natural weights the packed copies of ``wt`` hold: ((C, 3C)
    q|k|v, (C, C) merge, (2C, hidden) w0 or None, (hidden, C) w2 or None),
    for either packing."""
    c = HEAD_DIM
    if wt.merge_p.dtype == torch.float32:  # split fragments: w = hi + lo
        chunk = TF32_H_CHUNK
        un = lambda t: torch.add(*unpack_frags(t))
        w0_of = lambda ch: un(ch[:4 * c * chunk].reshape(2 * c // 8, chunk // 8, 32, 4))
        w2_of = lambda ch: un(ch[4 * c * chunk:].reshape(chunk // 8, c // 8, 32, 4))
        qkv = torch.cat([un(t) for t in wt.qkv_p], dim=1)
    else:
        chunk, un = H_CHUNK, unpack_slabs
        w0_of = lambda ch: un(ch[:2 * c * chunk].reshape(chunk // SLAB, 2 * c, SLAB))
        w2_of = lambda ch: un(ch[2 * c * chunk:].reshape(c // SLAB, chunk, SLAB))
        qkv = un(wt.qkv_p)
    w0 = w2 = None
    if wt.ffn_p is not None:
        w0 = torch.cat([w0_of(ch) for ch in wt.ffn_p], dim=1)
        w2 = torch.cat([w2_of(ch) for ch in wt.ffn_p], dim=0)
    return qkv, un(wt.merge_p), w0, w2


def layer_weights(p: Mapping[str, torch.Tensor], base: str, cross: bool) -> LayerWeights:
    """The LayerWeights of TransformerLayer ``base`` in a GMFlow param dict
    (linear weights stored (in, out)), with the packed copies where the dict
    holds them (``pack_layer_weights``)."""
    ffn = None
    if cross:
        ffn = (p[f"{base}.mlp.0.weight"], p[f"{base}.mlp.2.weight"],
               p[f"{base}.norm2.weight"], p[f"{base}.norm2.bias"])
    return LayerWeights(p[f"{base}.q_proj.weight"], p[f"{base}.k_proj.weight"],
                        p[f"{base}.v_proj.weight"], p[f"{base}.merge.weight"],
                        (p[f"{base}.norm1.weight"], p[f"{base}.norm1.bias"]), ffn,
                        p.get(f"{base}.qkv.wp"), p.get(f"{base}.merge.wp"),
                        p.get(f"{base}.mlp.wp") if cross else None)


def _layer_plain(x, wt: LayerWeights, k_splits, labels, with_mask, cross_swap, target):
    tgt = x if target is None else target
    if cross_swap:
        half = tgt.shape[0] // 2
        tgt = torch.cat([tgt[half:], tgt[:half]], dim=0)
    p = {"q.weight": wt.wq, "k.weight": wt.wk, "v.weight": wt.wv, "merge.weight": wt.wmerge,
         "norm1.weight": wt.norm1[0], "norm1.bias": wt.norm1[1]}
    msg = window_attention_nhwc(linear(p, "q", x), linear(p, "k", tgt), linear(p, "v", tgt),
                                k_splits, labels, with_mask, backend="torch")
    msg = layer_norm(p, "norm1", linear(p, "merge", msg))
    if wt.ffn is not None:
        p.update({"mlp.0.weight": wt.ffn[0], "mlp.2.weight": wt.ffn[1],
                  "norm2.weight": wt.ffn[2], "norm2.bias": wt.ffn[3]})
        msg = linear(p, "mlp.0", torch.cat([x, msg], dim=-1))
        msg = layer_norm(p, "norm2", linear(p, "mlp.2", gelu(msg)))
    return x + msg


def _weight(name: str, t: torch.Tensor, like: torch.Tensor, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous, 32-byte aligned ``shape`` tensor
    in ``like``'s dtype, on its device."""
    check_cuda_input(name, t, dtypes=(like.dtype,))
    if tuple(t.shape) != shape or t.device != like.device or t.data_ptr() % 32:
        raise ValueError(f"{name}: expected {shape} on {like.device}, 32-byte aligned; got "
                         f"{tuple(t.shape)} on {t.device}")


def layer_window_attention(qkv: torch.Tensor, k_splits: int, labels=None,
                           with_mask: bool = False, cross_swap: bool = False) -> torch.Tensor:
    """The layer's middle launch: window attention straight off the
    (B, H, W, 3C) q|k|v projection (tokens 3C apart), keys and values from
    the other batch half with ``cross_swap``. CUDA tensors only; returns
    (B, H, W, C)."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    wh, ww = h // k_splits, w // k_splits
    lab = None
    if with_mask:
        lab = device_labels(np.asarray(labels, np.int32).reshape(k_splits ** 2, wh * ww),
                            qkv.device)
    av = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    launch_window(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], av, b, h, w, k_splits,
                  (3 * c, 3 * c, 3 * c, c), lab, (wh * ww, 0), b // 2 if cross_swap else 0)
    return av


def layer_proj_cuda(x: torch.Tensor, tgt: torch.Tensor, qkv_p: torch.Tensor) -> torch.Tensor:
    """The layer's first launch: (B, H, W, 3C) = [x Wq | tgt Wk | tgt Wv]
    from the packed q|k|v weight (``tgt`` may be ``x`` itself)."""
    qkv = torch.empty(x.shape[:-1] + (3 * x.shape[-1],), dtype=x.dtype, device=x.device)
    LAYER.launch(x.data_ptr(), tgt.data_ptr(), qkv_p.data_ptr(), qkv.data_ptr(),
                 x.numel() // x.shape[-1], dtype_code(x), stream_of(x), device=x.device,
                 entry="drba_layer_proj")
    return qkv


def layer_tail_cuda(x: torch.Tensor, av: torch.Tensor, wt: LayerWeights) -> torch.Tensor:
    """The layer's last launch: x + [FFN of] LayerNorm(merge(av)), from the
    packed merge and FFN weights."""
    out = torch.empty_like(x)
    g2 = b2 = None
    hidden = 0
    if wt.ffn is not None:
        g2, b2 = wt.ffn[2], wt.ffn[3]
        hidden = wt.ffn_p.shape[0] * _ffn_chunk(x.dtype)
    ptr = (lambda t: None if t is None else t.data_ptr())
    LAYER.launch(x.data_ptr(), av.data_ptr(), wt.merge_p.data_ptr(), wt.norm1[0].data_ptr(),
                 wt.norm1[1].data_ptr(), ptr(wt.ffn_p), ptr(g2), ptr(b2), out.data_ptr(), hidden,
                 x.numel() // x.shape[-1], dtype_code(x), stream_of(x), device=x.device,
                 entry="drba_layer_tail")
    return out


def _layer_cuda(x, wt: LayerWeights, k_splits, labels, with_mask, cross_swap, target):
    if wt.qkv_p is None or wt.merge_p is None or (wt.ffn is not None and wt.ffn_p is None):
        raise ValueError("the layer kernels read packed weights: add pack_layer_weights(p, base, "
                         "cross) to the parameters once (GMFSS.__init__ does, through "
                         "gmflow_net.pack_transformer_weights)")
    check_cuda_input("x", x, ndim=4)
    b, h, w, c = x.shape
    if c != HEAD_DIM or h % k_splits or w % k_splits:
        raise ValueError(f"the layer kernels take c={HEAD_DIM} and H, W divisible by "
                         f"k_splits; got {tuple(x.shape)}, k_splits={k_splits}")
    tgt = x if target is None else target
    check_cuda_input("target", tgt, dtypes=(x.dtype,), ndim=4)
    if tgt.shape != x.shape or x.data_ptr() % 32 or tgt.data_ptr() % 32:
        raise ValueError("target must match x; both 32-byte aligned")
    if cross_swap and b % 2:
        raise ValueError(f"cross_swap needs an even batch, got {b}")
    f32 = x.dtype == torch.float32
    frags = (c // 8, c // 8, 32, 4)
    _weight("qkv_p", wt.qkv_p, x, (3, *frags) if f32 else (3 * c // SLAB, c, SLAB))
    _weight("merge_p", wt.merge_p, x, frags if f32 else (c // SLAB, c, SLAB))
    for name, t in zip(("gamma1", "beta1"), wt.norm1):
        _weight(name, t, x, (c,))
    if wt.ffn is not None:
        chunk = _ffn_chunk(x.dtype)
        hidden = wt.ffn_p.shape[0] * chunk
        if hidden % HEAD_DIM:
            raise ValueError(f"the tail kernel takes a hidden width divisible by {HEAD_DIM}, "
                             f"got {hidden}")
        _weight("ffn_p", wt.ffn_p, x,
                (hidden // chunk, (2 * c * chunk + chunk * c) * (2 if f32 else 1)))
        for name, t in zip(("gamma2", "beta2"), wt.ffn[2:]):
            _weight(name, t, x, (c,))

    qkv = layer_proj_cuda(x, tgt, wt.qkv_p)
    av = layer_window_attention(qkv, k_splits, labels, with_mask, cross_swap)
    return layer_tail_cuda(x, av, wt)


def transformer_layer(x: torch.Tensor, wt: LayerWeights, k_splits: int, labels=None,
                      with_mask: bool = False, cross_swap: bool = False,
                      target: torch.Tensor | None = None, backend: str = "auto") -> torch.Tensor:
    """One TransformerLayer over the swin windows of ``x`` (B, H, W, C).

    ``wt``: the layer's weights (``layer_weights``). ``target``: the map k/v
    are projected from (default ``x``); ``cross_swap`` reads it batch-half
    swapped. ``labels``: numpy (k^2, H/k, W/k) region ids of a shifted
    layer, used when ``with_mask``. Returns (B, H, W, C).
    """
    if with_mask and labels is None:
        raise ValueError("with_mask needs labels")
    if use_kernel(backend, x):
        return _layer_cuda(x.contiguous(), wt, k_splits, labels, with_mask, cross_swap,
                           None if target is None else target.contiguous())
    return _layer_plain(x, wt, k_splits, labels, with_mask, cross_swap, target)
