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
half in place. On a CPU tensor (or ``backend='torch'``) it runs the plain
version, ``gmflow_net._transformer_layer``'s ops in order.
"""

from __future__ import annotations

from typing import Mapping

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


def _layer_plain(x, wqkv, wmerge, norm1, k_splits, labels, with_mask, cross_swap, target, ffn):
    c = x.shape[-1]
    tgt = x if target is None else target
    if cross_swap:
        half = tgt.shape[0] // 2
        tgt = torch.cat([tgt[half:], tgt[:half]], dim=0)
    p = {"q.weight": wqkv[:, :c], "kv.weight": wqkv[:, c:], "merge.weight": wmerge,
         "norm1.weight": norm1[0], "norm1.bias": norm1[1]}
    q = linear(p, "q", x)
    kv = linear(p, "kv", tgt)
    msg = window_attention_nhwc(q, kv[..., :c], kv[..., c:], k_splits, labels, with_mask,
                                backend="torch")
    msg = layer_norm(p, "norm1", linear(p, "merge", msg))
    if ffn is not None:
        p.update({"mlp.0.weight": ffn[0], "mlp.2.weight": ffn[1], "norm2.weight": ffn[2],
                  "norm2.bias": ffn[3]})
        msg = linear(p, "mlp.0", torch.cat([x, msg], dim=-1))
        msg = layer_norm(p, "norm2", linear(p, "mlp.2", gelu(msg)))
    return x + msg


def _weight(name: str, t: torch.Tensor, like: torch.Tensor, dtype=None) -> torch.Tensor:
    t = t.to(device=like.device, dtype=dtype or like.dtype).contiguous()
    if t.data_ptr() % 32:
        raise ValueError(f"{name}: the layer kernels need 32-byte aligned weights")
    return t


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


def _layer_cuda(x, wqkv, wmerge, norm1, k_splits, labels, with_mask, cross_swap, target, ffn):
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
    m = b * h * w
    wqkv = _weight("wqkv", wqkv, x)
    wmerge = _weight("wmerge", wmerge, x)
    g1, b1 = (_weight("norm1", t, x, torch.float32) for t in norm1)
    if tuple(wqkv.shape) != (c, 3 * c) or tuple(wmerge.shape) != (c, c):
        raise ValueError(f"wqkv {tuple(wqkv.shape)} / wmerge {tuple(wmerge.shape)}")
    stream = stream_of(x)

    qkv = torch.empty((b, h, w, 3 * c), dtype=x.dtype, device=x.device)
    LAYER.launch(x.data_ptr(), tgt.data_ptr(), wqkv.data_ptr(), qkv.data_ptr(), m,
                 dtype_code(x), stream, entry="drba_layer_proj")

    av = layer_window_attention(qkv, k_splits, labels, with_mask, cross_swap)

    w0 = w2 = g2 = b2 = None
    hidden = 0
    if ffn is not None:
        w0, w2 = _weight("w0", ffn[0], x), _weight("w2", ffn[1], x)
        g2, b2 = (_weight("norm2", t, x, torch.float32) for t in ffn[2:])
        hidden = w0.shape[1]
        if tuple(w0.shape) != (2 * c, hidden) or tuple(w2.shape) != (hidden, c) \
                or hidden % HEAD_DIM:
            raise ValueError(f"ffn weights {tuple(w0.shape)} / {tuple(w2.shape)}")
    out = torch.empty_like(x)
    ptr = (lambda t: None if t is None else t.data_ptr())
    LAYER.launch(x.data_ptr(), av.data_ptr(), wmerge.data_ptr(), g1.data_ptr(), b1.data_ptr(),
                 ptr(w0), ptr(w2), ptr(g2), ptr(b2), out.data_ptr(), hidden, m, dtype_code(x),
                 stream, entry="drba_layer_tail")
    return out


def transformer_layer(x: torch.Tensor, wqkv: torch.Tensor, wmerge: torch.Tensor,
                      norm1: tuple[torch.Tensor, torch.Tensor], k_splits: int,
                      labels=None, with_mask: bool = False, cross_swap: bool = False,
                      target: torch.Tensor | None = None,
                      ffn: tuple | None = None, backend: str = "auto") -> torch.Tensor:
    """One TransformerLayer over the swin windows of ``x`` (B, H, W, C).

    ``wqkv`` (C, 3C) = [Wq | Wk | Wv] and ``wmerge`` (C, C), stored (in, out);
    ``norm1`` (gamma, beta). ``target``: the map k/v are projected from
    (default ``x``); ``cross_swap`` reads it batch-half swapped. ``ffn``:
    (w0 (2C, hidden), w2 (hidden, C), gamma2, beta2) for the cross layer's
    concat-FFN, or None. ``labels``: numpy (k^2, H/k, W/k) region ids of a
    shifted layer, used when ``with_mask``. Returns (B, H, W, C).
    """
    if with_mask and labels is None:
        raise ValueError("with_mask needs labels")
    if use_kernel(backend, x):
        return _layer_cuda(x.contiguous(), wqkv, wmerge, norm1, k_splits, labels, with_mask,
                           cross_swap, None if target is None else target.contiguous(), ffn)
    return _layer_plain(x, wqkv, wmerge, norm1, k_splits, labels, with_mask, cross_swap,
                        target, ffn)


def layer_weights(p: Mapping[str, torch.Tensor], base: str, cross: bool):
    """(wqkv, wmerge, norm1, ffn) of TransformerLayer ``base`` in a GMFlow
    param dict (linear weights stored (in, out))."""
    wqkv = torch.cat([p[f"{base}.{n}.weight"] for n in ("q_proj", "k_proj", "v_proj")], dim=1)
    ffn = None
    if cross:
        ffn = (p[f"{base}.mlp.0.weight"], p[f"{base}.mlp.2.weight"],
               p[f"{base}.norm2.weight"], p[f"{base}.norm2.bias"])
    return (wqkv, p[f"{base}.merge.weight"],
            (p[f"{base}.norm1.weight"], p[f"{base}.norm1.bias"]), ffn)
