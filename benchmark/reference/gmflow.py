"""GMFlow, plain PyTorch, NHWC (frozen reference; GMFSS_Fortuna ``gmflow/``).

Two scales (1/8, 1/4 of the input): a ResNet backbone with instance norm
and a shared-weight trident conv; a sine position embedding per swin
window; six blocks of self- and cross-attention with FFN over shifted
windows; correlation softmax (global at scale 0, local radius 4 at scale
1); flow propagation (global self-attention, then 3x3 local); convex x4
upsampling. Both flow directions come from one pass (``pred_bidir``).
Attention is ``softmax(q k^T / sqrt(c)) v`` with the scores and the value
product in f32; a key of another shift region gets -1e9.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.nn import (Params, backwarp, conv2d, einsum, gelu, instance_norm,
                                    layer_norm, linear, matmul, q, relu, resize, unfold3x3)

C = 128
NUM_LAYERS = 6
ATTN_SPLITS = (2, 8)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def spec() -> dict:
    s = {"backbone.conv1.weight": ("conv", 7, 7, 3, 64)}

    def res(prefix, cin, cout, stride):
        s[f"{prefix}.conv1.weight"] = ("conv", 3, 3, cin, cout)
        s[f"{prefix}.conv2.weight"] = ("conv", 3, 3, cout, cout)
        if stride != 1 or cin != cout:
            s[f"{prefix}.downsample.0.weight"] = ("conv", 1, 1, cin, cout)
            s[f"{prefix}.downsample.0.bias"] = ("bias", cout)

    for name, cin, cout, stride in (("layer1.0", 64, 64, 1), ("layer1.1", 64, 64, 1),
                                    ("layer2.0", 64, 96, 2), ("layer2.1", 96, 96, 1),
                                    ("layer3.0", 96, 128, 1), ("layer3.1", 128, 128, 1)):
        res(f"backbone.{name}", cin, cout, stride)
    s["backbone.conv2.weight"] = ("conv", 1, 1, 128, 128)
    s["backbone.conv2.bias"] = ("bias", 128)
    s["backbone.trident_conv.weight"] = ("conv", 3, 3, 128, 128)
    for i in range(NUM_LAYERS):
        for attn in ("self_attn", "cross_attn_ffn"):
            base = f"transformer.layers.{i}.{attn}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                s[f"{base}.{proj}.weight"] = ("linear", C, C)
            s[f"{base}.norm1.weight"] = ("ones", C)
            s[f"{base}.norm1.bias"] = ("zeros", C)
            if attn == "cross_attn_ffn":
                s[f"{base}.mlp.0.weight"] = ("linear", 2 * C, 8 * C)
                s[f"{base}.mlp.2.weight"] = ("linear", 8 * C, C)
                s[f"{base}.norm2.weight"] = ("ones", C)
                s[f"{base}.norm2.bias"] = ("zeros", C)
    for proj in ("q_proj", "k_proj"):
        s[f"feature_flow_attn.{proj}.weight"] = ("linear", C, C)
        s[f"feature_flow_attn.{proj}.bias"] = ("bias", C)
    s["upsampler.0.weight"] = ("conv", 3, 3, 2 + C, 256)
    s["upsampler.0.bias"] = ("bias", 256)
    s["upsampler.2.weight"] = ("conv", 1, 1, 256, 16 * 9)
    s["upsampler.2.bias"] = ("bias", 16 * 9)
    return s


def _residual(p, prefix, x, stride):
    y = relu(instance_norm(conv2d(p, f"{prefix}.conv1", x, stride=stride, padding=1)))
    y = relu(instance_norm(conv2d(p, f"{prefix}.conv2", y, padding=1)))
    if f"{prefix}.downsample.0.weight" in p:
        x = instance_norm(conv2d(p, f"{prefix}.downsample.0", x, stride=stride))
    return relu(x + y)


def backbone(p, x):
    x = relu(instance_norm(conv2d(p, "backbone.conv1", x, stride=2, padding=3)))
    for name, stride in (("layer1.0", 1), ("layer1.1", 1), ("layer2.0", 2), ("layer2.1", 1),
                         ("layer3.0", 1), ("layer3.1", 1)):
        x = _residual(p, f"backbone.{name}", x, stride)
    x = conv2d(p, "backbone.conv2", x)
    return (conv2d(p, "backbone.trident_conv", x, padding=1),
            conv2d(p, "backbone.trident_conv", x, stride=2, padding=1))


def position_embedding(h: int, w: int, num_feats: int = C // 2) -> np.ndarray:
    """Sine embedding of an all-ones mask, (h, w, 2 * num_feats)."""
    y = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x = np.cumsum(np.ones((h, w), np.float32), axis=1)
    y = y / (y[-1:, :] + 1e-6) * (2 * math.pi)
    x = x / (x[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = 10000.0 ** (2 * (np.arange(num_feats, dtype=np.float32) // 2) / num_feats)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1)


def shift_labels(h: int, w: int, k: int) -> np.ndarray:
    """Swin shift region of each token, per window: (k*k, h/k, w/k)."""
    wh, ww = h // k, w // k
    mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -(wh // 2)), slice(-(wh // 2), None)):
        for ws in (slice(0, -ww), slice(-ww, -(ww // 2)), slice(-(ww // 2), None)):
            mask[hs, ws] = cnt
            cnt += 1
    return mask.reshape(k, wh, k, ww).transpose(0, 2, 1, 3).reshape(k * k, wh, ww)


def attention(qt, kt, vt, dead=None, out_dtype=None):
    """q, k (N, L, c), v (N, L, cv); ``dead`` (N or 1, L, L) bool."""
    s = matmul(qt.float(), kt.float().transpose(1, 2)) * (1.0 / math.sqrt(qt.shape[-1]))
    if dead is not None:
        s = s.masked_fill(dead, -1e9)
    return matmul(torch.softmax(s, dim=-1), vt.float()).to(out_dtype or qt.dtype)


def _split(x, k):
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def _merge(x, k):
    bkk, hk, wk, c = x.shape
    x = x.reshape(bkk // (k * k), k, k, hk, wk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bkk // (k * k), k * hk, k * wk, c)


def window_attention(qm, km, vm, k, labels=None):
    """Attention within each of the k x k windows of (B, H, W, c) maps."""
    b, h, w, c = qm.shape
    wh, ww = h // k, w // k
    s = _split(torch.cat([qm, km, vm], dim=0), k).reshape(3, b * k * k, wh * ww, c)
    dead = None
    if labels is not None:
        lab = torch.from_numpy(labels.reshape(k * k, wh * ww)).to(qm.device)
        dead = (lab[:, :, None] != lab[:, None, :]).repeat(b, 1, 1)
    out = attention(s[0], s[1], s[2], dead, qm.dtype)
    return _merge(out.reshape(b * k * k, wh, ww, c), k)


def layer(p, base, x, k, labels, cross, target):
    """One TransformerLayer; the cross layer attends to the batch-half swap
    of ``target`` and adds its concat-FFN."""
    tgt = target if cross else x
    if cross:
        half = tgt.shape[0] // 2
        tgt = torch.cat([tgt[half:], tgt[:half]], dim=0)
    msg = window_attention(linear(p, f"{base}.q_proj", x), linear(p, f"{base}.k_proj", tgt),
                           linear(p, f"{base}.v_proj", tgt), k, labels)
    msg = layer_norm(p, f"{base}.norm1", linear(p, f"{base}.merge", msg))
    if cross:
        msg = linear(p, f"{base}.mlp.0", torch.cat([x, msg], dim=-1))
        msg = layer_norm(p, f"{base}.norm2", linear(p, f"{base}.mlp.2", gelu(msg)))
    return x + msg


def transformer(p, feature0, feature1, k):
    x = torch.cat([feature0, feature1], dim=0)
    b2, h, w, _ = x.shape
    sh, sw = (h // k) // 2, (w // k) // 2
    lab = shift_labels(h, w, k) if k > 1 else None
    for i in range(NUM_LAYERS):
        shifted = k > 1 and i % 2 == 1
        if shifted:
            x = torch.roll(x, (-sh, -sw), dims=(1, 2))
        x_pre = x
        for attn, cross in (("self_attn", False), ("cross_attn_ffn", True)):
            x = layer(p, f"transformer.layers.{i}.{attn}", x, k, lab if shifted else None,
                      cross, x_pre)
        if shifted:
            x = torch.roll(x, (sh, sw), dims=(1, 2))
    return x[:b2 // 2], x[b2 // 2:]


def _grid(h, w, device):
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(h * w, 2)


def global_correlation(feature0, feature1, bidir: bool):
    b, h, w, c = feature0.shape
    f0, f1 = feature0.reshape(b, h * w, c), feature1.reshape(b, h * w, c)
    grid = _grid(h, w, feature0.device)
    gb = grid[None].expand(b, h * w, 2)
    corr = attention(f0, f1, gb, out_dtype=torch.float32)
    if bidir:
        corr = torch.cat([corr, attention(f1, f0, gb, out_dtype=torch.float32)], dim=0)
    return (corr - grid[None]).reshape(-1, h, w, 2).to(feature0.dtype)


def local_correlation(feature0, feature1, r: int):
    b, h, w, c = feature0.shape
    f0 = q(feature0.float())
    f1p = F.pad(q(feature1.float()), (0, 0, r, r, r, r))
    gx = torch.arange(w, device=feature0.device)[None, None, :]
    gy = torch.arange(h, device=feature0.device)[None, :, None]
    corrs, valids = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            corrs.append((f0 * f1p[:, dy + r:dy + r + h, dx + r:dx + r + w, :]).sum(dim=-1)
                         / math.sqrt(c))
            valids.append(((gx + dx >= 0) & (gx + dx < w) & (gy + dy >= 0) & (gy + dy < h))
                          .expand(b, h, w))
    corr = torch.where(torch.stack(valids, dim=-1), torch.stack(corrs, dim=-1), -1e4)
    prob = torch.softmax(corr, dim=-1)
    n = 2 * r + 1
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=feature0.device)
    off = torch.stack([d[None, :].expand(n, n), d[:, None].expand(n, n)], dim=-1).reshape(-1, 2)
    return torch.matmul(prob, off).to(feature0.dtype)


def prop_global(p, feature0, flow):
    """Global self-attention propagation; the key is k_proj(q_proj(f))."""
    b, h, w, c = feature0.shape
    qt = linear(p, "feature_flow_attn.q_proj", feature0).reshape(b, h * w, c)
    kt = linear(p, "feature_flow_attn.k_proj", qt)
    out = attention(qt, kt, flow.reshape(b, h * w, 2).float(), out_dtype=torch.float32)
    return out.reshape(b, h, w, 2).to(flow.dtype)


def prop_local(p, feature0, flow):
    c = feature0.shape[-1]
    qt = linear(p, "feature_flow_attn.q_proj", feature0)
    k_win = unfold3x3(linear(p, "feature_flow_attn.k_proj", feature0))
    scores = einsum("bhwc,bhwck->bhwk", qt.float(), k_win.float()) / math.sqrt(c)
    prob = torch.softmax(scores, dim=-1)
    return einsum("bhwk,bhwck->bhwc", prob, unfold3x3(flow).float()).to(flow.dtype)


def convex_upsample(p, flow, feature):
    b, h, w, _ = flow.shape
    mask = relu(conv2d(p, "upsampler.0", torch.cat([flow, feature], dim=-1), padding=1))
    mask = conv2d(p, "upsampler.2", mask).reshape(b, h, w, 9, 4, 4)
    mask = torch.softmax(mask.float(), dim=3)
    out = einsum("bhwqij,bhwcq->bhwcij", mask, unfold3x3(flow.float() * 4))
    return out.permute(0, 1, 4, 2, 5, 3).reshape(b, h * 4, w * 4, 2).to(flow.dtype)


def apply(p: Params, img0, img1):
    """Both flows of (img0, img1) at input resolution: (2B, H, W, 2),
    forward then backward."""
    mean = torch.from_numpy(MEAN).to(img0.device, img0.dtype)
    std = torch.from_numpy(STD).to(img0.device, img0.dtype)
    hi, lo = backbone(p, torch.cat([(img0 - mean) / std, (img1 - mean) / std], dim=0))
    b = img0.shape[0]
    flow = None
    for scale_idx, (feat, k) in enumerate(zip((lo, hi), ATTN_SPLITS)):
        feature0, feature1 = feat[:b], feat[b:]
        if scale_idx:
            feature0, feature1 = (torch.cat([feature0, feature1], dim=0),
                                  torch.cat([feature1, feature0], dim=0))
            flow = resize(flow, feature0.shape[1:3], align_corners=True) * 2
            feature1 = backwarp(feature1, flow, zeros=True)
        hh, ww = feature0.shape[1], feature0.shape[2]
        pos = torch.from_numpy(np.tile(position_embedding(hh // k, ww // k), (k, k, 1)))
        pos = pos.to(feature0.device, feature0.dtype)
        feature0, feature1 = transformer(p, feature0 + pos, feature1 + pos, k)
        if scale_idx == 0:
            pred = global_correlation(feature0, feature1, bidir=True)
            flow = pred
            flow = prop_global(p, torch.cat([feature0, feature1], dim=0), flow)
        else:
            flow = flow + local_correlation(feature0, feature1, 4)
            flow = prop_local(p, feature0, flow)
            flow = convex_upsample(p, flow, feature0)
    return flow
