"""GMFlow optical-flow estimator, NHWC, in PyTorch (counterpart of
drba_tpu/models/gmflow_net.py).

Two scales (1/8, 1/4 of the input):
  CNN backbone (ResNet-style, instance norm, shared-weight trident conv) ->
  sine position embedding per swin window -> 6 blocks of self-attention and
  cross-attention with FFN over shifted windows -> correlation softmax
  (global at scale 0, local r = 4 at scale 1) -> flow propagation (global
  self-attention at scale 0, 3x3 local at scale 1) -> convex x4 upsampling.

``pred_bidir`` computes both flow directions in one pass: the backward
global correlation swaps q and k, and scale 1 stacks both directions on the
batch axis.

Every TransformerLayer goes through ``ops/attn_layer.transformer_layer`` and
the global correlation and global propagation through
``ops/attention.flash_attention``: the hand-written kernels on a CUDA tensor
(``attn_backend`` 'auto' or 'cuda'), the plain versions otherwise. The layer
kernels read the weights ``pack_transformer_weights`` packs once. The
backbone and upsampler convs are cuDNN's, as the JAX package leaves them to
XLA.

The constants a pass adds (position embedding, ImageNet mean and std) are
uploaded once per shape and device and cached, and the correlation's
constants are made on the card, so that a pass makes no host-to-device copy
(a captured window may hold none: ``graphs.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from drba_tpu_torch.models.layers import Params, conv2d, instance_norm, linear, relu
from drba_tpu_torch.ops.attention import flash_attention
from drba_tpu_torch.ops.attn_layer import layer_weights, pack_layer_weights, transformer_layer
from drba_tpu_torch.ops.resize import resize_bilinear
from drba_tpu_torch.ops.shuffle import unfold3x3
from drba_tpu_torch.ops.warp import backwarp

FEATURE_CHANNELS = 128
NUM_LAYERS = 6
UPSAMPLE_FACTOR = 4
ATTN_SPLITS = (2, 8)
CORR_RADIUS = (-1, 4)
PROP_RADIUS = (-1, 1)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _res_block(spec, prefix, cin, cout, stride):
    spec[f"{prefix}.conv1.weight"] = ("conv", 3, 3, cin, cout)
    spec[f"{prefix}.conv2.weight"] = ("conv", 3, 3, cout, cout)
    if stride != 1 or cin != cout:
        spec[f"{prefix}.downsample.0.weight"] = ("conv", 1, 1, cin, cout)
        spec[f"{prefix}.downsample.0.bias"] = ("bias", cout)


def build_spec() -> dict:
    """Param spec with torch state-dict key names; equal to
    drba_tpu.models.gmflow_net.GMFLOW_SPEC."""
    spec = {}
    spec["backbone.conv1.weight"] = ("conv", 7, 7, 3, 64)
    _res_block(spec, "backbone.layer1.0", 64, 64, 1)
    _res_block(spec, "backbone.layer1.1", 64, 64, 1)
    _res_block(spec, "backbone.layer2.0", 64, 96, 2)
    _res_block(spec, "backbone.layer2.1", 96, 96, 1)
    _res_block(spec, "backbone.layer3.0", 96, 128, 1)
    _res_block(spec, "backbone.layer3.1", 128, 128, 1)
    spec["backbone.conv2.weight"] = ("conv", 1, 1, 128, 128)
    spec["backbone.conv2.bias"] = ("bias", 128)
    spec["backbone.trident_conv.weight"] = ("conv", 3, 3, 128, 128)

    c = FEATURE_CHANNELS
    for i in range(NUM_LAYERS):
        for attn in ("self_attn", "cross_attn_ffn"):
            base = f"transformer.layers.{i}.{attn}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                spec[f"{base}.{proj}.weight"] = ("linear", c, c)
            spec[f"{base}.norm1.weight"] = ("ones", (c,))
            spec[f"{base}.norm1.bias"] = ("zeros", (c,))
            if attn == "cross_attn_ffn":
                spec[f"{base}.mlp.0.weight"] = ("linear", 2 * c, 2 * c * 4)
                spec[f"{base}.mlp.2.weight"] = ("linear", 2 * c * 4, c)
                spec[f"{base}.norm2.weight"] = ("ones", (c,))
                spec[f"{base}.norm2.bias"] = ("zeros", (c,))

    spec["feature_flow_attn.q_proj.weight"] = ("linear", c, c)
    spec["feature_flow_attn.q_proj.bias"] = ("bias", c)
    spec["feature_flow_attn.k_proj.weight"] = ("linear", c, c)
    spec["feature_flow_attn.k_proj.bias"] = ("bias", c)

    spec["upsampler.0.weight"] = ("conv", 3, 3, 2 + c, 256)
    spec["upsampler.0.bias"] = ("bias", 256)
    spec["upsampler.2.weight"] = ("conv", 1, 1, 256, UPSAMPLE_FACTOR**2 * 9)
    spec["upsampler.2.bias"] = ("bias", UPSAMPLE_FACTOR**2 * 9)
    return spec


GMFLOW_SPEC = build_spec()


# ------------------------------------------------------------------------------------ backbone


def _residual_block(p: Params, prefix: str, x, stride: int):
    y = relu(instance_norm(conv2d(p, f"{prefix}.conv1", x, stride=stride, padding=1)))
    y = relu(instance_norm(conv2d(p, f"{prefix}.conv2", y, stride=1, padding=1)))
    if f"{prefix}.downsample.0.weight" in p:
        x = instance_norm(conv2d(p, f"{prefix}.downsample.0", x, stride=stride, padding=0))
    return relu(x + y)


def backbone_apply(p: Params, x):
    """CNNEncoder (backbone.py:101-117) -> (1/4, 1/8) feature maps."""
    x = relu(instance_norm(conv2d(p, "backbone.conv1", x, stride=2, padding=3)))
    for name, stride in (("layer1.0", 1), ("layer1.1", 1), ("layer2.0", 2), ("layer2.1", 1),
                         ("layer3.0", 1), ("layer3.1", 1)):
        x = _residual_block(p, f"backbone.{name}", x, stride)
    x = conv2d(p, "backbone.conv2", x, stride=1, padding=0)
    # shared-weight trident conv, strides (1, 2): high resolution, then low
    hi = conv2d(p, "backbone.trident_conv", x, stride=1, padding=1)
    lo = conv2d(p, "backbone.trident_conv", x, stride=2, padding=1)
    return hi, lo


# ---------------------------------------------------------------- position embedding, windows


def sine_position_embedding(h: int, w: int, num_feats: int = FEATURE_CHANNELS // 2) -> np.ndarray:
    """PositionEmbeddingSine on an all-ones mask (position.py:30-54), (h, w, 2*num_feats)."""
    scale = 2 * math.pi
    y_embed = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x_embed = np.cumsum(np.ones((h, w), np.float32), axis=1)
    eps = 1e-6
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_feats, dtype=np.float32)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / num_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)


@functools.lru_cache(maxsize=32)
def _device_constant(name: str, shape: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    """A constant of this module on ``device``, made and uploaded once per
    (name, shape, dtype, device). The upload is a blocking copy, so the
    cached tensor has landed before any stream reads it."""
    if name == "position":  # shape (h, w, k): one window's embedding tiled k x k
        h, w, k = shape
        value = np.tile(sine_position_embedding(h // k, w // k), (k, k, 1))
    else:
        value = {"mean": IMAGENET_MEAN, "std": IMAGENET_STD}[name]
    return torch.from_numpy(value).to(device, dtype)


def add_position(feature0, feature1, attn_splits: int):
    """feature_add_position (gmflow/utils.py:74-94): the embedding of one
    window's size, added to every window (tiled over the map)."""
    b, h, w, c = feature0.shape
    pos = _device_constant("position", (h, w, attn_splits), feature0.dtype,
                           str(feature0.device))
    return feature0 + pos, feature1 + pos


def shift_region_labels(h: int, w: int, k: int) -> np.ndarray:
    """Swin shift region labels per window position (transformer.py:19-43),
    (k^2, h/k, w/k) int32: token i may attend token j iff their labels match."""
    win_h, win_w = h // k, w // k
    shift_h, shift_w = win_h // 2, win_w // 2
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -win_h), slice(-win_h, -shift_h), slice(-shift_h, None)):
        for ws in (slice(0, -win_w), slice(-win_w, -shift_w), slice(-shift_w, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    return img_mask.reshape(k, win_h, k, win_w).transpose(0, 2, 1, 3).reshape(k * k, win_h, win_w)


# ----------------------------------------------------------------------------------- transformer


def pack_transformer_weights(p: Params) -> Params:
    """``p`` plus every TransformerLayer's weights packed for the layer
    kernels (ops/attn_layer.pack_layer_weights): built once, where a model
    builds its parameters."""
    out = dict(p)
    for i in range(NUM_LAYERS):
        for attn, cross in (("self_attn", False), ("cross_attn_ffn", True)):
            out.update(pack_layer_weights(p, f"transformer.layers.{i}.{attn}", cross))
    return out


def transformer_apply(p: Params, feature0, feature1, attn_splits: int, backend: str = "auto"):
    """FeatureTransformer (transformer.py:244-322): 6 blocks of self-attention
    and cross-attention with FFN, both directions stacked on the batch axis.

    A shifted block rolls the map once before its two layers and back after.
    The cross layer attends to the batch-half swap of the state before the
    block's self-attention (the reference updates concat1 once per block,
    transformer.py:291-300).
    """
    x = torch.cat([feature0, feature1], dim=0)
    b2, h, w, c = x.shape
    k = attn_splits
    sh, sw = (h // k) // 2, (w // k) // 2
    lab = shift_region_labels(h, w, k) if k > 1 else None
    for i in range(NUM_LAYERS):
        with_shift = k > 1 and i % 2 == 1
        if with_shift:
            x = torch.roll(x, (-sh, -sw), dims=(1, 2))
        x_pre = x
        for attn, cross in (("self_attn", False), ("cross_attn_ffn", True)):
            x = transformer_layer(x, layer_weights(p, f"transformer.layers.{i}.{attn}", cross), k,
                                  labels=lab if with_shift else None, with_mask=with_shift,
                                  cross_swap=cross, target=x_pre if cross else None,
                                  backend=backend)
        if with_shift:
            x = torch.roll(x, (sh, sw), dims=(1, 2))
    half = b2 // 2
    return x[:half], x[half:]


# ----------------------------------------------------------------------------------- correlation


def _pixel_grid(h: int, w: int, device) -> torch.Tensor:
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(h * w, 2)


def global_correlation_flow(feature0, feature1, bidir: bool = False, backend: str = "auto"):
    """global_correlation_softmax (matching.py:7-38): the softmax over all
    positions of f0 . f1 / sqrt(c), applied to the pixel grid. ``bidir``
    appends the backward flow (q and k swapped) on the batch axis."""
    b, h, w, c = feature0.shape
    f0 = feature0.reshape(b, h * w, c)
    f1 = feature1.reshape(b, h * w, c)
    grid = _pixel_grid(h, w, feature0.device)
    gb = grid[None].expand(b, h * w, 2)
    corr = flash_attention(f0, f1, gb, out_dtype=torch.float32, backend=backend)
    if bidir:
        corr = torch.cat([corr, flash_attention(f1, f0, gb, out_dtype=torch.float32,
                                                backend=backend)], dim=0)
    flow = corr - grid[None]
    return flow.reshape(-1, h, w, 2).to(feature0.dtype)


def local_correlation_flow(feature0, feature1, radius: int):
    """local_correlation_softmax (matching.py:41-89) as 81 dense shifts: the
    sample offsets are integers, so the flow is the softmax-weighted mean of
    the offsets; out-of-frame offsets get -1e4 before the softmax."""
    b, h, w, c = feature0.shape
    r = radius
    f0 = feature0.float()
    f1p = F.pad(feature1.float(), (0, 0, r, r, r, r))
    gx = torch.arange(w, device=feature0.device)[None, None, :]
    gy = torch.arange(h, device=feature0.device)[None, :, None]
    corrs, valids = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = f1p[:, dy + r:dy + r + h, dx + r:dx + r + w, :]
            corrs.append((f0 * shifted).sum(dim=-1) / math.sqrt(c))
            valids.append(((gx + dx >= 0) & (gx + dx < w) & (gy + dy >= 0) & (gy + dy < h))
                          .expand(b, h, w))
    corr = torch.where(torch.stack(valids, dim=-1), torch.stack(corrs, dim=-1), -1e4)
    prob = torch.softmax(corr, dim=-1)
    # the offsets (dx, dy) in the loop's order, dy outer, made on the card
    n = 2 * r + 1
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=feature0.device)
    off = torch.stack([d[None, :].expand(n, n), d[:, None].expand(n, n)], dim=-1).reshape(-1, 2)
    return torch.matmul(prob, off).to(feature0.dtype)


# ------------------------------------------------------------------ flow propagation, upsampling


def flow_prop_global(p: Params, feature0, flow, backend: str = "auto"):
    """Global self-attention propagation (transformer.py:343-374). The key is
    k_proj(q_proj(feature)), the reference's quirk, kept for parity."""
    b, h, w, c = feature0.shape
    q = linear(p, "feature_flow_attn.q_proj", feature0).reshape(b, h * w, c)
    k = linear(p, "feature_flow_attn.k_proj", q)
    out = flash_attention(q, k, flow.reshape(b, h * w, 2).float(), out_dtype=torch.float32,
                          backend=backend)
    return out.reshape(b, h, w, 2).to(flow.dtype)


def flow_prop_local(p: Params, feature0, flow, radius: int = 1):
    """3x3 local propagation (transformer.py:376-409); the key here is
    k_proj of the feature itself."""
    if radius != 1:
        raise ValueError("the reference propagates locally with radius 1 only")
    c = feature0.shape[-1]
    q = linear(p, "feature_flow_attn.q_proj", feature0)
    k_win = unfold3x3(linear(p, "feature_flow_attn.k_proj", feature0))  # (B,H,W,C,9)
    flow_win = unfold3x3(flow).float()                                  # (B,H,W,2,9)
    scores = torch.einsum("bhwc,bhwck->bhwk", q.float(), k_win.float()) / math.sqrt(c)
    prob = torch.softmax(scores, dim=-1)
    return torch.einsum("bhwk,bhwck->bhwc", prob, flow_win).to(flow.dtype)


def convex_upsample(p: Params, flow, feature):
    """Convex x4 upsampling (gmflow.py:74-90)."""
    b, h, w, _ = flow.shape
    K = UPSAMPLE_FACTOR
    mask = relu(conv2d(p, "upsampler.0", torch.cat([flow, feature], dim=-1), padding=1))
    mask = conv2d(p, "upsampler.2", mask).reshape(b, h, w, 9, K, K)
    mask = torch.softmax(mask.float(), dim=3)
    up = unfold3x3(flow.float() * K)  # (B,H,W,2,9)
    out = torch.einsum("bhwqij,bhwcq->bhwcij", mask, up)  # (B,H,W,2,K,K)
    return out.permute(0, 1, 4, 2, 5, 3).reshape(b, h * K, w * K, 2).to(flow.dtype)


# ------------------------------------------------------------------------------------- forward


def normalize_img(img):
    mean, std = (_device_constant(name, (3,), img.dtype, str(img.device))
                 for name in ("mean", "std"))
    return (img - mean) / std


def gmflow_apply(p: Params, img0, img1, pred_bidir: bool = False, attn_backend: str = "auto",
                 warp_backend: str = "auto"):
    """GMFlow.forward (gmflow.py:92-185): flow at input resolution (B,H,W,2),
    or (2B,...) as [forward; backward] with ``pred_bidir``."""
    hi, lo = backbone_apply(p, torch.cat([normalize_img(img0), normalize_img(img1)], dim=0))
    b = img0.shape[0]
    features = [(lo[:b], lo[b:]), (hi[:b], hi[b:])]  # low resolution first

    flow = None
    for scale_idx in range(2):
        feature0, feature1 = features[scale_idx]
        attn_splits = ATTN_SPLITS[scale_idx]
        if pred_bidir and scale_idx > 0:
            feature0, feature1 = (torch.cat([feature0, feature1], dim=0),
                                  torch.cat([feature1, feature0], dim=0))
        if scale_idx > 0:
            h2, w2 = feature0.shape[1], feature0.shape[2]
            flow = resize_bilinear(flow, (h2, w2), align_corners=True) * 2
            feature1 = backwarp(feature1, flow, padding_mode="zeros", backend=warp_backend)

        feature0, feature1 = add_position(feature0, feature1, attn_splits)
        feature0, feature1 = transformer_apply(p, feature0, feature1, attn_splits,
                                               backend=attn_backend)

        if CORR_RADIUS[scale_idx] == -1:
            flow_pred = global_correlation_flow(feature0, feature1,
                                                bidir=pred_bidir and scale_idx == 0,
                                                backend=attn_backend)
        else:
            flow_pred = local_correlation_flow(feature0, feature1, CORR_RADIUS[scale_idx])
        flow = flow_pred if flow is None else flow + flow_pred

        if pred_bidir and scale_idx == 0:
            feature0 = torch.cat([feature0, feature1], dim=0)
        if PROP_RADIUS[scale_idx] > 0:
            flow = flow_prop_local(p, feature0, flow, PROP_RADIUS[scale_idx])
        else:
            flow = flow_prop_global(p, feature0, flow, backend=attn_backend)
        if scale_idx == 1:
            flow = convex_upsample(p, flow, feature0)
    return flow
