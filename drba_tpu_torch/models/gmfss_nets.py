"""GMFSS sub-networks: MetricNet, FeatureNet and GridNet, NHWC, in PyTorch
(counterpart of drba_tpu/models/gmfss_nets.py), with the union variants:
MetricNet's ``Tanh * 10`` tail (model_gmfss_union/MetricNet.py:41-42,63) and
GridNet's 9-channel head ``residual_model_head0``
(model_gmfss_union/FusionNet.py:59).

The convs are cuDNN's, as the JAX package leaves them to XLA; MetricNet's
four backward warps are the exact zeros-padding gather of ``ops/warp``
(the hand-written warp kernel on a CUDA tensor). GridNet is the plain
lattice; its tail runs ``conv_last`` on the low-resolution side of the pixel
shuffle (``ops/shuffle.fold_conv_after_shuffle``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from drba_tpu_torch.models.layers import Params, conv2d, conv_transpose2d, prelu
from drba_tpu_torch.ops.distance import flow_distance
from drba_tpu_torch.ops.shuffle import fold_conv_after_shuffle, pixel_shuffle
from drba_tpu_torch.ops.warp import backwarp

# ------------------------------------------------------------------------------------ MetricNet


def build_metricnet_spec() -> dict:
    spec = {"metric_in.weight": ("conv", 3, 3, 14, 64), "metric_in.bias": ("bias", 64)}
    for i in (1, 2, 3):
        spec[f"metric_net{i}.0.weight"] = ("scalar",)
        spec[f"metric_net{i}.1.weight"] = ("conv", 3, 3, 64, 64)
        spec[f"metric_net{i}.1.bias"] = ("bias", 64)
    spec["metric_out.0.weight"] = ("scalar",)
    spec["metric_out.1.weight"] = ("conv", 3, 3, 64, 2)
    spec["metric_out.1.bias"] = ("bias", 2)
    return spec


METRICNET_SPEC = build_metricnet_spec()


def metricnet_apply(p: Params, img0, img1, flow01, flow10, union: bool = False,
                    warp_backend: str = "auto"):
    """MetricNet.forward (model_gmfss/MetricNet.py:44-65) -> (metric0, metric1);
    ``union`` bounds the metrics to (-10, 10) by ``tanh`` in float32.

    The two image warps and the forward/backward consistency check's two flow
    warps (gmflow/geometry.py:87-108) run as one two-sample zeros-padding warp.
    """
    n = img0.shape[0]
    pk1 = torch.cat([img1, flow10.to(img1.dtype)], dim=-1)
    pk0 = torch.cat([img0, flow01.to(img0.dtype)], dim=-1)
    warped = backwarp(torch.cat([pk1, pk0], dim=0), torch.cat([flow01, flow10], dim=0),
                      padding_mode="zeros", backend=warp_backend)
    w1p, w0p = warped[:n], warped[n:]
    warped_img1, warped_bwd = w1p[..., :3], w1p[..., 3:5]
    warped_img0, warped_fwd = w0p[..., :3], w0p[..., 3:5]

    m0 = (img0 - warped_img1).abs().mean(dim=-1, keepdim=True)
    m1 = (img1 - warped_img0).abs().mean(dim=-1, keepdim=True)

    mag = flow_distance(flow01).float() + flow_distance(flow10).float()
    diff_fwd = flow_distance(flow01 + warped_bwd.to(flow01.dtype)).float()
    diff_bwd = flow_distance(flow10 + warped_fwd.to(flow10.dtype)).float()
    thresh = 0.01 * mag + 0.5
    fwd_occ = (diff_fwd > thresh).to(flow01.dtype)
    bwd_occ = (diff_bwd > thresh).to(flow10.dtype)

    h, w = flow01.shape[1], flow01.shape[2]

    def norm_flow(f):
        return torch.cat([f[..., 0:1] / ((w - 1.0) / 2.0), f[..., 1:2] / ((h - 1.0) / 2.0)],
                         dim=-1)

    x = torch.cat([img0, img1, -m0, -m1, norm_flow(flow01), norm_flow(flow10), fwd_occ,
                   bwd_occ], dim=-1)
    feat = conv2d(p, "metric_in", x, padding=1)
    for i in (1, 2, 3):
        feat = conv2d(p, f"metric_net{i}.1", prelu(p, f"metric_net{i}.0", feat), padding=1) + feat
    out = conv2d(p, "metric_out.1", prelu(p, "metric_out.0", feat), padding=1)
    if union:
        out = torch.tanh(out.float()).to(out.dtype) * 10
    return out[..., 0:1], out[..., 1:2]


# ----------------------------------------------------------------------------------- FeatureNet


def build_featurenet_spec() -> dict:
    spec = {}
    for i, (cin, cout) in enumerate([(3, 64), (64, 128), (128, 192)], start=1):
        spec[f"block{i}.0.weight"] = ("scalar",)
        spec[f"block{i}.1.weight"] = ("conv", 3, 3, cin, cout)
        spec[f"block{i}.1.bias"] = ("bias", cout)
        spec[f"block{i}.2.weight"] = ("scalar",)
        spec[f"block{i}.3.weight"] = ("conv", 3, 3, cout, cout)
        spec[f"block{i}.3.bias"] = ("bias", cout)
    return spec


FEATURENET_SPEC = build_featurenet_spec()


def featurenet_apply(p: Params, x):
    """3-level pyramid at 1/2, 1/4, 1/8 (model_gmfss/FeatureNet.py:29-34)."""
    outs = []
    for i in (1, 2, 3):
        x = conv2d(p, f"block{i}.1", prelu(p, f"block{i}.0", x), stride=2, padding=1)
        x = conv2d(p, f"block{i}.3", prelu(p, f"block{i}.2", x), stride=1, padding=1)
        outs.append(x)
    return tuple(outs)


# -------------------------------------------------------------------------------------- GridNet


def _seq_conv_spec(spec, prefix, cin, cout, transpose=False):
    """Sequential(PReLU, Conv, PReLU, Conv) blocks of FusionNet.py:7-33."""
    spec[f"{prefix}.0.weight"] = ("scalar",)
    spec[f"{prefix}.1.weight"] = ("convT" if transpose else "conv", 4 if transpose else 3,
                                  4 if transpose else 3, cin, cout)
    spec[f"{prefix}.1.bias"] = ("bias", cout)
    spec[f"{prefix}.2.weight"] = ("scalar",)
    spec[f"{prefix}.3.weight"] = ("conv", 3, 3, cout, cout)
    spec[f"{prefix}.3.bias"] = ("bias", cout)


def _head0(union: bool) -> str:
    return "residual_model_head0" if union else "residual_model_head"


def build_gridnet_spec(in_channels: int = 12, union: bool = False) -> dict:
    spec = {}
    _seq_conv_spec(spec, _head0(union), in_channels, 64)
    _seq_conv_spec(spec, "residual_model_head1", 128, 64)
    _seq_conv_spec(spec, "residual_model_head2", 256, 128)
    _seq_conv_spec(spec, "residual_model_head3", 384, 192)
    for r in ("01", "04", "05"):
        _seq_conv_spec(spec, f"residual_model_{r}", 64, 64)
    for r in ("11", "14", "15"):
        _seq_conv_spec(spec, f"residual_model_{r}", 128, 128)
    for r in ("21", "24", "25"):
        _seq_conv_spec(spec, f"residual_model_{r}", 192, 192)
    for d in ("10", "11"):
        _seq_conv_spec(spec, f"downsample_model_{d}", 64, 128)
    for d in ("20", "21"):
        _seq_conv_spec(spec, f"downsample_model_{d}", 128, 192)
    for u in ("04", "05"):
        _seq_conv_spec(spec, f"upsample_model_{u}", 128, 64, transpose=True)
    for u in ("14", "15"):
        _seq_conv_spec(spec, f"upsample_model_{u}", 192, 128, transpose=True)
    # PixelShuffleBlcok tail (FusionNet.py:36-52)
    spec["residual_model_tail.conv_before_upsample.0.weight"] = ("conv", 3, 3, 64, 64)
    spec["residual_model_tail.conv_before_upsample.0.bias"] = ("bias", 64)
    spec["residual_model_tail.conv_before_upsample.1.weight"] = ("scalar",)
    spec["residual_model_tail.upsample.0.weight"] = ("conv", 3, 3, 64, 256)
    spec["residual_model_tail.upsample.0.bias"] = ("bias", 256)
    spec["residual_model_tail.conv_last.weight"] = ("conv", 3, 3, 64, 3)
    spec["residual_model_tail.conv_last.bias"] = ("bias", 3)
    return spec


GRIDNET_SPEC = build_gridnet_spec(12)
GRIDNET_UNION_SPEC = build_gridnet_spec(9, union=True)


def _tail_out(p: Params, u):
    """``conv_last(pixel_shuffle(u, 2))`` with the conv moved through the
    shuffle: the same result, with the conv on 1/4 of the pixels and the
    shuffle moving 12 channels instead of 256."""
    w_lo, b_lo = fold_conv_after_shuffle(p["residual_model_tail.conv_last.weight"],
                                         p["residual_model_tail.conv_last.bias"], 2)
    y = F.conv2d(u.permute(0, 3, 1, 2), w_lo.to(u.dtype), b_lo.to(u.dtype), padding=1)
    return pixel_shuffle(y.permute(0, 2, 3, 1), 2)


def _seq_block(p: Params, prefix, x, stride=1, transpose=False):
    if transpose:
        y = conv_transpose2d(p, f"{prefix}.1", prelu(p, f"{prefix}.0", x), stride=2, padding=1)
    else:
        y = conv2d(p, f"{prefix}.1", prelu(p, f"{prefix}.0", x), stride=stride, padding=1)
    return conv2d(p, f"{prefix}.3", prelu(p, f"{prefix}.2", y), stride=1, padding=1)


def gridnet_apply(p: Params, x, x1, x2, x3, union: bool = False):
    """GridNet lattice (model_gmfss/FusionNet.py:106-145); ``union`` names the
    head as the union network does."""
    X00 = _seq_block(p, _head0(union), x) + _seq_block(p, "residual_model_head1", x1)
    X01 = _seq_block(p, "residual_model_01", X00) + X00
    X10 = (_seq_block(p, "downsample_model_10", X00, stride=2)
           + _seq_block(p, "residual_model_head2", x2))
    X20 = (_seq_block(p, "downsample_model_20", X10, stride=2)
           + _seq_block(p, "residual_model_head3", x3))
    X11 = ((_seq_block(p, "residual_model_11", X10) + X10)
           + _seq_block(p, "downsample_model_11", X01, stride=2))
    X21 = ((_seq_block(p, "residual_model_21", X20) + X20)
           + _seq_block(p, "downsample_model_21", X11, stride=2))
    X24 = _seq_block(p, "residual_model_24", X21) + X21
    X25 = _seq_block(p, "residual_model_25", X24) + X24
    X14 = (_seq_block(p, "upsample_model_14", X24, transpose=True)
           + (_seq_block(p, "residual_model_14", X11) + X11))
    X04 = (_seq_block(p, "upsample_model_04", X14, transpose=True)
           + (_seq_block(p, "residual_model_04", X01) + X01))
    X15 = (_seq_block(p, "upsample_model_15", X25, transpose=True)
           + (_seq_block(p, "residual_model_15", X14) + X14))
    X05 = (_seq_block(p, "upsample_model_05", X15, transpose=True)
           + (_seq_block(p, "residual_model_05", X04) + X04))

    t = conv2d(p, "residual_model_tail.conv_before_upsample.0", X05, padding=1)
    t = prelu(p, "residual_model_tail.conv_before_upsample.1", t)
    t = conv2d(p, "residual_model_tail.upsample.0", t, padding=1)
    return _tail_out(p, t)
