"""GMFSS sub-networks: MetricNet, FeatureNet and GridNet, NHWC, in PyTorch
(counterpart of drba_tpu/models/gmfss_nets.py), with the union variants:
MetricNet's ``Tanh * 10`` tail (model_gmfss_union/MetricNet.py:41-42,63) and
GridNet's 9-channel head ``residual_model_head0``
(model_gmfss_union/FusionNet.py:59).

The sites drba_tpu sends through its conv-chain kernel under
``conv_backend='pallas'`` run through ``ops/conv_chain`` (the hand-written
conv kernel on a CUDA tensor, its plain version on a CPU tensor or with
``conv_backend='torch'``): MetricNet's five convs as one chain, FeatureNet's
level-1 conv with its pre-PReLU, and GridNet's L0 and L1 blocks with their
residual sums and its tail's two convs. drba_tpu takes the chain only where
its TPU column packing fits (``w % 16 == 0 and h % 4 == 0``); the port's
kernel takes every shape, so these sites take the chain at every size.
In f32 the stride-1 convs of FeatureNet's levels 2-3 and of GridNet's
192-channel L2 blocks run as chains too (the same function; with TF32 off
cuDNN runs them by FFT, with a workspace of gigabytes); in bf16 they stay
on cuDNN, as do GridNet's stride-2 and transposed convs, as in drba_tpu.
MetricNet's four backward
warps are the exact zeros-padding gather of ``ops/warp`` (the hand-written
warp kernel on a CUDA tensor). GridNet's tail runs ``conv_last`` on the
low-resolution side of the pixel shuffle
(``ops/shuffle.fold_conv_after_shuffle``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from drba_tpu_torch.models.layers import Params, conv2d, conv_transpose2d, prelu
from drba_tpu_torch.ops.conv_chain import ChainStep, pack_step_weights
from drba_tpu_torch.ops.conv_chain import conv_chain as run_chain
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


def _step(p: Params, conv: str, pre: str | None = None, plain_res: bool = False) -> ChainStep:
    """The ChainStep of conv ``conv``, with the PReLU ``pre`` on its input;
    its packed weights where the model packed them (``pack_chain_weights``)."""
    return ChainStep(w=p[f"{conv}.weight"], b=p[f"{conv}.bias"], wp=p.get(f"{conv}.wp"),
                     pre_alpha=None if pre is None else p[f"{pre}.weight"], plain_res=plain_res)


def pack_chain_weights(p: Params, convs) -> dict:
    """``p`` plus the conv kernel's packed weights (ops/conv_chain.
    pack_step_weights: split for f32, as the weights' dtype says) of the
    chain-site convs ``convs`` (``METRICNET_CHAIN``, ``featurenet_chain_convs``,
    ``gridnet_chain_convs``) under ``{conv}.wp``, built once per model."""
    return {**p, **{f"{c}.wp": pack_step_weights(p[f"{c}.weight"]) for c in convs}}


# the convs of MetricNet's one chain
METRICNET_CHAIN = ("metric_in", "metric_net1.1", "metric_net2.1", "metric_net3.1",
                   "metric_out.1")


def metricnet_apply(p: Params, img0, img1, flow01, flow10, union: bool = False,
                    warp_backend: str = "auto", conv_backend: str = "auto"):
    """MetricNet.forward (model_gmfss/MetricNet.py:44-65) -> (metric0, metric1);
    ``union`` bounds the metrics to (-10, 10) by ``tanh`` in float32.

    The two image warps and the forward/backward consistency check's two flow
    warps (gmflow/geometry.py:87-108) run as one two-sample zeros-padding warp.
    The five convs run as one chain (14 -> 64; three 64 -> 64 steps with the
    pre-PReLU and the plain residual; 64 -> 2 with the pre-PReLU), on
    ``conv_backend``.
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
    steps = [_step(p, "metric_in")]
    steps += [_step(p, f"metric_net{i}.1", f"metric_net{i}.0", plain_res=True) for i in (1, 2, 3)]
    steps.append(_step(p, "metric_out.1", "metric_out.0"))
    out = run_chain(x, steps, backend=conv_backend)
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
# the conv of FeatureNet's one chain
FEATURENET_CHAIN = ("block1.3",)


def featurenet_chain_convs(f32: bool = False) -> tuple[str, ...]:
    """The convs FeatureNet's chain sites run (``featurenet_apply``): level
    1's second conv, and in f32 those of levels 2 and 3 too."""
    return FEATURENET_CHAIN + (("block2.3", "block3.3") if f32 else ())


def featurenet_apply(p: Params, x, conv_backend: str = "auto"):
    """3-level pyramid at 1/2, 1/4, 1/8 (model_gmfss/FeatureNet.py:29-34).
    Level 1's second conv runs as a one-step chain with its pre-PReLU, on
    ``conv_backend``; in f32 levels 2's and 3's do too."""
    outs = []
    for i in (1, 2, 3):
        x = conv2d(p, f"block{i}.1", prelu(p, f"block{i}.0", x), stride=2, padding=1)
        if i == 1 or x.dtype == torch.float32:
            x = run_chain(x, [_step(p, f"block{i}.3", f"block{i}.2")], backend=conv_backend)
        else:
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


# GridNet's chain sites: the L0/L1 seq blocks (each one two-step chain, with
# the head ``_head0``), the stride-2 and transposed blocks (their trailing
# conv a one-step chain) and the tail's two convs
_GRIDNET_SEQ = ("residual_model_head1", "residual_model_head2", "residual_model_01",
                "residual_model_04", "residual_model_05", "residual_model_11",
                "residual_model_14", "residual_model_15")
_GRIDNET_STRIDED = ("downsample_model_10", "downsample_model_11", "upsample_model_14",
                    "upsample_model_04", "upsample_model_15", "upsample_model_05")
_GRIDNET_TAIL = ("residual_model_tail.conv_before_upsample.0", "residual_model_tail.upsample.0")
# the L2 chain sites, f32 only: the stride-1 seq blocks and the stride-2
# blocks' trailing conv
_GRIDNET_L2_SEQ = ("residual_model_head3", "residual_model_21", "residual_model_24",
                   "residual_model_25")
_GRIDNET_L2_STRIDED = ("downsample_model_20", "downsample_model_21")


def gridnet_chain_convs(union: bool = False, f32: bool = False) -> tuple[str, ...]:
    """The convs GridNet's chain sites run (``gridnet_apply``), with L2's in f32."""
    seq = (_head0(union),) + _GRIDNET_SEQ + (_GRIDNET_L2_SEQ if f32 else ())
    strided = _GRIDNET_STRIDED + (_GRIDNET_L2_STRIDED if f32 else ())
    return (tuple(f"{b}.{j}" for b in seq for j in (1, 3)) + tuple(f"{b}.3" for b in strided)
            + _GRIDNET_TAIL)


def gridnet_apply(p: Params, x, x1, x2, x3, union: bool = False, conv_backend: str = "auto"):
    """GridNet lattice (model_gmfss/FusionNet.py:106-145); ``union`` names the
    head as the union network does.

    The L0 (64-channel) and L1 (128-channel) blocks run on the conv chain, on
    ``conv_backend`` (drba_tpu's ``_gridnet_fused`` without its TPU column
    packing): each seq block one chain carrying its lattice sum as the final
    residual; the stride-2 and transposed convs on cuDNN, each followed by
    its trailing conv as a one-step chain carrying the lattice sum; the
    tail's two convs as one chain. L2 (192 channels) stays on cuDNN in
    bf16 and takes the chain in f32, as L1 does. The sums add the same terms
    in the same order as FusionNet.py (a sum's two terms swapped where a
    chain carries the first: the same value).
    """
    def seq(prefix, src, residual="none", res=None):
        # _seq_block (PReLU, conv, PReLU, conv) as one two-step chain
        steps = [_step(p, f"{prefix}.1", f"{prefix}.0"), _step(p, f"{prefix}.3", f"{prefix}.2")]
        return run_chain(src, steps, residual, res, conv_backend)

    def strided_plus(name, src, other, transpose=False):
        a = prelu(p, f"{name}.0", src)
        if transpose:
            t = conv_transpose2d(p, f"{name}.1", a, stride=2, padding=1)
        else:
            t = conv2d(p, f"{name}.1", a, stride=2, padding=1)
        return run_chain(t, [_step(p, f"{name}.3", f"{name}.2")], "extra", other, conv_backend)

    X00 = seq("residual_model_head1", x1, "extra", seq(_head0(union), x))
    X01 = seq("residual_model_01", X00, "input")
    X10 = strided_plus("downsample_model_10", X00, seq("residual_model_head2", x2))
    X11 = strided_plus("downsample_model_11", X01, seq("residual_model_11", X10, "input"))
    if x.dtype == torch.float32:  # L2 as L1
        X20 = strided_plus("downsample_model_20", X10, seq("residual_model_head3", x3))
        X21 = strided_plus("downsample_model_21", X11, seq("residual_model_21", X20, "input"))
        X24 = seq("residual_model_24", X21, "input")
        X25 = seq("residual_model_25", X24, "input")
    else:
        X20 = (_seq_block(p, "downsample_model_20", X10, stride=2)
               + _seq_block(p, "residual_model_head3", x3))
        X21 = ((_seq_block(p, "residual_model_21", X20) + X20)
               + _seq_block(p, "downsample_model_21", X11, stride=2))
        X24 = _seq_block(p, "residual_model_24", X21) + X21
        X25 = _seq_block(p, "residual_model_25", X24) + X24
    X14 = strided_plus("upsample_model_14", X24, seq("residual_model_14", X11, "input"), True)
    X04 = strided_plus("upsample_model_04", X14, seq("residual_model_04", X01, "input"), True)
    X15 = strided_plus("upsample_model_15", X25, seq("residual_model_15", X14, "input"), True)
    X05 = strided_plus("upsample_model_05", X15, seq("residual_model_05", X04, "input"), True)
    t = run_chain(X05, [_step(p, _GRIDNET_TAIL[0]),
                        _step(p, _GRIDNET_TAIL[1], "residual_model_tail.conv_before_upsample.1")],
                  backend=conv_backend)
    return _tail_out(p, t)
