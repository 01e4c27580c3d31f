"""IFNet 4.26-heavy (RIFE's flow/fusion network), NHWC, in PyTorch.

Counterpart of drba_tpu/models/ifnet.py, following the path the JAX package
takes on the CPU (its exact path):

  * ``Head`` encoder: 3 convs + transposed conv, 16 channels;
  * 5 coarse-to-fine IFBlocks (c = 192/128/96/64/32): two stride-2 convs,
    8 ResConvs ``leaky(conv(x) * beta + x)`` run through ``conv_chain``
    (the hand-written kernel on CUDA, in every block, on weights packed once
    per model by ``pack_resconv_weights``), then the lastconv in its reference
    form, ConvTranspose2d(4, s2) + PixelShuffle(2);
  * per stage the images and encoder features of both directions are
    backward-warped in one call (``backwarp2``, one kernel launch); at an
    even integer pyramid scale k the warp is evaluated only at the k-fold
    downsample's tap grid, which equals warping at full resolution and then
    downsampling;
  * a sigmoid-mask merge of the two final warps.
"""

from __future__ import annotations

import torch

from drba_tpu_torch.models.layers import Params, conv2d, conv_transpose2d, leaky_relu
from drba_tpu_torch.ops.conv_chain import ChainStep, conv_chain, pack_step_weights
from drba_tpu_torch.ops.resize import resize_bilinear
from drba_tpu_torch.ops.shuffle import pixel_shuffle
from drba_tpu_torch.ops.warp import backwarp2

BLOCK_CHANNELS = (192, 128, 96, 64, 32)
BLOCK_IN = (7 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32)


def build_spec() -> dict:
    """Param spec with torch state-dict key names; the same keys, kinds and
    (JAX-layout) dims as drba_tpu.models.ifnet.IFNET_SPEC."""
    spec = {}
    spec["encode.cnn0.weight"] = ("conv", 3, 3, 3, 16)
    spec["encode.cnn0.bias"] = ("bias", 16)
    spec["encode.cnn1.weight"] = ("conv", 3, 3, 16, 16)
    spec["encode.cnn1.bias"] = ("bias", 16)
    spec["encode.cnn2.weight"] = ("conv", 3, 3, 16, 16)
    spec["encode.cnn2.bias"] = ("bias", 16)
    spec["encode.cnn3.weight"] = ("convT", 4, 4, 16, 16)
    spec["encode.cnn3.bias"] = ("bias", 16)
    for i, (cin, c) in enumerate(zip(BLOCK_IN, BLOCK_CHANNELS)):
        b = f"block{i}"
        spec[f"{b}.conv0.0.0.weight"] = ("conv", 3, 3, cin, c // 2)
        spec[f"{b}.conv0.0.0.bias"] = ("bias", c // 2)
        spec[f"{b}.conv0.1.0.weight"] = ("conv", 3, 3, c // 2, c)
        spec[f"{b}.conv0.1.0.bias"] = ("bias", c)
        for j in range(8):
            spec[f"{b}.convblock.{j}.conv.weight"] = ("conv", 3, 3, c, c)
            spec[f"{b}.convblock.{j}.conv.bias"] = ("bias", c)
            spec[f"{b}.convblock.{j}.beta"] = ("ones", (c,))
        spec[f"{b}.lastconv.0.weight"] = ("convT", 4, 4, c, 4 * 13)
        spec[f"{b}.lastconv.0.bias"] = ("bias", 4 * 13)
    return spec


IFNET_SPEC = build_spec()


def ifnet_encode(p: Params, img: torch.Tensor) -> torch.Tensor:
    """Head feature encoder (IFNet_HDv3.py:37-47)."""
    x = conv2d(p, "encode.cnn0", img, stride=2, padding=1)
    x = conv2d(p, "encode.cnn1", leaky_relu(x), stride=1, padding=1)
    x = conv2d(p, "encode.cnn2", leaky_relu(x), stride=1, padding=1)
    return conv_transpose2d(p, "encode.cnn3", leaky_relu(x), stride=2, padding=1)


def pack_resconv_weights(p: Params) -> Params:
    """``p`` plus every ResConv weight packed for the conv kernel of its
    dtype (ops/conv_chain.pack_step_weights: split for f32) under
    ``{b}.convblock.{j}.conv.wp``: built once, where a model builds its
    parameters, from the weights in the compute dtype."""
    out = dict(p)
    for i in range(len(BLOCK_CHANNELS)):
        for j in range(8):
            name = f"block{i}.convblock.{j}.conv"
            out[f"{name}.wp"] = pack_step_weights(p[f"{name}.weight"])
    return out


def _resconv_steps(p: Params, b: str, dtype: torch.dtype) -> tuple[ChainStep, ...]:
    """The 8 ResConvs ``leaky(conv(x) * beta + x)`` of block ``b``
    (IFNet_HDv3.py:12-20,71) as ChainSteps in ``dtype``, on the weights
    ``pack_resconv_weights`` packed, as packed (the kernel refuses a layout
    packed for another dtype)."""
    return tuple(ChainStep(w=p[f"{b}.convblock.{j}.conv.weight"].to(dtype),
                           b=p[f"{b}.convblock.{j}.conv.bias"].to(dtype),
                           beta=p[f"{b}.convblock.{j}.beta"].to(dtype),
                           wp=p[f"{b}.convblock.{j}.conv.wp"])
                 for j in range(8))


def ifnet_block(p: Params, idx: int, x: torch.Tensor, flow: torch.Tensor | None,
                scale: float, x_at_scale: bool = False,
                out_size: tuple[int, int] | None = None, conv_backend: str = "auto"):
    """One IFBlock at pyramid scale ``scale`` (IFNet_HDv3.py:84-96).

    ``x_at_scale=True`` means ``x`` is already at the block's working
    resolution; ``out_size`` then gives the full resolution to return to.
    ``p`` holds the packed ResConv weights (``pack_resconv_weights``).
    Returns (flow (N,H,W,4), mask (N,H,W,1), feat (N,H,W,8)).
    """
    b = f"block{idx}"
    if x_at_scale:
        hs, ws = x.shape[1], x.shape[2]
        h, w = out_size
    else:
        h, w = x.shape[1], x.shape[2]
        hs, ws = int(h / scale), int(w / scale)
        x = resize_bilinear(x, (hs, ws))
    if flow is not None:
        flow = resize_bilinear(flow, (hs, ws)) * (1.0 / scale)
        x = torch.cat([x, flow], dim=-1)

    feat = leaky_relu(conv2d(p, f"{b}.conv0.0.0", x, stride=2, padding=1))
    feat = leaky_relu(conv2d(p, f"{b}.conv0.1.0", feat, stride=2, padding=1))
    feat = conv_chain(feat, _resconv_steps(p, b, feat.dtype), backend=conv_backend)
    tmp = conv_transpose2d(p, f"{b}.lastconv.0", feat, stride=2, padding=1)
    tmp = resize_bilinear(pixel_shuffle(tmp, 2), (h, w))
    return tmp[..., :4] * scale, tmp[..., 4:5], tmp[..., 5:]


def _integer_scale(sc: float, h: int, w: int) -> int | None:
    if float(sc).is_integer() and sc >= 2 and h % int(sc) == 0 and w % int(sc) == 0:
        return int(sc)
    return None


def ifnet_apply(p: Params, img0: torch.Tensor, img1: torch.Tensor, timestep: torch.Tensor,
                scale_list: tuple[float, ...], f0: torch.Tensor | None = None,
                f1: torch.Tensor | None = None, warp_backend: str = "auto",
                conv_backend: str = "auto"):
    """Full 5-stage inference (IFNet_HDv3.py:126-177).

    ``timestep`` is an (N,H,W,1) map; ``p`` holds the packed ResConv weights
    (``pack_resconv_weights``). Returns (merged_frame, flow_list).
    """
    if f0 is None:
        f0 = ifnet_encode(p, img0[..., :3])
    if f1 is None:
        f1 = ifnet_encode(p, img1[..., :3])

    h, w = img0.shape[1], img0.shape[2]
    n = img0.shape[0]
    flow = mask = feat = None
    flow_list = []
    # image + encoder features of each direction, warped at every stage
    a = torch.cat([img0[..., :3], f0], dim=-1)
    bimg = torch.cat([img1[..., :3], f1], dim=-1)
    for i in range(5):
        sc = scale_list[i]
        if flow is None:
            x = torch.cat([img0[..., :3], img1[..., :3], f0, f1, timestep], dim=-1)
            flow, mask, feat = ifnet_block(p, i, x, None, sc, conv_backend=conv_backend)
            flow_list.append(flow)
            continue
        k = _integer_scale(sc, h, w)
        if k is not None and k % 2 == 0:
            # both directions through one tap-grid warp at the block resolution
            both = backwarp2(a, bimg, flow, k, backend=warp_backend)
            w0, w1 = both[:n], both[n:]
            rest = resize_bilinear(torch.cat([timestep, mask, feat], dim=-1), (h // k, w // k))
            x = torch.cat([w0[..., :3], w1[..., :3], w0[..., 3:], w1[..., 3:], rest], dim=-1)
            fd, mask, feat = ifnet_block(p, i, x, flow, sc, x_at_scale=True, out_size=(h, w),
                                         conv_backend=conv_backend)
        else:
            both = backwarp2(a, bimg, flow, backend=warp_backend)
            wf0, wf1 = both[:n], both[n:]
            x = torch.cat([wf0[..., :3], wf1[..., :3], wf0[..., 3:], wf1[..., 3:], timestep,
                           mask, feat], dim=-1)
            fd, mask, feat = ifnet_block(p, i, x, flow, sc, conv_backend=conv_backend)
        flow = flow + fd
        flow_list.append(flow)

    both = backwarp2(img0, img1, flow, backend=warp_backend)
    warped0, warped1 = both[:n], both[n:]
    m = torch.sigmoid(mask.float()).to(img0.dtype)
    return warped0 * m + warped1 * (1 - m), flow_list
