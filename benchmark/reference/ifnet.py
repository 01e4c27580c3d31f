"""IFNet 4.26-heavy, plain PyTorch, NHWC (frozen reference; RIFE's flow and
fusion network, Practical-RIFE ``IFNet_HDv3.py``).

Encoder: three convs and a transposed conv, 16 channels. Five IFBlocks
(c = 192/128/96/64/32): two stride-2 convs, eight ResConvs
``leaky(conv(x) * beta + x)``, then ConvTranspose2d(4, s2) + PixelShuffle(2).
Per stage both directions' images and features are backward-warped; at an
even integer pyramid scale k the warp is evaluated at the k-fold
downsample's taps, which equals warping at full resolution and then
downsampling. A sigmoid mask merges the two final warps.
"""

from __future__ import annotations

import torch

from benchmark.reference.nn import (Params, backwarp2, conv2d, conv_transpose2d, leaky_relu,
                                    pixel_shuffle, resize)

BLOCK_CHANNELS = (192, 128, 96, 64, 32)
BLOCK_IN = (7 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32)


def spec() -> dict:
    """{state-dict key: (kind, *dims)}; conv dims (kh, kw, in, out)."""
    s = {}
    for name, kind, k, cin, cout in (("encode.cnn0", "conv", 3, 3, 16),
                                     ("encode.cnn1", "conv", 3, 16, 16),
                                     ("encode.cnn2", "conv", 3, 16, 16),
                                     ("encode.cnn3", "convT", 4, 16, 16)):
        s[f"{name}.weight"] = (kind, k, k, cin, cout)
        s[f"{name}.bias"] = ("bias", cout)
    for i, (cin, c) in enumerate(zip(BLOCK_IN, BLOCK_CHANNELS)):
        b = f"block{i}"
        s[f"{b}.conv0.0.0.weight"] = ("conv", 3, 3, cin, c // 2)
        s[f"{b}.conv0.0.0.bias"] = ("bias", c // 2)
        s[f"{b}.conv0.1.0.weight"] = ("conv", 3, 3, c // 2, c)
        s[f"{b}.conv0.1.0.bias"] = ("bias", c)
        for j in range(8):
            s[f"{b}.convblock.{j}.conv.weight"] = ("conv", 3, 3, c, c)
            s[f"{b}.convblock.{j}.conv.bias"] = ("bias", c)
            s[f"{b}.convblock.{j}.beta"] = ("ones", c)
        s[f"{b}.lastconv.0.weight"] = ("convT", 4, 4, c, 4 * 13)
        s[f"{b}.lastconv.0.bias"] = ("bias", 4 * 13)
    return s


def encode(p: Params, img: torch.Tensor) -> torch.Tensor:
    x = conv2d(p, "encode.cnn0", img, stride=2, padding=1)
    x = conv2d(p, "encode.cnn1", leaky_relu(x), padding=1)
    x = conv2d(p, "encode.cnn2", leaky_relu(x), padding=1)
    return conv_transpose2d(p, "encode.cnn3", leaky_relu(x))


def block(p: Params, idx: int, x: torch.Tensor, flow, scale: float, x_at_scale: bool = False,
          out_size=None):
    """One IFBlock -> (flow (N,H,W,4), mask (N,H,W,1), feat (N,H,W,8))."""
    b = f"block{idx}"
    if x_at_scale:
        hs, ws = x.shape[1], x.shape[2]
        h, w = out_size
    else:
        h, w = x.shape[1], x.shape[2]
        hs, ws = int(h / scale), int(w / scale)
        x = resize(x, (hs, ws))
    if flow is not None:
        x = torch.cat([x, resize(flow, (hs, ws)) * (1.0 / scale)], dim=-1)
    feat = leaky_relu(conv2d(p, f"{b}.conv0.0.0", x, stride=2, padding=1))
    feat = leaky_relu(conv2d(p, f"{b}.conv0.1.0", feat, stride=2, padding=1))
    for j in range(8):
        name = f"{b}.convblock.{j}"
        y = conv2d(p, f"{name}.conv", feat, padding=1)
        feat = leaky_relu(y * p[f"{name}.beta"].to(feat.dtype) + feat)
    tmp = conv_transpose2d(p, f"{b}.lastconv.0", feat)
    tmp = resize(pixel_shuffle(tmp, 2), (h, w))
    return tmp[..., :4] * scale, tmp[..., 4:5], tmp[..., 5:]


def _integer_scale(sc: float, h: int, w: int):
    if float(sc).is_integer() and sc >= 2 and h % int(sc) == 0 and w % int(sc) == 0:
        return int(sc)
    return None


def apply(p: Params, img0, img1, timestep, scale_list, f0=None, f1=None):
    """The five stages and the merge -> the (N, H, W, 3) frame; ``timestep``
    an (N, H, W, 1) map."""
    f0 = encode(p, img0[..., :3]) if f0 is None else f0
    f1 = encode(p, img1[..., :3]) if f1 is None else f1
    n, h, w = img0.shape[0], img0.shape[1], img0.shape[2]
    flow = mask = feat = None
    a = torch.cat([img0[..., :3], f0], dim=-1)
    bimg = torch.cat([img1[..., :3], f1], dim=-1)
    for i in range(5):
        sc = scale_list[i]
        if flow is None:
            x = torch.cat([img0[..., :3], img1[..., :3], f0, f1, timestep], dim=-1)
            flow, mask, feat = block(p, i, x, None, sc)
            continue
        k = _integer_scale(sc, h, w)
        if k is not None and k % 2 == 0:
            both = backwarp2(a, bimg, flow, k)
            w0, w1 = both[:n], both[n:]
            rest = resize(torch.cat([timestep, mask, feat], dim=-1), (h // k, w // k))
            x = torch.cat([w0[..., :3], w1[..., :3], w0[..., 3:], w1[..., 3:], rest], dim=-1)
            fd, mask, feat = block(p, i, x, flow, sc, x_at_scale=True, out_size=(h, w))
        else:
            both = backwarp2(a, bimg, flow)
            wf0, wf1 = both[:n], both[n:]
            x = torch.cat([wf0[..., :3], wf1[..., :3], wf0[..., 3:], wf1[..., 3:], timestep,
                           mask, feat], dim=-1)
            fd, mask, feat = block(p, i, x, flow, sc)
        flow = flow + fd
    both = backwarp2(img0, img1, flow)
    m = torch.sigmoid(mask.float()).to(img0.dtype)
    return both[:n] * m + both[n:] * (1 - m)
