"""GMFSS_UNION's nets and calls, plain PyTorch, NHWC (frozen reference;
GMFSS_Fortuna ``model_gmfss_union`` as DRBA's ``models/gmfss_union.py``
drives it).

* FeatureNet: a three-level pyramid (1/2, 1/4, 1/8; 64/128/192 channels);
* MetricNet (union): the splat metric of each direction from the photometric
  and flow-consistency errors, bounded by ``tanh * 10``;
* GridNet (union): the 3 x 6 lattice of PReLU-conv blocks fusing the two
  splatted frames and the auxiliary RIFE frame with the splatted pyramids,
  then a pixel-shuffle tail to full resolution;
* :func:`reuse`: a pair's flows (GMFlow at half resolution, resized by
  the flow scale), metrics and pyramids; :func:`window` and
  :func:`plain`: the DRM window and plain interpolation, with IFNet
  4.26-heavy at half resolution as the auxiliary RIFE.

Frames are (1, H, W, 3); a window's T timesteps are folded into the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import drm, gmflow, ifnet
from benchmark.reference.nn import (Params, backwarp, conv2d, conv_transpose2d, flow_distance,
                                    pixel_shuffle, prelu, resize, scale_by, softsplat)


class Nets(NamedTuple):
    flownet: dict
    metricnet: dict
    feat_ext: dict
    fusionnet: dict
    rife: dict


# checkpoint file of each net in ``train_log_gmfss_union``
FILES = {"flownet": "flownet.pkl", "metricnet": "metric.pkl", "feat_ext": "feat.pkl",
         "fusionnet": "fusionnet.pkl", "rife": "rife.pkl"}


class Reuse(NamedTuple):
    flow01: torch.Tensor
    flow10: torch.Tensor
    metric0: torch.Tensor
    metric1: torch.Tensor
    feat0: tuple
    feat1: tuple

    def swapped(self) -> "Reuse":
        return Reuse(self.flow10, self.flow01, self.metric1, self.metric0, self.feat1, self.feat0)


def _seq_spec(s, prefix, cin, cout, transpose=False):
    s[f"{prefix}.0.weight"] = ("scalar",)
    s[f"{prefix}.1.weight"] = ("convT", 4, 4, cin, cout) if transpose else ("conv", 3, 3, cin, cout)
    s[f"{prefix}.1.bias"] = ("bias", cout)
    s[f"{prefix}.2.weight"] = ("scalar",)
    s[f"{prefix}.3.weight"] = ("conv", 3, 3, cout, cout)
    s[f"{prefix}.3.bias"] = ("bias", cout)


def metricnet_spec() -> dict:
    s = {"metric_in.weight": ("conv", 3, 3, 14, 64), "metric_in.bias": ("bias", 64)}
    for i in (1, 2, 3):
        s[f"metric_net{i}.0.weight"] = ("scalar",)
        s[f"metric_net{i}.1.weight"] = ("conv", 3, 3, 64, 64)
        s[f"metric_net{i}.1.bias"] = ("bias", 64)
    s["metric_out.0.weight"] = ("scalar",)
    s["metric_out.1.weight"] = ("conv", 3, 3, 64, 2)
    s["metric_out.1.bias"] = ("bias", 2)
    return s


def featurenet_spec() -> dict:
    s = {}
    for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 192)), start=1):
        s[f"block{i}.0.weight"] = ("scalar",)
        s[f"block{i}.1.weight"] = ("conv", 3, 3, cin, cout)
        s[f"block{i}.1.bias"] = ("bias", cout)
        s[f"block{i}.2.weight"] = ("scalar",)
        s[f"block{i}.3.weight"] = ("conv", 3, 3, cout, cout)
        s[f"block{i}.3.bias"] = ("bias", cout)
    return s


def gridnet_spec() -> dict:
    s = {}
    _seq_spec(s, "residual_model_head0", 9, 64)
    _seq_spec(s, "residual_model_head1", 128, 64)
    _seq_spec(s, "residual_model_head2", 256, 128)
    _seq_spec(s, "residual_model_head3", 384, 192)
    for r, c in (("01", 64), ("04", 64), ("05", 64), ("11", 128), ("14", 128), ("15", 128),
                 ("21", 192), ("24", 192), ("25", 192)):
        _seq_spec(s, f"residual_model_{r}", c, c)
    for d, cin, cout in (("10", 64, 128), ("11", 64, 128), ("20", 128, 192), ("21", 128, 192)):
        _seq_spec(s, f"downsample_model_{d}", cin, cout)
    for u, cin, cout in (("04", 128, 64), ("05", 128, 64), ("14", 192, 128), ("15", 192, 128)):
        _seq_spec(s, f"upsample_model_{u}", cin, cout, transpose=True)
    s["residual_model_tail.conv_before_upsample.0.weight"] = ("conv", 3, 3, 64, 64)
    s["residual_model_tail.conv_before_upsample.0.bias"] = ("bias", 64)
    s["residual_model_tail.conv_before_upsample.1.weight"] = ("scalar",)
    s["residual_model_tail.upsample.0.weight"] = ("conv", 3, 3, 64, 256)
    s["residual_model_tail.upsample.0.bias"] = ("bias", 256)
    s["residual_model_tail.conv_last.weight"] = ("conv", 3, 3, 64, 3)
    s["residual_model_tail.conv_last.bias"] = ("bias", 3)
    return s


def specs() -> dict:
    """{net: spec} of the five nets, in ``Nets`` order."""
    return {"flownet": gmflow.spec(), "metricnet": metricnet_spec(),
            "feat_ext": featurenet_spec(), "fusionnet": gridnet_spec(), "rife": ifnet.spec()}


def featurenet(p: Params, x):
    outs = []
    for i in (1, 2, 3):
        x = conv2d(p, f"block{i}.1", prelu(p, f"block{i}.0", x), stride=2, padding=1)
        x = conv2d(p, f"block{i}.3", prelu(p, f"block{i}.2", x), padding=1)
        outs.append(x)
    return tuple(outs)


def metricnet(p: Params, img0, img1, flow01, flow10):
    """(metric0, metric1), each (N, H, W, 1) in (-10, 10)."""
    n = img0.shape[0]
    pk1 = torch.cat([img1, flow10.to(img1.dtype)], dim=-1)
    pk0 = torch.cat([img0, flow01.to(img0.dtype)], dim=-1)
    warped = backwarp(torch.cat([pk1, pk0], dim=0), torch.cat([flow01, flow10], dim=0),
                      zeros=True)
    w1p, w0p = warped[:n], warped[n:]
    m0 = (img0 - w1p[..., :3]).abs().mean(dim=-1, keepdim=True)
    m1 = (img1 - w0p[..., :3]).abs().mean(dim=-1, keepdim=True)
    mag = flow_distance(flow01).float() + flow_distance(flow10).float()
    diff_fwd = flow_distance(flow01 + w1p[..., 3:5].to(flow01.dtype)).float()
    diff_bwd = flow_distance(flow10 + w0p[..., 3:5].to(flow10.dtype)).float()
    thresh = 0.01 * mag + 0.5
    h, w = flow01.shape[1], flow01.shape[2]

    def norm(f):
        return torch.cat([f[..., 0:1] / ((w - 1.0) / 2.0), f[..., 1:2] / ((h - 1.0) / 2.0)], dim=-1)

    x = torch.cat([img0, img1, -m0, -m1, norm(flow01), norm(flow10),
                   (diff_fwd > thresh).to(flow01.dtype), (diff_bwd > thresh).to(flow10.dtype)],
                  dim=-1)
    x = conv2d(p, "metric_in", x, padding=1)
    for i in (1, 2, 3):
        x = conv2d(p, f"metric_net{i}.1", prelu(p, f"metric_net{i}.0", x), padding=1) + x
    out = conv2d(p, "metric_out.1", prelu(p, "metric_out.0", x), padding=1)
    out = torch.tanh(out.float()).to(out.dtype) * 10
    return out[..., 0:1], out[..., 1:2]


def _block(p, prefix, x, stride=1, transpose=False):
    """PReLU, conv (stride 2 or transposed), PReLU, conv."""
    a = prelu(p, f"{prefix}.0", x)
    if transpose:
        y = conv_transpose2d(p, f"{prefix}.1", a)
    else:
        y = conv2d(p, f"{prefix}.1", a, stride=stride, padding=1)
    return conv2d(p, f"{prefix}.3", prelu(p, f"{prefix}.2", y), padding=1)


def gridnet(p: Params, x, x1, x2, x3):
    """The lattice (FusionNet.py): each node the sum of its row and column
    inputs, in the reference's order of terms."""
    def res(name, t):
        return _block(p, f"residual_model_{name}", t) + t

    def down(name, t):
        return _block(p, f"downsample_model_{name}", t, stride=2)

    def up(name, t):
        return _block(p, f"upsample_model_{name}", t, transpose=True)

    X00 = _block(p, "residual_model_head0", x) + _block(p, "residual_model_head1", x1)
    X01 = res("01", X00)
    X10 = _block(p, "residual_model_head2", x2) + down("10", X00)
    X11 = res("11", X10) + down("11", X01)
    X20 = _block(p, "residual_model_head3", x3) + down("20", X10)
    X21 = res("21", X20) + down("21", X11)
    X24 = res("24", X21)
    X25 = res("25", X24)
    X14 = res("14", X11) + up("14", X24)
    X04 = res("04", X01) + up("04", X14)
    X15 = res("15", X14) + up("15", X25)
    X05 = res("05", X04) + up("05", X15)
    t = prelu(p, "residual_model_tail.conv_before_upsample.1",
              conv2d(p, "residual_model_tail.conv_before_upsample.0", X05, padding=1))
    t = pixel_shuffle(conv2d(p, "residual_model_tail.upsample.0", t, padding=1), 2)
    return conv2d(p, "residual_model_tail.conv_last", t, padding=1)


def reuse(nets: Nets, img0, img1, feat0=None, scale: float = 1.0) -> Reuse:
    """Flows, metrics and feature pyramids of (img0, img1). The flow
    ``scale`` (``-scale``) runs GMFlow on the half-resolution pair resized
    by it, then resizes both flows back and divides them by it
    (``model_gmfss_union/GMFSS.py`` reuse); MetricNet and FeatureNet take
    their inputs as at ``scale`` 1."""
    feat0 = featurenet(nets.feat_ext, img0) if feat0 is None else feat0
    feat1 = featurenet(nets.feat_ext, img1)
    img0h, img1h = scale_by(img0, 0.5), scale_by(img1, 0.5)
    if scale != 1.0:
        flows = gmflow.apply(nets.flownet, scale_by(img0h, scale), scale_by(img1h, scale))
        flows = resize(flows, img0h.shape[1:3]) / scale
    else:
        flows = gmflow.apply(nets.flownet, img0h, img1h)
    b = img0h.shape[0]
    flow01, flow10 = flows[:b], flows[b:]
    metric0, metric1 = metricnet(nets.metricnet, img0h, img1h, flow01, flow10)
    return Reuse(flow01, flow10, metric0, metric1, feat0, feat1)


def _splat_pyramid(img0h, img1h, r: Reuse, F1t, F2t, Z1t, Z2t, extra0, extra1):
    """Soft-splat both directions' half-resolution image, level-1 features
    and ``extra`` channels in one call, and levels 2 and 3 each in one,
    along the flows resized and rescaled to each level."""
    n = img0h.shape[0]
    ci, cf = img0h.shape[-1], r.feat0[0].shape[-1]

    def pack(img, f, extra):
        return torch.cat([img, f] if extra is None else [img, f, extra], dim=-1)

    both = torch.cat([pack(img0h, r.feat0[0], extra0), pack(img1h, r.feat1[0], extra1)], dim=0)
    Ft = torch.cat([F1t, F2t], dim=0)
    Zt = torch.cat([Z1t, Z2t], dim=0)
    w1, cov = softsplat(both, Ft, Zt, "soft", coverage=True)
    levels = [w1[..., ci:ci + cf]]
    for lvl, fscale in ((1, 0.5), (2, 0.25)):
        size = r.feat0[lvl].shape[1:3]
        levels.append(softsplat(torch.cat([r.feat0[lvl], r.feat1[lvl]], dim=0),
                                resize(Ft, size) * fscale, resize(Zt, size), "soft"))

    def unpack(d):
        sl = slice(d * n, (d + 1) * n)
        extra = None if extra0 is None else w1[sl, ..., ci + cf:]
        return w1[sl, ..., :ci], [f[sl] for f in levels], extra, cov[sl]

    return unpack(0), unpack(1)


def union_inference(p: Params, img0, img1, r: Reuse, t0, t1, rife, mask: bool):
    """Splat both frames to the timestep and fuse with the auxiliary RIFE
    frame; with ``mask`` (per-pixel DRM timesteps) the timesteps are splatted
    too, filled with 1 where either coverage is below 0.999, and where one
    direction's exceeds the other's by 25x its image and features take the
    other's, at all three levels."""
    F1t, F2t = t0 * r.flow01, t1 * r.flow10
    Z1t, Z2t = t0 * r.metric0, t1 * r.metric1
    img0h, img1h = scale_by(img0, 0.5), scale_by(img1, 0.5)
    (I1t, f1, w_t0, cov0), (I2t, f2, w_t1, cov1) = _splat_pyramid(
        img0h, img1h, r, F1t, F2t, Z1t, Z2t, t0 if mask else None, t1 if mask else None)
    if mask:
        invalid = (cov0 < 0.999) | (cov1 < 0.999)
        w_t0 = torch.where(invalid, 1.0, w_t0)
        w_t1 = torch.where(invalid, 1.0, w_t1)
        for lvl, scale in enumerate((1.0, 0.5, 0.25)):
            a, b = w_t0, w_t1
            if scale != 1.0:
                a, b = scale_by(a, scale), scale_by(b, scale)
            m0, m1 = a / b > 25.0, b / a > 25.0
            if lvl == 0:
                I1t, I2t = torch.where(m0, I2t, I1t), torch.where(m1, I1t, I2t)
            f1[lvl], f2[lvl] = torch.where(m0, f2[lvl], f1[lvl]), torch.where(m1, f1[lvl], f2[lvl])
    out = gridnet(p, torch.cat([I1t, rife, I2t], dim=-1), torch.cat([f1[0], f2[0]], dim=-1),
                  torch.cat([f1[1], f2[1]], dim=-1), torch.cat([f1[2], f2[2]], dim=-1))
    return out.clamp(0.0, 1.0)


def _tile(x, T):
    return x.expand((T,) + tuple(x.shape[1:]))


def _tile_reuse(r: Reuse, T) -> Reuse:
    return Reuse(*(_tile(x, T) for x in r[:4]), tuple(_tile(x, T) for x in r.feat0),
                 tuple(_tile(x, T) for x in r.feat1))


def _select(left, a: Reuse, b: Reuse) -> Reuse:
    def sel(x, y):
        return torch.where(left, x, y)

    return Reuse(*(sel(x, y) for x, y in zip(a[:4], b[:4])), tuple(map(sel, a.feat0, b.feat0)),
                 tuple(map(sel, a.feat1, b.feat1)))


def select_integer(out, ts, *frames):
    """out (T, H, W, 3): where ts == k, frames[k]."""
    tb = ts[:, None, None, None]
    for k in range(len(frames) - 1, -1, -1):
        out = torch.where(tb == k, frames[k], out)
    return out


def _rife_half(nets: Nets, a, b, tmap, scale: float):
    return ifnet.apply(nets.rife, a, b, tmap, tuple(s / scale for s in (16.0, 8.0, 4.0, 2.0, 1.0)))


def window(nets: Nets, I0, I1, I2, ts, reuse10: Reuse, reuse12: Reuse, scale: float,
           splat_scale: float):
    """The DRM window's frames at ``ts`` -> (T, H, W, 3). ``reuse10``: the
    I1 -> I0 reuse, ``reuse12`` the I1 -> I2 one."""
    T = ts.shape[0]
    tt = torch.where(ts < 1, 1 - ts, ts - 1)
    flow10, flow12 = reuse10.flow01, reuse12.flow01
    m10, m12 = reuse10.metric0, reuse12.metric0
    drm0t_t01, drm1t_t01, drm1t_t12, drm2t_t12 = drm.drm_gmfss(tt, flow10, flow12, m10, m12,
                                                              splat_scale)
    r01, r12 = drm.drm_rife(tt, flow10, flow12, splat_scale, m10, m12)
    left = (ts < 1)[:, None, None, None]
    img_b = torch.where(left, I0, I2)
    t0 = torch.where(left, drm1t_t01, drm1t_t12).to(I1.dtype)
    t1 = torch.where(left, drm0t_t01, drm2t_t12).to(I1.dtype)
    I1s = _tile(scale_by(I1, 0.5), T)
    ts_map = resize(torch.where(left, r01, r12), I1s.shape[1:3]).to(I1s.dtype)
    rife = _rife_half(nets, I1s, scale_by(img_b, 0.5), ts_map, scale)
    out = union_inference(nets.fusionnet, _tile(I1, T), img_b, _select(left, reuse10, reuse12),
                          t0, t1, rife, mask=True)
    return select_integer(out, ts, I0, I1, I2)


def plain(nets: Nets, I0, I1, ts, r: Reuse, scale: float):
    """Plain interpolation at ``ts`` in [0, 1] on the I0 -> I1 reuse -> (T, H, W, 3)."""
    T = ts.shape[0]
    I0s, I1s = _tile(scale_by(I0, 0.5), T), _tile(scale_by(I1, 0.5), T)
    tmap = ts[:, None, None, None].expand(T, I0s.shape[1], I0s.shape[2], 1).to(I0s.dtype)
    rife = _rife_half(nets, I0s, I1s, tmap, scale)
    tcol = ts[:, None, None, None].to(I0.dtype)
    out = union_inference(nets.fusionnet, _tile(I0, T), _tile(I1, T), _tile_reuse(r, T), tcol,
                          1 - tcol, rife, mask=False)
    return select_integer(out, ts, I0, I1)
