"""GMFSS model core: reuse (flow, metric, features) and splat-and-fuse
inference (counterpart of drba_tpu/models/gmfss_core.py), for the quality
path (model_gmfss/GMFSS.py) and the union path (model_gmfss_union/GMFSS.py).

Both flow directions come from one bidirectional GMFlow pass; the three
pyramid levels of both directions are forward-splatted by the exact splat
(the hand-written kernel on a CUDA tensor), metric-weighted ('soft').
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from drba_tpu_torch.models.gmflow_net import gmflow_apply
from drba_tpu_torch.models.gmfss_nets import featurenet_apply, gridnet_apply, metricnet_apply
from drba_tpu_torch.ops import softsplat
from drba_tpu_torch.ops.resize import resize_bilinear, scale_by


class GmfssParams(NamedTuple):
    flownet: dict
    metricnet: dict
    feat_ext: dict
    fusionnet: dict


class Reuse(NamedTuple):
    """reuse() outputs (GMFSS.py:58-81): flows, metrics, feature pyramids."""

    flow01: torch.Tensor
    flow10: torch.Tensor
    metric0: torch.Tensor
    metric1: torch.Tensor
    feat0: tuple
    feat1: tuple

    def swapped(self) -> "Reuse":
        """The reverse direction, for chaining windows."""
        return Reuse(self.flow10, self.flow01, self.metric1, self.metric0, self.feat1,
                     self.feat0)


def gmfss_reuse(p: GmfssParams, img0, img1, scale: float, feat0=None, union: bool = False,
                warp_backend: str = "auto", attn_backend: str = "auto",
                conv_backend: str = "auto") -> Reuse:
    """Flows, metrics and feature pyramids of a frame pair (GMFSS.py:58-81).

    ``feat0`` may pass img0's feature pyramid from the previous window's
    chained reuse, which saves one FeatureNet pass. ``scale`` < 1 runs GMFlow
    on a downscaled half-resolution pair and rescales its flows. ``union``
    takes the union MetricNet's bounded metrics. ``conv_backend`` runs
    FeatureNet's and MetricNet's conv chains.
    """
    if feat0 is None:
        feat0 = featurenet_apply(p.feat_ext, img0, conv_backend)
    feat1 = featurenet_apply(p.feat_ext, img1, conv_backend)
    img0h, img1h = scale_by(img0, 0.5), scale_by(img1, 0.5)
    if scale != 1.0:
        imgf0, imgf1 = scale_by(img0h, scale), scale_by(img1h, scale)
    else:
        imgf0, imgf1 = img0h, img1h

    flows = gmflow_apply(p.flownet, imgf0, imgf1, pred_bidir=True, attn_backend=attn_backend,
                         warp_backend=warp_backend)
    b = imgf0.shape[0]
    flow01, flow10 = flows[:b], flows[b:]
    if scale != 1.0:
        size = (img0h.shape[1], img0h.shape[2])
        flow01 = resize_bilinear(flow01, size) / scale
        flow10 = resize_bilinear(flow10, size) / scale
    metric0, metric1 = metricnet_apply(p.metricnet, img0h, img1h, flow01, flow10, union=union,
                                       warp_backend=warp_backend, conv_backend=conv_backend)
    return Reuse(flow01, flow10, metric0, metric1, feat0, feat1)


def _warp_pyramid2(img0h, img1h, feats0, feats1, Ft0, Ft1, Zt0, Zt1, extra0=None,
                   extra1=None, backend="auto"):
    """Soft-splat both directions' half-resolution image and 3-level feature
    pyramid along the scaled flows (GMFSS.py:95-115). The image, level-1
    features and any ``extra`` channels (the union path's timestep maps)
    share (Ft, Zt) and splat in one call, both directions stacked on the
    batch axis: one splat per level, the coverage from the level-0 call. The
    flow and metric are resized (and the flow rescaled) to each level.

    Returns ((I1t, feats1w, extra0w, cov0), (I2t, feats2w, extra1w, cov1));
    the ``extra`` results are None without ``extra`` channels.
    """
    n = img0h.shape[0]
    c_img, c_f1 = img0h.shape[-1], feats0[0].shape[-1]

    def pack(img, f1, extra):
        return torch.cat([img, f1] if extra is None else [img, f1, extra], dim=-1)

    both = torch.cat([pack(img0h, feats0[0], extra0), pack(img1h, feats1[0], extra1)], dim=0)
    Ft = torch.cat([Ft0, Ft1], dim=0)
    Zt = torch.cat([Zt0, Zt1], dim=0)
    w1, cov = softsplat(both, Ft, Zt, "soft", backend=backend, return_coverage=True)

    levels = [w1[..., c_img:c_img + c_f1]]
    for lvl, fscale in ((1, 0.5), (2, 0.25)):
        size = (feats0[lvl].shape[1], feats0[lvl].shape[2])
        levels.append(softsplat(torch.cat([feats0[lvl], feats1[lvl]], dim=0),
                                resize_bilinear(Ft, size) * fscale, resize_bilinear(Zt, size),
                                "soft", backend=backend))

    def unpack(d):
        sl = slice(d * n, (d + 1) * n)
        extra = None if extra0 is None else w1[sl, ..., c_img + c_f1:]
        return w1[sl, ..., :c_img], tuple(f[sl] for f in levels), extra, cov[sl]

    return unpack(0), unpack(1)


def gmfss_inference(p: GmfssParams, img0, img1, reuse: Reuse, timestep0, timestep1,
                    backend: str = "auto", conv_backend: str = "auto"):
    """Model.inference (model_gmfss/GMFSS.py:83-190): splat both frames'
    images and features to the timestep, fuse with GridNet (its conv chains
    on ``conv_backend``). ``timestep0`` / ``timestep1`` are per-pixel maps
    (N, H/2, W/2, 1) or broadcastable."""
    F1t = timestep0 * reuse.flow01
    F2t = timestep1 * reuse.flow10
    Z1t = timestep0 * reuse.metric0
    Z2t = timestep1 * reuse.metric1
    img0h, img1h = scale_by(img0, 0.5), scale_by(img1, 0.5)
    (I1t, f1, _, _), (I2t, f2, _, _) = _warp_pyramid2(img0h, img1h, reuse.feat0, reuse.feat1,
                                                      F1t, F2t, Z1t, Z2t, backend=backend)
    out = gridnet_apply(p.fusionnet, torch.cat([img0h, I1t, I2t, img1h], dim=-1),
                        torch.cat([f1[0], f2[0]], dim=-1), torch.cat([f1[1], f2[1]], dim=-1),
                        torch.cat([f1[2], f2[2]], dim=-1), conv_backend=conv_backend)
    return out.clamp(0.0, 1.0)


def gmfss_union_inference(p: GmfssParams, img0, img1, reuse: Reuse, timestep0, timestep1, rife,
                          enable_mask: bool = True, backend: str = "auto",
                          conv_backend: str = "auto"):
    """Union Model.inference (model_gmfss_union/GMFSS.py:80-155): GridNet fuses
    cat(I1t, rife, I2t), ``rife`` being the auxiliary RIFE's half-resolution
    frame. With per-pixel timestep maps and ``enable_mask``, the maps are
    splatted with the image (C = 3 + 64 + 1), filled with 1 where either
    direction's coverage is < 0.999, and wherever one direction's warped
    timestep exceeds the other's by more than 25x, that direction's image and
    features are replaced by the other's, at all three levels
    (GMFSS.py:114-150). ``conv_backend``: as ``gmfss_inference``.
    """
    F1t = timestep0 * reuse.flow01
    F2t = timestep1 * reuse.flow10
    Z1t = timestep0 * reuse.metric0
    Z2t = timestep1 * reuse.metric1
    img0h, img1h = scale_by(img0, 0.5), scale_by(img1, 0.5)
    is_map = enable_mask and isinstance(timestep0, torch.Tensor) and timestep0.dim() == 4
    (I1t, f1, w_t0, cov0), (I2t, f2, w_t1, cov1) = _warp_pyramid2(
        img0h, img1h, reuse.feat0, reuse.feat1, F1t, F2t, Z1t, Z2t,
        extra0=timestep0 if is_map else None, extra1=timestep1 if is_map else None,
        backend=backend)
    f1, f2 = list(f1), list(f2)

    if is_map:
        invalid = (cov0 < 0.999) | (cov1 < 0.999)
        w_t0 = torch.where(invalid, 1.0, w_t0)
        w_t1 = torch.where(invalid, 1.0, w_t1)
        for lvl, scale in enumerate((1.0, 0.5, 0.25)):
            t0, t1 = w_t0, w_t1
            if scale != 1.0:
                t0, t1 = scale_by(t0, scale), scale_by(t1, scale)
            m0, m1 = t0 / t1 > 25.0, t1 / t0 > 25.0
            if lvl == 0:
                I1t, I2t = torch.where(m0, I2t, I1t), torch.where(m1, I1t, I2t)
            f1[lvl], f2[lvl] = torch.where(m0, f2[lvl], f1[lvl]), torch.where(m1, f1[lvl], f2[lvl])

    out = gridnet_apply(p.fusionnet, torch.cat([I1t, rife, I2t], dim=-1),
                        torch.cat([f1[0], f2[0]], dim=-1), torch.cat([f1[1], f2[1]], dim=-1),
                        torch.cat([f1[2], f2[2]], dim=-1), union=True,
                        conv_backend=conv_backend)
    return out.clamp(0.0, 1.0)
