"""GMFSS_UNION model wrapper, the high-quality path (counterpart of
drba_tpu/models/gmfss_union.py; reference models/gmfss_union.py:10-100).

GMFSS with the union MetricNet (metrics bounded by ``Tanh * 10``) plus an
auxiliary RIFE: IFNet 4.26-heavy runs at half resolution with the DRM map as
its per-pixel timestep, and its frame is the middle 3 channels of the union
GridNet's 9-channel head (model_gmfss_union/GMFSS.py:152). ``pad_size`` is 128
so that the half-resolution IFNet still sees frames divisible by 64. The
uniform model API and its routing are ``models/base.Model``'s, as for
``models/gmfss.GMFSS``; the T timesteps of a window are folded into the
batch axis.
"""

from __future__ import annotations

import numpy as np
import torch

from drba_tpu_torch.config import DEFAULT, Config, model_device
from drba_tpu_torch.convert import load_network
from drba_tpu_torch.drm import calc_drm_gmfss, calc_drm_rife_auxiliary
from drba_tpu_torch.models.base import Model
from drba_tpu_torch.models.gmflow_net import GMFLOW_SPEC, pack_transformer_weights
from drba_tpu_torch.models.gmfss import (_select_integer_ts, _select_reuse, _tile, _tile_reuse,
                                         pack_chain_sites)
from drba_tpu_torch.models.gmfss_core import (GmfssParams, Reuse, gmfss_reuse,
                                              gmfss_union_inference)
from drba_tpu_torch.models.gmfss_nets import FEATURENET_SPEC, GRIDNET_UNION_SPEC, METRICNET_SPEC
from drba_tpu_torch.models.ifnet import IFNET_SPEC, ifnet_apply, pack_resconv_weights
from drba_tpu_torch.ops.resize import resize_bilinear, scale_by


def _half(x, T):
    """(1, H, W, C) -> (T, H/2, W/2, C): resized once, broadcast over T."""
    return _tile(scale_by(x, 0.5), T)


def _drba_window(p: GmfssParams, rife_params, I0, I1, I2, ts, ts_host, reuse10: Reuse,
                 reuse12: Reuse, scale_list, linear, backend="auto", warp_backend="auto",
                 drm_splat_scale=1.0, conv_backend="auto"):
    """All T timesteps of one window, T folded into the batch axis; returns
    (T, 1, H, W, 3). ``ts_host``: the host values of ``ts``."""
    T = ts.shape[0]
    tt = torch.where(ts < 1, 1 - ts, ts - 1)
    tt_host = np.where(ts_host < 1, 1 - ts_host, ts_host - 1)
    flow10, flow12 = reuse10.flow01, reuse12.flow01
    metric10, metric12 = reuse10.metric0, reuse12.metric0
    drm_g = calc_drm_gmfss(tt, flow10, flow12, metric10, metric12, linear=linear,
                           backend=backend, splat_scale=drm_splat_scale, t_host=tt_host)
    drm_r = calc_drm_rife_auxiliary(tt, flow10, flow12, metric10, metric12, linear=linear,
                                    backend=backend, splat_scale=drm_splat_scale,
                                    t_host=tt_host)
    left = (ts < 1)[:, None, None, None]
    imgB = torch.where(left, I0, I2)
    I1b = _tile(I1, T)
    reuse = _select_reuse(left, reuse10, reuse12)
    t0 = torch.where(left, drm_g.drm1t_t01, drm_g.drm1t_t12).to(I1.dtype)
    t1 = torch.where(left, drm_g.drm0t_t01, drm_g.drm2t_t12).to(I1.dtype)
    drm_rife = torch.where(left, drm_r.drm_t1_t01, drm_r.drm_t1_t12)

    # the auxiliary RIFE at half resolution (models/gmfss_union.py:72-74)
    I1s = _half(I1, T)
    IBs = scale_by(imgB, 0.5)
    ts_map = resize_bilinear(drm_rife, (I1s.shape[1], I1s.shape[2])).to(I1s.dtype)
    rife, _ = ifnet_apply(rife_params, I1s, IBs, ts_map, scale_list, warp_backend=warp_backend,
                          conv_backend=conv_backend)
    out = gmfss_union_inference(p, I1b, imgB, reuse, t0, t1, rife, backend=backend,
                                conv_backend=conv_backend)
    return _select_integer_ts(out, ts, I0, I1, I2)[:, None]


def _ts_batch(p: GmfssParams, rife_params, I0, I1, ts, reuse: Reuse, scale_list,
              backend="auto", warp_backend="auto", conv_backend="auto"):
    """Plain interpolation at T timesteps, T folded into the batch axis; the
    auxiliary RIFE at the plain timesteps, no timestep-swap mask."""
    T = ts.shape[0]
    I0s, I1s = _half(I0, T), _half(I1, T)
    tmap = ts[:, None, None, None].expand(T, I0s.shape[1], I0s.shape[2], 1).to(I0s.dtype)
    rife, _ = ifnet_apply(rife_params, I0s, I1s, tmap, scale_list, warp_backend=warp_backend,
                          conv_backend=conv_backend)
    tcol = ts[:, None, None, None].to(I0.dtype)
    out = gmfss_union_inference(p, _tile(I0, T), _tile(I1, T), _tile_reuse(reuse, T), tcol,
                                1 - tcol, rife, enable_mask=False, backend=backend,
                                conv_backend=conv_backend)
    return _select_integer_ts(out, ts, I0, I1)[:, None]


class GMFSS_UNION(Model):
    """High-quality-path model (reference: models/gmfss_union.py:10-100) on
    ``device`` (CUDA unless the caller asks for another; raises when there is
    none).

    The four GMFSS nets take seeds ``seed + 0..3``, the auxiliary IFNet
    (``rife.pkl``) ``seed + 4``. Parameters are cast to
    ``config.compute_dtype`` once, on the device; GMFlow's transformer
    weights and the IFNet's ResConv weights are packed for their kernels
    once, here, and so are the GMFSS nets' chain sites' conv weights.
    """

    PLAIN_PASS = True
    PARAM_TREES = ("params", "rife_params")

    def __init__(self, weights: str | None = None, scale: float = 1.0,
                 config: Config = DEFAULT, device: str | torch.device = "cuda"):
        self.device = model_device(device)

        def load(fname, spec, i):
            params = load_network(weights, fname, spec, seed=config.seed + i,
                                  strict=config.strict_load)
            return {k: v.to(self.device, config.compute_dtype) for k, v in params.items()}

        self.params = pack_chain_sites(GmfssParams(
            pack_transformer_weights(load("flownet.pkl", GMFLOW_SPEC, 0)),
            load("metric.pkl", METRICNET_SPEC, 1), load("feat.pkl", FEATURENET_SPEC, 2),
            load("fusionnet.pkl", GRIDNET_UNION_SPEC, 3)), union=True)
        self.rife_params = pack_resconv_weights(load("rife.pkl", IFNET_SPEC, 4))
        self.scale = scale
        self.scale_list = tuple(s / scale for s in (16.0, 8.0, 4.0, 2.0, 1.0))
        self.pad_size = 128
        self.config = config

    def _pass(self, img0, img1, feat0=None) -> Reuse:
        return gmfss_reuse(self.params, img0, img1, self.scale, feat0=feat0, union=True,
                           warp_backend=self.config.warp_backend,
                           attn_backend=self.config.attn_backend,
                           conv_backend=self.config.conv_backend)

    def _plain(self, I0, I1, ts, reuse: Reuse):
        return _ts_batch(self.params, self.rife_params, I0, I1, ts, reuse, self.scale_list,
                         backend=self.config.splat_backend,
                         warp_backend=self.config.warp_backend,
                         conv_backend=self.config.conv_backend)

    def _window(self, I0, I1, I2, ts, ts_host, reuse10, reuse21, linear):
        return _drba_window(self.params, self.rife_params, I0, I1, I2, ts, ts_host, reuse10,
                            reuse21.swapped(), self.scale_list, linear,
                            self.config.splat_backend, self.config.warp_backend,
                            self.config.drm_splat_scale, self.config.conv_backend)
