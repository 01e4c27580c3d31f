"""GMFSS model wrapper, the quality path (counterpart of drba_tpu/models/gmfss.py).

The uniform model API and its routing through the captured graphs are
``models/base.Model``'s; here are GMFSS's weights and eager bodies. As in
the JAX package, the T timesteps of a window are folded into the batch axis
(one GridNet call per window) and integer timesteps pass the source frames
through. Inputs are single frames (N = 1). The reuse chain carries a
``Reuse`` (flows, metrics, feature pyramids) from window to window; the
plain call runs the pass too and hands it on. ``Config.conv_backend`` runs
the nets' conv chains (models/gmfss_nets.py).
"""

from __future__ import annotations

import numpy as np
import torch

from drba_tpu_torch.config import DEFAULT, Config, model_device
from drba_tpu_torch.convert import load_network
from drba_tpu_torch.drm import calc_drm_gmfss
from drba_tpu_torch.models.base import Model
from drba_tpu_torch.models.gmflow_net import GMFLOW_SPEC, pack_transformer_weights
from drba_tpu_torch.models.gmfss_core import GmfssParams, Reuse, gmfss_inference, gmfss_reuse
from drba_tpu_torch.models.gmfss_nets import (FEATURENET_SPEC, GRIDNET_SPEC, METRICNET_CHAIN,
                                             METRICNET_SPEC, featurenet_chain_convs,
                                             gridnet_chain_convs, pack_chain_weights)


def _select_reuse(left: torch.Tensor, a: Reuse, b: Reuse) -> Reuse:
    """Per timestep, ``a``'s field where ``left`` else ``b``'s -> (T, ...) fields."""
    def sel(x, y):
        return torch.where(left, x, y)

    return Reuse(sel(a.flow01, b.flow01), sel(a.flow10, b.flow10), sel(a.metric0, b.metric0),
                 sel(a.metric1, b.metric1), tuple(map(sel, a.feat0, b.feat0)),
                 tuple(map(sel, a.feat1, b.feat1)))


def _select_integer_ts(out, ts, *frames):
    """out (T,H,W,3): where ts == k, take frames[k] (gmfss.py:63-65)."""
    tb = ts[:, None, None, None]
    for k in range(len(frames) - 1, -1, -1):
        out = torch.where(tb == k, frames[k], out)
    return out


def pack_chain_sites(p: GmfssParams, union: bool = False) -> GmfssParams:
    """MetricNet, FeatureNet and GridNet with the conv kernel's packed
    weights (``.wp`` keys) that their chain sites read, built once per model
    from the weights in the compute dtype (split for f32, whose sites take
    more convs)."""
    f32 = p.metricnet["metric_in.weight"].dtype == torch.float32
    return p._replace(metricnet=pack_chain_weights(p.metricnet, METRICNET_CHAIN),
                      feat_ext=pack_chain_weights(p.feat_ext, featurenet_chain_convs(f32)),
                      fusionnet=pack_chain_weights(p.fusionnet, gridnet_chain_convs(union, f32)))


def _drba_window(p: GmfssParams, I0, I1, I2, ts, ts_host, reuse10: Reuse, reuse12: Reuse,
                 linear, backend="auto", drm_splat_scale=1.0, conv_backend="auto"):
    """All T timesteps of one window, T folded into the batch axis; returns
    (T, 1, H, W, 3). ``ts_host``: the host values of ``ts``."""
    T = ts.shape[0]
    tt = torch.where(ts < 1, 1 - ts, ts - 1)
    drm = calc_drm_gmfss(tt, reuse10.flow01, reuse12.flow01, reuse10.metric0, reuse12.metric0,
                         linear=linear, backend=backend, splat_scale=drm_splat_scale,
                         t_host=np.where(ts_host < 1, 1 - ts_host, ts_host - 1))
    left = (ts < 1)[:, None, None, None]
    imgB = torch.where(left, I0, I2)
    I1b = I1.expand((T,) + tuple(I1.shape[1:]))
    reuse = _select_reuse(left, reuse10, reuse12)
    t0 = torch.where(left, drm.drm1t_t01, drm.drm1t_t12).to(I1.dtype)
    t1 = torch.where(left, drm.drm0t_t01, drm.drm2t_t12).to(I1.dtype)
    out = gmfss_inference(p, I1b, imgB, reuse, t0, t1, backend=backend,
                          conv_backend=conv_backend)
    return _select_integer_ts(out, ts, I0, I1, I2)[:, None]


def _tile(x, T):
    return x.expand((T,) + tuple(x.shape[1:]))


def _tile_reuse(reuse: Reuse, T) -> Reuse:
    """A single pair's reuse broadcast over T timesteps."""
    def tile(x):
        return _tile(x, T)

    return Reuse(tile(reuse.flow01), tile(reuse.flow10), tile(reuse.metric0),
                 tile(reuse.metric1), tuple(map(tile, reuse.feat0)),
                 tuple(map(tile, reuse.feat1)))


def _ts_batch(p: GmfssParams, I0, I1, ts, reuse: Reuse, backend="auto", conv_backend="auto"):
    """Plain interpolation at T timesteps, T folded into the batch axis."""
    T = ts.shape[0]
    tcol = ts[:, None, None, None].to(I0.dtype)
    out = gmfss_inference(p, _tile(I0, T), _tile(I1, T), _tile_reuse(reuse, T), tcol, 1 - tcol,
                          backend=backend, conv_backend=conv_backend)
    return _select_integer_ts(out, ts, I0, I1)[:, None]


class GMFSS(Model):
    """Quality-path model (reference: models/gmfss.py:7-73) on ``device``
    (CUDA unless the caller asks for another; raises when there is none).

    Parameters are cast to ``config.compute_dtype`` once, on the device;
    GMFlow's transformer weights are packed for the layer kernels, and the
    chain sites' conv weights for the conv kernel, once, here.
    """

    PLAIN_PASS = True

    def __init__(self, weights: str | None = None, scale: float = 1.0,
                 config: Config = DEFAULT, device: str | torch.device = "cuda"):
        self.device = model_device(device)
        nets = []
        for i, (fname, spec) in enumerate((("flownet.pkl", GMFLOW_SPEC),
                                           ("metric.pkl", METRICNET_SPEC),
                                           ("feat.pkl", FEATURENET_SPEC),
                                           ("fusionnet.pkl", GRIDNET_SPEC))):
            params = load_network(weights, fname, spec, seed=config.seed + i,
                                  strict=config.strict_load)
            nets.append({k: v.to(self.device, config.compute_dtype) for k, v in params.items()})
        nets[0] = pack_transformer_weights(nets[0])
        self.params = pack_chain_sites(GmfssParams(*nets))
        self.scale = scale
        self.pad_size = 64
        self.config = config

    def _pass(self, img0, img1, feat0=None) -> Reuse:
        return gmfss_reuse(self.params, img0, img1, self.scale, feat0=feat0,
                           warp_backend=self.config.warp_backend,
                           attn_backend=self.config.attn_backend,
                           conv_backend=self.config.conv_backend)

    def _plain(self, I0, I1, ts, reuse: Reuse):
        return _ts_batch(self.params, I0, I1, ts, reuse, backend=self.config.splat_backend,
                         conv_backend=self.config.conv_backend)

    def _window(self, I0, I1, I2, ts, ts_host, reuse10, reuse21, linear):
        return _drba_window(self.params, I0, I1, I2, ts, ts_host, reuse10, reuse21.swapped(),
                            linear, self.config.splat_backend, self.config.drm_splat_scale,
                            self.config.conv_backend)
