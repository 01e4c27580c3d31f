"""RIFE model wrapper, the speed path (counterpart of drba_tpu/models/rife.py).

The uniform model API and its routing through the captured graphs are
``models/base.Model``'s; here are RIFE's weights and eager bodies. As in
the JAX package, the T timesteps of a window are folded into the batch
axis, so one IFNet call serves the whole window; integer timesteps pass the
source frames through. The frame the T planes share (I1 and its features)
is read with a batch stride of 0 and the B side (I0 or I2) is picked per
plane (``ops/planes.py``), so no T-fold copy is made. The pass
(``_calc_flow``, a ``Flows``): bidirectional coarse flow from IFBlock0,
inverted by forward-splatting the negated flow, holes (coverage < 0.999)
filled with a ``max(H, W)`` sentinel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from drba_tpu_torch.config import DEFAULT, Config, model_device
from drba_tpu_torch.convert import load_network
from drba_tpu_torch.drm import calc_drm_rife
from drba_tpu_torch.models.base import Model
from drba_tpu_torch.models.ifnet import (IFNET_SPEC, block0_input, ifnet_apply,
                                         ifnet_block_at_scale, ifnet_encode,
                                         pack_resconv_weights)
from drba_tpu_torch.ops import softsplat
from drba_tpu_torch.ops.planes import Pick, shared


def _calc_flow(params, a, b, scale0: float, f0=None, f1=None, splat_backend: str = "auto",
               conv_backend: str = "auto", warp_backend: str = "auto"):
    """Bidirectional full-step flow between a and b (models/rife.py:41-75);
    IFBlock 0's input assembled at its scale and its output written
    (``warp_backend``: by the kernels or the plain versions, as in
    ``ifnet_apply``).

    Returns (flow_ab, flow_ba, f_a, f_b).
    """
    f0 = ifnet_encode(params, a[..., :3]) if f0 is None else f0
    f1 = ifnet_encode(params, b[..., :3]) if f1 is None else f1
    h, wd = a.shape[1], a.shape[2]
    timestep = a.new_full((1, 1, 1, 1), 0.5).expand(a.shape[0], h, wd, 1)
    x = block0_input(a, b, f0, f1, timestep, scale0, warp_backend)
    flow, _, _ = ifnet_block_at_scale(params, 0, x, scale0, (h, wd), conv_backend,
                                      warp_backend=warp_backend)

    # both inversions in one splat call (stacked on the batch axis)
    n = flow.shape[0]
    both = torch.cat([flow[..., 0:2], flow[..., 2:4]], dim=0)
    w, mask = softsplat(both, both, None, "avg", backend=splat_backend, return_coverage=True)
    inv = torch.where(mask < 0.999, float(max(h, wd)), -w)
    return inv[:n] * 2, inv[n:] * 2, f0, f1


def _select_integer_ts(out, ts, *frames):
    """out (T,N,H,W,3): where ts == k, take frames[k] (models/rife.py:89-95)."""
    tb = ts[:, None, None, None, None]
    for k in range(len(frames) - 1, -1, -1):
        out = torch.where(tb == k, frames[k][None], out)
    return out


class Flows(NamedTuple):
    """RIFE's (a, b) pass: the inverted full-step flows a -> b and b -> a,
    and both frames' encoder features."""

    flow01: torch.Tensor
    flow10: torch.Tensor
    feat0: torch.Tensor
    feat1: torch.Tensor

    def swapped(self) -> "Flows":
        """The (b, a) pass, for chaining windows."""
        return Flows(self.flow10, self.flow01, self.feat1, self.feat0)


def _drba_window(params, I0, I1, I2, ts, ts_host, flow10, flow12, f0, f1, f2, scale_list,
                 linear, splat_backend="auto", warp_backend="auto", drm_splat_scale=1.0,
                 conv_backend="auto"):
    """All timesteps of one 3-frame window, T folded into the batch axis.

    ``ts`` is a (T,) f32 tensor on the frames' device, ``ts_host`` its host
    values (the nonlinear retime's schedule); returns (T, N, H, W, 3).
    """
    T = ts.shape[0]
    n, h, w, _ = I1.shape
    tt = torch.where(ts < 1, 1 - ts, ts - 1)
    drm = calc_drm_rife(tt, flow10, flow12, linear=linear, backend=splat_backend,
                        splat_scale=drm_splat_scale,
                        t_host=np.where(ts_host < 1, 1 - ts_host, ts_host - 1))
    # the B side per plane: I0 before the window's centre, I2 after it
    take_b = (~(ts < 1)).repeat_interleave(n)
    img_b = Pick(shared(I0, T), shared(I2, T), take_b)
    f_b = Pick(shared(f0, T), shared(f2, T), take_b)
    drm_map = Pick(*(d.reshape(T * n, h, w, 1) for d in (drm.drm_t1_t01, drm.drm_t1_t12)),
                   take_b)

    out, _ = ifnet_apply(params, shared(I1, T), img_b, drm_map, scale_list, f0=shared(f1, T),
                         f1=f_b, warp_backend=warp_backend, conv_backend=conv_backend)
    return _select_integer_ts(out.reshape(T, n, h, w, 3), ts, I0, I1, I2)


def _ts_batch(params, I0, I1, ts, scale_list, warp_backend="auto", conv_backend="auto"):
    """Plain interpolation at T timesteps, T folded into the batch axis; each
    frame encoded once."""
    T = ts.shape[0]
    n, h, w, _ = I0.shape
    tmap = ts.repeat_interleave(n)[:, None, None, None].expand(T * n, h, w, 1)
    f0, f1 = (shared(ifnet_encode(params, x[..., :3]), T) for x in (I0, I1))
    out, _ = ifnet_apply(params, shared(I0, T), shared(I1, T), tmap, scale_list, f0=f0, f1=f1,
                         warp_backend=warp_backend, conv_backend=conv_backend)
    return _select_integer_ts(out.reshape(T, n, h, w, 3), ts, I0, I1)


class RIFE(Model):
    """Speed-path model (reference: models/rife.py:15-109) on ``device``
    (CUDA unless the caller asks for another; raises when there is none).

    Parameters are cast to ``config.compute_dtype`` once, on the device; the
    ResConv chains' weights are packed for the conv kernel once, here.
    """

    PLAIN_PASS = False  # the plain call encodes both frames and runs no pass

    def __init__(self, weights: str | None = None, scale: float = 1.0,
                 config: Config = DEFAULT, device: str | torch.device = "cuda"):
        self.device = model_device(device)
        params = load_network(weights, "flownet.pkl", IFNET_SPEC, seed=config.seed,
                              strict=config.strict_load)
        self.params = pack_resconv_weights(
            {k: v.to(self.device, config.compute_dtype) for k, v in params.items()})
        self.scale = scale
        self.scale_list = tuple(s / scale for s in (16.0, 8.0, 4.0, 2.0, 1.0))
        self.pad_size = 64
        self.config = config

    def _pass(self, a, b, f0=None, f1=None) -> Flows:
        return Flows(*_calc_flow(self.params, a, b, self.scale_list[0], f0=f0, f1=f1,
                                 splat_backend=self.config.splat_backend,
                                 conv_backend=self.config.conv_backend,
                                 warp_backend=self.config.warp_backend))

    def _plain(self, I0, I1, ts, reuse=None):
        return _ts_batch(self.params, I0, I1, ts, self.scale_list,
                         warp_backend=self.config.warp_backend,
                         conv_backend=self.config.conv_backend)

    def _window(self, I0, I1, I2, ts, ts_host, reuse10, reuse21, linear):
        flow10, _flow01, f1, f0 = reuse10
        _flow21, flow12, f2, _ = reuse21
        return _drba_window(self.params, I0, I1, I2, ts, ts_host, flow10, flow12, f0, f1, f2,
                            self.scale_list, linear, self.config.splat_backend,
                            self.config.warp_backend, self.config.drm_splat_scale,
                            self.config.conv_backend)
