"""Distance Ratio Map (DRM) for RIFE, GMFSS and GMFSS_UNION (counterpart of
drba_tpu/drm.py).

  * ratio maps ``d10 / (d10 + d12)`` from bidirectional flow magnitudes;
  * linear retiming ``drm * t * 2`` (the driver always passes linear=True)
    or nonlinear retiming by coupled bisection (``get_drm_t``);
  * forward-splat alignment of the retimed maps to the intermediate frame's
    time, with hole fill where the splatted coverage is < 0.999.

Timesteps may be one float or a (T,) vector; a vector gives (T*N, H, W, 1)
maps folded over the leading axis. The nonlinear retime's bisection
schedule is host control flow: for a vector on the card it is built from
the caller's host values (``t_host``), never read back from the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from drba_tpu_torch.ops import flow_distance, softsplat
from drba_tpu_torch.ops.resize import resize_bilinear


def _bisect_schedule(t, precision: float, f32: bool) -> list[bool]:
    """The data-independent branch sequence of the coupled bisection: for
    each step, True = move down toward ``l``, False = move up toward ``r``.

    ``f32`` runs the scalar trajectory in float32, as the JAX package's traced
    loop does for a vector of timesteps; otherwise in Python floats, as its
    unrolled loop does for a float ``t``.
    """
    cast = np.float32 if f32 else float
    x, lo, hi, t, half, prec = (cast(v) for v in (0.5, 0.0, 1.0, t, 0.5, precision))
    steps = []
    while abs(x - t) > prec:
        if x > t:
            hi = x
            x = x - (x - lo) * half
            steps.append(True)
        if x < t:
            lo = x
            x = x + (hi - x) * half
            steps.append(False)
    return steps


def get_drm_t(drm: torch.Tensor, t, precision: float = 1e-3, f32_schedule: bool = False):
    """Nonlinearly retime a ratio map to target time ``t`` (drm.py:10-62): the
    scalar bisection toward ``t`` is mirrored per pixel with step ``b = drm``."""
    x_d = drm.float()
    b_d = x_d
    l_d = torch.zeros_like(x_d)
    r_d = torch.ones_like(x_d)
    for down in _bisect_schedule(t, precision, f32_schedule):
        if down:
            r_d = x_d
            x_d = x_d - (x_d - l_d) * b_d
        else:
            l_d = x_d
            x_d = x_d + (r_d - x_d) * b_d
    return x_d.to(drm.dtype)


def _ratio_maps(flow10: torch.Tensor, flow12: torch.Tensor, eps: float):
    d10 = flow_distance(flow10).float() + eps
    d12 = flow_distance(flow12).float() + eps
    denom = d10 + d12
    return d10 / denom, d12 / denom


def _retime(drm: torch.Tensor, t: float, linear: bool) -> torch.Tensor:
    return drm * t * 2 if linear else get_drm_t(drm, t)


def _host_values(ts: torch.Tensor, ts_host) -> np.ndarray:
    """The host values of the (T,) timesteps ``ts``: ``ts_host`` where the
    caller has them, else a CPU ``ts``'s own; a card's ``ts`` is not read back."""
    if ts_host is not None:
        return np.asarray(ts_host, np.float32)
    if ts.device.type != "cpu":
        raise ValueError("the nonlinear retime needs the timesteps' host values (t_host) "
                         "for timesteps on the card")
    return ts.numpy()


def _retime_batched(drm: torch.Tensor, ts: torch.Tensor, linear: bool,
                    ts_host=None) -> torch.Tensor:
    """Retime one (N,H,W,1) map at T timesteps -> (T*N,H,W,1) folded maps;
    the nonlinear schedule from ``ts_host`` (see :func:`_host_values`)."""
    T = ts.shape[0]
    n, h, w, _ = drm.shape
    if linear:
        out = drm[None] * ts.to(drm.device, torch.float32)[:, None, None, None, None] * 2
    else:
        out = torch.stack([get_drm_t(drm, float(t), f32_schedule=True)
                           for t in _host_values(ts, ts_host)])
    return out.reshape(T * n, h, w, 1)


def _tile_t(x: torch.Tensor, T: int) -> torch.Tensor:
    """Broadcast (N, ...) -> (T*N, ...) matching ``_retime_batched`` order."""
    return x[None].expand((T,) + tuple(x.shape)).reshape((-1,) + tuple(x.shape[1:]))


def _is_batched_t(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dim() == 1


def _hole_fill(warped: torch.Tensor, warped_ones: torch.Tensor,
               fallback: torch.Tensor) -> torch.Tensor:
    """Replace pixels whose warped coverage < 0.999 (drm.py:98-102)."""
    return torch.where(warped_ones < 0.999, fallback, warped)


def _splat_avg_scaled(val, flow, metric, mode, backend, splat_scale):
    """Forward-splat ``val`` along ``flow``, at ``splat_scale`` of its
    resolution and bilinearly resized back (1.0 is the exact path)."""
    if splat_scale == 1.0:
        return softsplat(val, flow, metric, mode, backend=backend, return_coverage=True)
    h, w = val.shape[1], val.shape[2]
    hs, ws = int(h * splat_scale), int(w * splat_scale)
    val_s = resize_bilinear(val, (hs, ws))
    flow_s = resize_bilinear(flow, (hs, ws)) * splat_scale
    metric_s = None if metric is None else resize_bilinear(metric, (hs, ws))
    wv, cov = softsplat(val_s, flow_s, metric_s, mode, backend=backend, return_coverage=True)
    return resize_bilinear(wv, (h, w)), resize_bilinear(cov, (h, w))


def _splat_avg_scaled2(val_a, flow_a, metric_a, val_b, flow_b, metric_b, mode, backend,
                       splat_scale):
    """Both direction splats of a DRM alignment as one splat call (stacked on
    the batch axis)."""
    n = val_a.shape[0]
    metric = None
    if metric_a is not None and metric_b is not None:
        metric = torch.cat([metric_a, metric_b], dim=0)
    wv, cov = _splat_avg_scaled(torch.cat([val_a, val_b], dim=0),
                                torch.cat([flow_a, flow_b], dim=0),
                                metric, mode, backend, splat_scale)
    return (wv[:n], cov[:n]), (wv[n:], cov[n:])


class DrmRife(NamedTuple):
    drm_t1_t01: torch.Tensor
    drm_t1_t12: torch.Tensor


def calc_drm_rife(t, flow10: torch.Tensor, flow12: torch.Tensor, linear: bool = False,
                  backend: str = "auto", splat_scale: float = 1.0, t_host=None) -> DrmRife:
    """DRM timestep maps for the RIFE (backward-warp) path (drm.py:65-107).

    ``t``: a float, or a (T,) f32 tensor giving (T*N, H, W, 1) folded maps;
    ``t_host``: its host values (needed for a nonlinear ``t`` on the card).
    ``backend`` selects the splat (Config.splat_backend).
    """
    drm10, drm12 = _ratio_maps(flow10, flow12, eps=1e-4)
    if _is_batched_t(t):
        T = t.shape[0]
        drm_t0 = _retime_batched(drm10, t, linear, t_host)
        drm_t1 = _retime_batched(drm12, t, linear, t_host)
        flow10 = _tile_t(flow10, T)
        flow12 = _tile_t(flow12, T)
    else:
        drm_t0 = _retime(drm10, t, linear)
        drm_t1 = _retime(drm12, t, linear)

    (w01, m01), (w12, m12) = _splat_avg_scaled2(
        drm_t1, flow10 * drm_t1, None, drm_t0, flow12 * drm_t0, None,
        "avg", backend, splat_scale,
    )
    return DrmRife(drm_t1_t01=_hole_fill(w01, m01, drm_t1),
                   drm_t1_t12=_hole_fill(w12, m12, drm_t0))


class DrmGmfss(NamedTuple):
    drm0t_t01: torch.Tensor
    drm1t_t01: torch.Tensor
    drm1t_t12: torch.Tensor
    drm2t_t12: torch.Tensor


def calc_drm_gmfss(t, flow10: torch.Tensor, flow12: torch.Tensor,
                   metric10: torch.Tensor | None, metric12: torch.Tensor | None,
                   linear: bool = False, backend: str = "auto",
                   splat_scale: float = 1.0, t_host=None) -> DrmGmfss:
    """DRM timestep maps for the GMFSS (forward-warp) path (drm.py:209-258).

    ``t``: a float, or a (T,) f32 tensor giving (T*N, H, W, 1) folded maps;
    ``t_host``: its host values (needed for a nonlinear ``t`` on the card).
    With both metrics the alignment splats are metric-weighted ('soft'),
    otherwise plain averages.
    """
    drm10, drm12 = _ratio_maps(flow10, flow12, eps=0.0)
    if _is_batched_t(t):
        T = t.shape[0]
        drm1t_t01 = _retime_batched(drm12, t, linear, t_host)
        drm1t_t12 = _retime_batched(drm10, t, linear, t_host)
        flow10 = _tile_t(flow10, T)
        flow12 = _tile_t(flow12, T)
        metric10 = None if metric10 is None else _tile_t(metric10, T)
        metric12 = None if metric12 is None else _tile_t(metric12, T)
    else:
        drm1t_t01 = _retime(drm12, t, linear)
        drm1t_t12 = _retime(drm10, t, linear)
    drm0t_u = 1.0 - drm1t_t01
    drm2t_u = 1.0 - drm1t_t12

    mode = "soft" if (metric10 is not None and metric12 is not None) else "avg"
    (w0, m0), (w2, m2) = _splat_avg_scaled2(drm0t_u, flow10, metric10, drm2t_u, flow12,
                                            metric12, mode, backend, splat_scale)
    return DrmGmfss(drm0t_t01=_hole_fill(w0, m0, drm0t_u), drm1t_t01=drm1t_t01,
                    drm1t_t12=drm1t_t12, drm2t_t12=_hole_fill(w2, m2, drm2t_u))


def calc_drm_rife_auxiliary(t, flow10: torch.Tensor, flow12: torch.Tensor,
                            metric10: torch.Tensor | None, metric12: torch.Tensor | None,
                            linear: bool = False, backend: str = "auto",
                            splat_scale: float = 1.0, t_host=None) -> DrmRife:
    """DRM timestep maps for the auxiliary RIFE inside GMFSS_UNION
    (drm.py:158-195; drba_tpu/drm.py:261-298): :func:`calc_drm_rife` with
    metric-weighted ('soft') alignment splats when both metrics are given.

    ``t``: a float, or a (T,) f32 tensor giving (T*N, H, W, 1) folded maps;
    ``t_host``: its host values (needed for a nonlinear ``t`` on the card).
    """
    drm10, drm12 = _ratio_maps(flow10, flow12, eps=1e-4)
    if _is_batched_t(t):
        T = t.shape[0]
        drm_t0 = _retime_batched(drm10, t, linear, t_host)
        drm_t1 = _retime_batched(drm12, t, linear, t_host)
        flow10 = _tile_t(flow10, T)
        flow12 = _tile_t(flow12, T)
        metric10 = None if metric10 is None else _tile_t(metric10, T)
        metric12 = None if metric12 is None else _tile_t(metric12, T)
    else:
        drm_t0 = _retime(drm10, t, linear)
        drm_t1 = _retime(drm12, t, linear)

    mode = "soft" if (metric10 is not None and metric12 is not None) else "avg"
    (w01, m01), (w12, m12) = _splat_avg_scaled2(
        drm_t1, flow10 * drm_t1, metric10, drm_t0, flow12 * drm_t0, metric12,
        mode, backend, splat_scale,
    )
    return DrmRife(drm_t1_t01=_hole_fill(w01, m01, drm_t1),
                   drm_t1_t12=_hole_fill(w12, m12, drm_t0))
