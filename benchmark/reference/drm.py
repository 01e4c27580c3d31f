"""Distance Ratio Map retiming with linear timesteps, plain PyTorch
(frozen reference; DRBA ``models/drm.py``).

Ratio maps ``d10 / (d10 + d12)`` from the two flows' magnitudes, retimed
linearly (``drm * t * 2``) at each of a window's T timesteps (T folded into
the batch axis, timestep-major), forward-splatted to the intermediate
frame's time at ``splat_scale`` of the map's resolution and resized back,
with the retimed map kept where the splat's coverage is below 0.999.
"""

from __future__ import annotations

import torch

from benchmark.reference.nn import flow_distance, resize, softsplat


def _ratio_maps(flow10, flow12, eps: float):
    d10 = flow_distance(flow10).float() + eps
    d12 = flow_distance(flow12).float() + eps
    return d10 / (d10 + d12), d12 / (d10 + d12)


def _retime(drm: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) at the (T,) timesteps -> (T*N, H, W, 1)."""
    n, h, w, _ = drm.shape
    out = drm[None] * t.to(drm.device, torch.float32)[:, None, None, None, None] * 2
    return out.reshape(t.shape[0] * n, h, w, 1)


def _tile(x: torch.Tensor, T: int) -> torch.Tensor:
    return x[None].expand((T,) + tuple(x.shape)).reshape((-1,) + tuple(x.shape[1:]))


def _splat2(val_a, flow_a, metric_a, val_b, flow_b, metric_b, splat_scale):
    """Both alignment splats as one call, at ``splat_scale`` of the
    resolution, resized back -> ((value, coverage) of a, of b)."""
    n = val_a.shape[0]
    val = torch.cat([val_a, val_b], dim=0)
    flow = torch.cat([flow_a, flow_b], dim=0)
    metric = None if metric_a is None else torch.cat([metric_a, metric_b], dim=0)
    mode = "avg" if metric is None else "soft"
    if splat_scale == 1.0:
        wv, cov = softsplat(val, flow, metric, mode, coverage=True)
    else:
        h, w = val.shape[1], val.shape[2]
        size = (int(h * splat_scale), int(w * splat_scale))
        wv, cov = softsplat(resize(val, size), resize(flow, size) * splat_scale,
                            None if metric is None else resize(metric, size), mode, coverage=True)
        wv, cov = resize(wv, (h, w)), resize(cov, (h, w))
    return (wv[:n], cov[:n]), (wv[n:], cov[n:])


def _fill(warped, coverage, fallback):
    return torch.where(coverage < 0.999, fallback, warped)


def drm_rife(t, flow10, flow12, splat_scale: float, metric10=None, metric12=None):
    """RIFE's maps (t, 1, 0 -> 1) and (t, 1, 2 -> 1), (T*N, H, W, 1); with
    both metrics (GMFSS_UNION's auxiliary RIFE) the splats are 'soft'."""
    T = t.shape[0]
    drm10, drm12 = _ratio_maps(flow10, flow12, eps=1e-4)
    drm_t0, drm_t1 = _retime(drm10, t), _retime(drm12, t)
    flow10, flow12 = _tile(flow10, T), _tile(flow12, T)
    if metric10 is not None:
        metric10, metric12 = _tile(metric10, T), _tile(metric12, T)
    (w01, m01), (w12, m12) = _splat2(drm_t1, flow10 * drm_t1, metric10, drm_t0,
                                     flow12 * drm_t0, metric12, splat_scale)
    return _fill(w01, m01, drm_t1), _fill(w12, m12, drm_t0)


def drm_gmfss(t, flow10, flow12, metric10, metric12, splat_scale: float):
    """GMFSS's four maps (drm0t_t01, drm1t_t01, drm1t_t12, drm2t_t12)."""
    T = t.shape[0]
    drm10, drm12 = _ratio_maps(flow10, flow12, eps=0.0)
    drm1t_t01, drm1t_t12 = _retime(drm12, t), _retime(drm10, t)
    drm0t_u, drm2t_u = 1.0 - drm1t_t01, 1.0 - drm1t_t12
    (w0, m0), (w2, m2) = _splat2(drm0t_u, _tile(flow10, T), _tile(metric10, T), drm2t_u,
                                 _tile(flow12, T), _tile(metric12, T), splat_scale)
    return _fill(w0, m0, drm0t_u), drm1t_t01, drm1t_t12, _fill(w2, m2, drm2t_u)
