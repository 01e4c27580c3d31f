"""RIFE's calls, plain PyTorch (frozen reference; DRBA ``models/rife.py``).

* :func:`flow_pass` ``(a, b)``: IFNet's encoder and block 0 give the
  bidirectional coarse flow, inverted by forward-splatting the negated flow
  (holes, coverage below 0.999, get a ``max(H, W)`` sentinel) ->
  (flow_ab, flow_ba, f_a, f_b);
* :func:`window`: a DRM window's T timesteps on the I1 -> I0 and I1 -> I2
  flows and features, T folded into the batch axis;
* :func:`plain`: plain interpolation of (I0, I1) at T timesteps.

Integer timesteps take the source frame itself. Frames are (1, H, W, 3).
"""

from __future__ import annotations

import torch

from benchmark.reference import drm, ifnet
from benchmark.reference.nn import Params, softsplat


def scale_list(scale: float) -> tuple:
    return tuple(s / scale for s in (16.0, 8.0, 4.0, 2.0, 1.0))


def flow_pass(p: Params, a, b, scale: float, fa=None, fb=None):
    fa = ifnet.encode(p, a[..., :3]) if fa is None else fa
    fb = ifnet.encode(p, b[..., :3]) if fb is None else fb
    x = torch.cat([a[..., :3], b[..., :3], fa, fb, torch.full_like(a[..., :1], 0.5)], dim=-1)
    flow, _, _ = ifnet.block(p, 0, x, None, scale_list(scale)[0])
    n = flow.shape[0]
    both = torch.cat([flow[..., 0:2], flow[..., 2:4]], dim=0)
    w, cov = softsplat(both, both, None, "avg", coverage=True)
    inv = torch.where(cov < 0.999, float(max(a.shape[1], a.shape[2])), -w)
    return inv[:n] * 2, inv[n:] * 2, fa, fb


def select_integer(out, ts, *frames):
    """out (T, N, H, W, 3): where ts == k, frames[k]."""
    tb = ts[:, None, None, None, None]
    for k in range(len(frames) - 1, -1, -1):
        out = torch.where(tb == k, frames[k][None], out)
    return out


def _fold(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _tile(x, T):
    return _fold(x[None].expand((T,) + tuple(x.shape)))


def window(p: Params, I0, I1, I2, ts, flow10, flow12, f0, f1, f2, scale: float,
           splat_scale: float):
    """The window's frames at ``ts`` (a (T,) f32 tensor in [0.5, 1.5)) ->
    (T, N, H, W, 3)."""
    T = ts.shape[0]
    n, h, w, _ = I1.shape
    tt = torch.where(ts < 1, 1 - ts, ts - 1)
    d01, d12 = drm.drm_rife(tt, flow10, flow12, splat_scale)
    left = (ts < 1)[:, None, None, None, None]
    img_b = torch.where(left, I0[None], I2[None])
    f_b = torch.where(left, f0[None], f2[None])
    drm_map = torch.where(left, d01.reshape(T, n, h, w, 1), d12.reshape(T, n, h, w, 1))
    out = ifnet.apply(p, _tile(I1, T), _fold(img_b), _fold(drm_map).to(I1.dtype),
                      scale_list(scale), f0=_tile(f1, T), f1=_fold(f_b))
    return select_integer(out.reshape(T, n, h, w, 3), ts, I0, I1, I2)


def plain(p: Params, I0, I1, ts, scale: float):
    """Plain interpolation at ``ts`` in [0, 1] -> (T, N, H, W, 3)."""
    T = ts.shape[0]
    n, h, w, _ = I0.shape
    tmap = ts[:, None, None, None, None].expand(T, n, h, w, 1).reshape(T * n, h, w, 1)
    out = ifnet.apply(p, _tile(I0, T), _tile(I1, T), tmap.to(I0.dtype), scale_list(scale))
    return select_integer(out.reshape(T, n, h, w, 3), ts, I0, I1)
