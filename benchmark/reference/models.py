"""The reference's view of a configuration: its nets, and each block of the
frame loop's output recomputed from the source frames.

A block is the head, a body window or the tail of the frame loop (DRBA
``infer.py:93-169``). Its frames, for the (T,) timesteps ``ts`` in [0.5,
1.5) around the block's middle frame:

* head (I0, I1): I0 at ts < 1, plain interpolation at ts - 1 for ts >= 1;
  a cut between I0 and I1 repeats I0;
* window (I0, I1, I2): with cuts on both sides I1 repeated; with a cut
  left of I1, I1 at ts < 1 and plain (I1, I2) at ts - 1 for ts >= 1; with a
  cut right of I1, plain (I0, I1) at ts <= 1 and I1 for ts > 1; else the
  DRM window on the I1 -> I0 and I1 -> I2 flows;
* tail (I0, I1): plain (I0, I1) at ts <= 1, I1 for ts > 1.

Which flows a DRM window reads depends on the chain before it, as in the
program: a chained window reads the previous window's (I0, I1) pass,
reversed; a chain start reads the (I1, I0) pass (see ``plan.Block``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gmfss, ifnet, rife

MODEL_TYPES = ("rife", "gmfss_union")


def specs(model_type: str) -> dict:
    return {"flownet": ifnet.spec()} if model_type == "rife" else gmfss.specs()


def files(model_type: str) -> dict:
    return {"flownet": "flownet.pkl"} if model_type == "rife" else gmfss.FILES


class Reference:
    """Configuration ``cfg`` (its ``model_type``, ``scale``,
    ``drm_splat_scale``) on the nets ``params`` ({net: {key: tensor}}),
    computing in the parameters' dtype."""

    def __init__(self, cfg: dict, params: dict):
        if cfg["model_type"] not in MODEL_TYPES:
            raise ValueError(f"model_type {cfg['model_type']!r}: one of {MODEL_TYPES}")
        self.union = cfg["model_type"] == "gmfss_union"
        self.scale = float(cfg["scale"])
        self.splat_scale = float(cfg["drm_splat_scale"])
        self.nets = gmfss.Nets(**params) if self.union else params["flownet"]

    # --------------------------------------------------------------------- the program's calls

    def flow_pass(self, a, b, fa=None):
        """RIFE: (flow_ab, flow_ba, f_a, f_b); GMFSS_UNION: the (a, b) Reuse."""
        if self.union:
            return gmfss.reuse(self.nets, a, b, feat0=fa, scale=self.scale)
        return rife.flow_pass(self.nets, a, b, self.scale, fa=fa)

    def window(self, I0, I1, I2, ts, reuse10, pass12):
        """The DRM window -> (T, 1, H, W, 3). ``reuse10``: RIFE's
        (flow10, _, f1, f0) or the union's I1 -> I0 Reuse; ``pass12``:
        the (I1, I2) pass."""
        if self.union:
            return gmfss.window(self.nets, I0, I1, I2, ts, reuse10, pass12, self.scale,
                                self.splat_scale)[:, None]
        flow10, _, f1, f0 = reuse10
        return rife.window(self.nets, I0, I1, I2, ts, flow10, pass12[0], f0, f1, pass12[3],
                           self.scale, self.splat_scale)

    def plain(self, I0, I1, ts, reuse01=None):
        """Plain interpolation -> (T, 1, H, W, 3); the union's on the (I0, I1) Reuse."""
        if self.union:
            r = gmfss.reuse(self.nets, I0, I1, scale=self.scale) if reuse01 is None else reuse01
            return gmfss.plain(self.nets, I0, I1, ts, r, self.scale)[:, None]
        return rife.plain(self.nets, I0, I1, ts, self.scale)

    def chain_reuse(self, I0, I1, chain_start: bool):
        """The reuse a DRM window on (I0, I1, .) reads: the (I1, I0) pass at a
        chain start, else the (I0, I1) pass reversed."""
        if chain_start:
            return self.flow_pass(I1, I0)
        p = self.flow_pass(I0, I1)
        return p.swapped() if self.union else (p[1], p[0], p[3], p[2])

    # ------------------------------------------------------------------------------ blocks

    def block(self, kind: str, frames, ts: np.ndarray, left_cut=False, right_cut=False,
              chain_start=False) -> list:
        """The block's frames, each (1, H, W, 3); ``frames`` its input frames
        (I0, I1[, I2]) as (1, H, W, 3) tensors."""
        dev, dtype = frames[0].device, frames[0].dtype

        def t(values):
            return torch.tensor(np.asarray(values, np.float32), device=dev)

        def plain(a, b, values):
            if len(values) == 0:
                return []
            return list(self.plain(a, b, t(values)).to(dtype).unbind(0))

        if kind == "head":
            I0, I1 = frames
            if left_cut:
                return [I0] * len(ts)
            return [I0] * int((ts < 1).sum()) + plain(I0, I1, ts[ts >= 1] - 1)
        if kind == "tail":
            I0, I1 = frames
            return plain(I0, I1, ts[ts <= 1]) + [I1] * int((ts > 1).sum())
        I0, I1, I2 = frames
        if left_cut and right_cut:
            return [I1] * len(ts)
        if left_cut:
            return [I1] * int((ts < 1).sum()) + plain(I1, I2, ts[ts >= 1] - 1)
        if right_cut:
            return plain(I0, I1, ts[ts <= 1]) + [I1] * int((ts > 1).sum())
        reuse10 = self.chain_reuse(I0, I1, chain_start)
        pass12 = self.flow_pass(I1, I2, reuse10.feat0 if self.union else reuse10[2])
        return list(self.window(I0, I1, I2, t(ts), reuse10, pass12).to(dtype).unbind(0))
