"""The uniform model API, written once: every model subclasses :class:`Model`.

The frame loop, the planner and the benchmark call a model through
``.scale``, ``.pad_size``, ``.config``, ``.device``, ``.params`` and the
calls below: ``inference_ts`` (plain interpolation), ``reuse`` (the (a, b)
pass: a NamedTuple with ``feat0``, a's features, and ``swapped()``, the
(b, a) pass), ``inference_ts_drba`` (DRM interpolation over a 3-frame
window), and its two halves, which the multi-device planner
(``parallel/batch.py``) runs apart: ``next_reuse`` and ``drba_window``.

A model class writes only its own parts: ``__init__``, which loads, casts
and packs its weights and sets those attributes; ``PLAIN_PASS``;
``PARAM_TREES``, the attributes holding its parameter trees (what
``parallel/batch.replicate`` moves); and three eager bodies, each a call
into its module's functions: ``_pass(a, b, <optional features>)``,
``_plain(I0, I1, ts, reuse)`` and ``_window(I0, I1, I2, ts, ts_host,
reuse10, reuse21, linear)``, ``ts`` a (T,) tensor and ``ts_host`` its host
values, the frames (T, N, H, W, 3).

Here each call picks its route. On a CUDA device (``graphs.on``) it runs
through the model's captured graphs (``graphs.py``), one kind per call:
``window`` (``inference_ts_drba`` on a reuse: the pass and the timesteps
as one, ``_fused_window``), ``plain`` (``inference_ts``), ``pass``
(``reuse``, ``next_reuse``) and ``unfused`` (``drba_window``). Elsewhere
it runs the eager body.
"""

from __future__ import annotations

from typing import Sequence

import torch

from drba_tpu_torch import graphs


class Model:
    """An interpolation model's calls and their routing (see the module)."""

    # whether the plain call runs a pass and hands it on (the GMFSS pair),
    # or computes none (RIFE): the frame loop chains on it only where True
    PLAIN_PASS: bool
    PARAM_TREES: tuple = ("params",)

    def _ts(self, ts) -> torch.Tensor:
        """``ts`` (host values) as a (T,) float32 tensor on the model's
        device; on a CUDA device through the model's pinned ring, without a
        host sync."""
        host = graphs.host_timesteps(ts)
        if self.device.type != "cuda":
            return torch.from_numpy(host.copy())
        return graphs.state(self).timesteps(host, self.device)

    def _route(self, kind: str, key: tuple, fn, args: tuple, host=None):
        """``fn(args, ts)`` -> ((T, ...) frames or None, reuse or None) through
        the ``kind`` graph of ``key`` where ``graphs.on``, else eagerly ->
        (frames as a list or None, reuse); ``host`` the timesteps' values."""
        if graphs.on(self):
            return graphs.state(self).call(kind, key, fn, args, host)
        out, nxt = fn(args, None if host is None else self._ts(host))
        return (None if out is None else list(out.unbind(0))), nxt

    def _routed_pass(self, a, b, *feats):
        """The ``pass`` call behind ``reuse`` and ``next_reuse``."""
        # every optional feature of ``_pass``: the key says which are given
        feats += (None,) * (len(self._pass.__defaults__ or ()) - len(feats))
        key = (tuple(a.shape), a.dtype, a.device, tuple(f is not None for f in feats))
        return self._route("pass", key, lambda x, _t: (None, self._pass(*x)), (a, b, *feats))[1]

    def reuse(self, a, b, *feats):
        """The (a, b) pass; ``feats`` the pass's optional features (a's
        first), None where not given."""
        return self._routed_pass(a, b, *feats)

    def next_reuse(self, I1, I2, feat1=None):
        """The reuse ``inference_ts_drba`` hands the window after (., I1, I2):
        the (I1, I2) pass swapped. ``feat1``: I1's features, where the chain
        has them."""
        return self._routed_pass(I1, I2, feat1).swapped()

    def inference_ts(self, I0, I1, ts: Sequence[float], reuse=None, return_reuse=False):
        """Plain interpolation at timesteps in [0, 1]. Where ``PLAIN_PASS``,
        ``reuse`` (an I0 -> I1 pass) skips the pass and ``return_reuse`` hands
        it back; elsewhere it is ignored and the reuse returned is None."""
        if len(ts) == 0:
            return ([], None) if return_reuse else []
        if not self.PLAIN_PASS:
            reuse = None
        elif reuse is None:
            reuse = self.reuse(I0, I1)
        host = graphs.host_timesteps(ts)
        frames = self._route("plain", (len(host), tuple(I0.shape), I0.dtype, I0.device),
                             lambda a, t: (self._plain(a[0], a[1], t, a[2]), None),
                             (I0, I1, reuse), host)[0]
        return (frames, reuse) if return_reuse else frames

    def _fused_window(self, I0, I1, I2, ts, ts_host, reuse, linear):
        """``next_reuse`` and the timesteps of a window on the chain's reuse,
        eagerly: what one ``window`` graph runs -> ((T, N, H, W, 3), next
        reuse)."""
        nxt = self._pass(I1, I2, reuse.feat0).swapped()
        return self._window(I0, I1, I2, ts, ts_host, reuse, nxt, linear), nxt

    def drba_window(self, I0, I1, I2, ts, reuse10, reuse21, linear: bool = False):
        """The window's timesteps, unfused from its pass: ``reuse10`` is the
        chain's I1 -> I0 pass (None starts the chain with it), ``reuse21``
        this window's ``next_reuse(I1, I2)``."""
        reuse10 = self.reuse(I1, I0) if reuse10 is None else reuse10
        host = graphs.host_timesteps(ts)
        return self._route(
            "unfused", graphs.window_key(host, I1, linear),
            lambda a, t: (self._window(*a[:3], t, host, a[3], a[4], linear), None),
            (I0, I1, I2, reuse10, reuse21), host)[0]

    def inference_ts_drba(self, I0, I1, I2, ts, reuse=None, linear: bool = False):
        """DRM-adjusted interpolation over a 3-frame window; ``ts`` in
        [0.5, 1.5) (window time, centred on I1). Returns (frames, the reuse
        of (I2, I1) for the next window). On a CUDA device the pass and the
        timesteps replay one ``window`` graph, and a chain start (``reuse``
        None) replays a ``pass`` graph before it."""
        if reuse is None:
            reuse = self.reuse(I1, I0)
        if len(ts) and graphs.on(self):
            return graphs.state(self).run(self._fused_window, I0, I1, I2, ts, reuse, linear)
        nxt = self.next_reuse(I1, I2, reuse.feat0)
        if len(ts) == 0:
            return [], nxt
        return self.drba_window(I0, I1, I2, ts, reuse, nxt, linear), nxt
