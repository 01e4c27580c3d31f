"""Multi-device window plans (counterpart of drba_tpu/parallel/batch.py).

A group of B consecutive windows runs on B model replicas, window k on
replica k, each replica on a dispatch thread and a CUDA stream of its own,
in one process (the JAX package's plan is single-controller too: one
process, one video stream, a mesh inside it). Each device runs two phases:

1. its window's I1 -> I2 pass, reversed (``model.next_reuse``): the reuse
   the window after it takes;
2. the window's timesteps (``model.drba_window``) on window k-1's pass as
   its reuse; window 0 takes the chain's carry instead. Device k waits for
   the event recorded after device k-1's phase 1, and the pass crosses
   devices with ``.to(device, non_blocking=True)``: no host sync.

``inference_ts_drba`` is the same two steps fused, so the output is the
serial chain's. The group's last pass is the next group's carry; a group of
fewer windows than devices runs through ``inference_ts_drba`` on the first
device. Every window computes its own timesteps, so none is padded. Frames
and outputs stay on their device: a frame reaches another device by its own
upload of the decoded frame (``pipeline._Frame.take``), and only the chain
carry crosses, once per device boundary (``exchange_accounting``).

Where a replica's device has a CUDA stream, everything the replica reads
waits for an event of the thread that made it: the caller's stream at the
start of a group, the prefetch thread's upload, device k-1's phase 1; and
every tensor is recorded on the streams that read it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
from typing import Optional

import torch

from drba_tpu_torch.config import model_device
from drba_tpu_torch.graphs import _leaves, _map


def _indexed(device) -> torch.device:
    device = model_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replicate(model, device):
    """The same model on ``device``, from the same parameters (the kernels'
    packed copies, ``.wp``, included). On the original's device the replica
    shares the original's tensors."""
    device = _indexed(device)
    rep = copy.copy(model)
    rep.device = device
    for name in model.PARAM_TREES:
        setattr(rep, name, _map(lambda t: t.to(device), getattr(model, name)))
    return rep


def _event(device: torch.device):
    """An event recorded on ``device``'s current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _receive(tree, event, device: torch.device):
    """``tree``, made on a stream that recorded ``event``, on ``device``,
    ordered before work on that device's current stream."""
    if event is None:
        return _map(lambda t: t.to(device), tree)
    dst = torch.cuda.current_stream(device)
    dst.wait_event(event)

    def move(t):
        if t.device == device:
            t.record_stream(dst)
            return t
        src = torch.cuda.current_stream(t.device)  # the copy runs on the source's stream
        src.wait_event(event)
        t.record_stream(src)
        return t.to(device, non_blocking=True)

    return _map(move, tree)


class WindowPlanner:
    """Runs consecutive windows over ``devices``, one replica of ``model``
    each, and threads the serial reuse chain through them.

    ``run(windows)`` yields each window's frames in order, ready on the
    caller's current stream of the device they lie on. ``carry`` is the
    chain's reuse between calls (settable; None starts a chain) and
    ``reset_chain()`` sets it to None, as the serial loop's ``reuse = None``.
    ``close()`` stops the dispatch threads.
    """

    def __init__(self, devices, model):
        self.devices = [_indexed(d) for d in devices]
        if not self.devices:
            raise ValueError("need at least one device")
        self.batch = len(self.devices)
        self.replicas = [replicate(model, d) for d in self.devices]
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        self._pool = concurrent.futures.ThreadPoolExecutor(self.batch,
                                                           thread_name_prefix="drba-device")
        self._carry = None  # (reuse, event, replica index or None for the caller)
        self._ledger: Optional[list] = None  # crossings, while exchange_accounting runs

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    @property
    def carry(self):
        """The chain's reuse on the first device, ordered before work on the
        caller's current stream (None at a chain start)."""
        if self._carry is None:
            return None
        reuse, event, src = self._carry
        return self._hand(reuse, event, src, 0)

    @carry.setter
    def carry(self, reuse) -> None:
        self._carry = None if reuse is None else (reuse, _event(self.devices[0]), None)

    def reset_chain(self) -> None:
        self._carry = None

    def _hand(self, reuse, event, src, dst: int):
        """A carry made by replica ``src`` (None: the caller) for replica
        ``dst``; counted as a crossing between two replicas."""
        if self._ledger is not None and src is not None and src != dst:
            leaves = _leaves(reuse)
            self._ledger.append(("carry", src, dst, len(leaves),
                                 sum(t.numel() * t.element_size() for t in leaves)))
        return _receive(reuse, event, self.devices[dst])

    def _frame(self, x, k: int, starts: dict) -> torch.Tensor:
        """A window's frame on replica ``k``'s device, ready on its stream: a
        ``pipeline._Frame`` gives its copy there; a tensor made on the
        caller's stream is used in place, or copied (and counted) from
        another device."""
        device = self.devices[k]
        if not isinstance(x, torch.Tensor):
            x = x.take(device)
        elif x.device != device:
            if self._ledger is not None:
                self._ledger.append(("frame", None, k, 1, x.numel() * x.element_size()))
            return _receive(x, starts.get(x.device), device)
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            stream.wait_event(starts[device])
            x.record_stream(stream)
        return x

    @contextlib.contextmanager
    def _on(self, k: int):
        """Replica ``k``'s device and stream, current on this thread."""
        if self._streams[k] is None:
            yield
            return
        with torch.cuda.device(self.devices[k]), torch.cuda.stream(self._streams[k]):
            yield

    def _group(self, group):
        """One group of ``batch`` windows over the devices; yields each
        window's frames in order."""
        devs = set(self.devices) | {x.device for w in group for x in w[:3]
                                    if isinstance(x, torch.Tensor)}
        starts = {d: _event(d) for d in devs if d.type == "cuda"}
        carry = self._carry
        passes = [concurrent.futures.Future() for _ in group]

        def work(k):
            rep = self.replicas[k]
            with self._on(k):
                try:
                    I0, I1, I2 = (self._frame(x, k, starts) for x in group[k][:3])
                    nxt = rep.next_reuse(I1, I2)
                except BaseException as e:  # the next device waits on this pass
                    passes[k].set_exception(e)
                    raise
                passes[k].set_result((nxt, _event(self.devices[k])))
                if k == 0:
                    reuse10 = None if carry is None else self._hand(*carry, 0)
                else:
                    reuse10 = self._hand(*passes[k - 1].result(), k - 1, k)
                ts = group[k][3]
                frames = rep.drba_window(I0, I1, I2, ts, reuse10, nxt, linear=True) \
                    if len(ts) else []
                return frames, _event(self.devices[k])

        futures = [self._pool.submit(work, k) for k in range(len(group))]
        try:
            for k, fut in enumerate(futures):
                frames, event = fut.result()
                if event is not None:
                    stream = torch.cuda.current_stream(self.devices[k])
                    stream.wait_event(event)
                    for f in frames:
                        f.record_stream(stream)
                yield frames
        finally:
            concurrent.futures.wait(futures)
        nxt, event = passes[-1].result()
        self._carry = (nxt, event, len(group) - 1)

    def _serial(self, window):
        """One window through ``inference_ts_drba`` on the first device, the
        carry converted in."""
        device = self.devices[0]
        starts = {device: _event(device)} if device.type == "cuda" else {}
        I0, I1, I2 = (self._frame(x, 0, starts) for x in window[:3])
        frames, reuse = self.replicas[0].inference_ts_drba(I0, I1, I2, window[3], self.carry,
                                                           linear=True)
        self.carry = reuse
        return frames

    def run(self, windows):
        """``windows``: CONSECUTIVE ``(I0, I1, I2, ts)`` stream windows, the
        frames tensors or ``pipeline._Frame``s. Yields each window's frames,
        in order."""
        for start in range(0, len(windows), self.batch):
            group = windows[start:start + self.batch]
            if len(group) < self.batch:
                for window in group:
                    yield self._serial(window)
            else:
                yield from self._group(group)


def exchange_accounting(planner: WindowPlanner, windows) -> dict:
    """Run one group (the first ``planner.batch`` of ``windows``) and count
    what crossed between replicas: the chain carry at each device boundary
    (``carries``: (from, to) replica pairs; its tensors and bytes) and any
    frame copied from another device. Outputs never move. The planner's
    chain is left as it was. Stands where ``ici_accounting`` stands in the
    JAX package; the carry is counted at a boundary between two replicas
    whether or not they share a device."""
    if len(windows) < planner.batch:
        raise ValueError(f"need {planner.batch} windows for one group, got {len(windows)}")
    saved, planner._ledger = planner._carry, []
    try:
        for _ in planner.run(windows[:planner.batch]):
            pass
        ledger = planner._ledger
    finally:
        planner._carry, planner._ledger = saved, None
    # the dispatch threads append in the order they run: sort by boundary
    carries = sorted((e for e in ledger if e[0] == "carry"), key=lambda e: (e[1], e[2]))
    frames = [e for e in ledger if e[0] == "frame"]
    return {"carries": [(e[1], e[2]) for e in carries],
            "carry_tensors": sum(e[3] for e in carries),
            "carry_bytes": sum(e[4] for e in carries),
            "frames": len(frames), "frame_bytes": sum(e[4] for e in frames)}
