"""Frame loop: sliding 3-frame window with DRM interpolation
(counterpart of drba_tpu/pipeline.py; reference driver infer.py:58-174).

Head interval, body loop over (I0, I1, I2) windows with the reuse chain
carried across windows and a four-way scene-cut branch (infer.py:122-143),
tail interval. Frames stay on the model's device between windows: decoded
uint8 frames go up on a prefetch thread, finished frames come down on a small
download pool and are written in order. On a CUDA device no thread copies
between the card and pageable host memory in the steady state: such a copy
blocks the CUDA runtime until its stream reaches it, behind the window
graph, and every other thread's launches and copies wait meanwhile.

Scene detection (``enable_scdet``) scores each pair of consecutive frames by
SSIM at 32x32 (``utils.scdet.scene_ssim``). On a CUDA device the prefetch
thread uploads each frame and computes its score on a stream of its own,
then copies the score to pinned host memory and records an event; the loop
makes its stream wait on that event before it uses the frame, and resolving
a cut flag synchronises on the event alone, never on the kernels of earlier
windows. Nothing the prefetch thread calls per frame synchronises: the frame
goes up through pinned memory (``utils.imageproc``). Its stream has the
device's greatest priority, so its kernels run ahead of the window graph's
queued work, and a frame's score is ready long before the loop asks for it.
The frames and scores are what the loop's own stream would compute.

Resume (``skip_outputs``): blocks (head, windows, tail) whose outputs all lie
before the resume point run no model call; the block across it is computed
and emits only its part past the point. The first block computed gets the
reuse the uninterrupted run would hand it: the last skipped window's
I1 -> I2 pass, recomputed, where that window chained one. So a resumed run
writes the uninterrupted run's frames.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from drba_tpu_torch.utils import TMapper, get_valid_net_inp_size, to_inp, to_out
from drba_tpu_torch.utils import profiling
from drba_tpu_torch.utils.profiling import NULL
from drba_tpu_torch.utils.scdet import scene_ssim

# how long emit() may wait for a free slot before the writer counts as stalled
_STALL_S = 900.0


class _Frame:
    """A decoded frame uploaded to a device, with its scene score against the
    previous frame (None without scene detection) and, on a CUDA device, the
    event recorded on the upload stream after both. Another device that asks
    for the frame gets its own upload of the decoded frame, once, on that
    device's current stream."""

    def __init__(self, img: np.ndarray, dst_size, dtype, x: torch.Tensor, score=None,
                 event=None):
        self._img, self._size, self._dtype = img, dst_size, dtype
        self._device = x.device
        self._copies = {x.device: (x, event)}
        self._score = score
        self._event = event
        self._lock = threading.Lock()

    def take(self, device=None) -> torch.Tensor:
        """The frame on ``device`` (default: the one it was uploaded to), safe
        to use on that device's current stream."""
        device = self._device if device is None else torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            if device not in self._copies:
                x = to_inp(self._img, self._size, self._dtype, device)
                event = None
                if x.is_cuda:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(device))
                self._copies[device] = (x, event)
            x, event = self._copies[device]
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            x.record_stream(stream)
        return x

    def cut(self, threshold: float) -> bool:
        """Whether the frame starts a new scene (its score below ``threshold``);
        waits for this frame's upload and score only."""
        if self._event is not None:
            self._event.synchronize()
        return bool(self._score < threshold)


class _Prefetcher:
    """Decode + upload thread, ``depth`` frames ahead of the window loop.

    With ``prev`` (the last frame uploaded before it, as the scene
    detection's first partner) it also scores each frame against the one
    before it. On a CUDA device nothing the thread calls per frame waits for
    the card: each frame goes up through pinned memory (``to_inp``), the
    scene score needs no copy up (``ops.ssim``'s Gaussian is made once per
    device), the scores land in a ring of pinned host floats, and each frame
    carries an event (see :class:`_Frame`). The thread's stream has the
    device's greatest priority, so the card runs its few small kernels ahead
    of the window graph's pending blocks. The frames and scores are
    ``to_inp``'s and ``scene_ssim``'s, bit for bit. A decode/upload failure
    re-raises on the consuming thread at ``next()``.
    With ``tracer`` (a ``StageTimes``) it records each frame's ``read``,
    ``upload`` and ``put-wait`` spans under the frame's index in the stream
    (from 2: the loop reads the first two) and counts ``prefetch.staged``
    (frames uploaded through pinned memory, on a CUDA device).
    """

    def __init__(self, video_io, dst_size, dtype, device, prev=None, depth: int = 3,
                 tracer=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc: Optional[BaseException] = None
        device = torch.device(device)
        self._stream = None
        if device.type == "cuda":
            with torch.cuda.device(device):
                priority = torch.cuda.Stream.priority_range()[1]  # the greatest
            self._stream = torch.cuda.Stream(device, priority=priority)
            # frames in the queue, one being read, one being made: a slot is
            # free again long before the ring comes round to it
            self._scores = torch.empty(4 * depth + 4, dtype=torch.float32, pin_memory=True)
            self._ready = torch.cuda.Event()  # the frames uploaded so far, prev among them
            self._ready.record(torch.cuda.current_stream(device))
            if prev is not None:
                prev.record_stream(self._stream)
        self._tracer = tracer
        self._t = threading.Thread(target=self._loop, name="prefetch",
                                   args=(video_io, dst_size, dtype, device, prev), daemon=True)
        self._t.start()

    def _loop(self, video_io, dst_size, dtype, device, prev):
        tr = self._tracer
        try:
            if self._stream is not None:
                self._stream.wait_event(self._ready)
            i = 0
            while True:
                k = 2 + i
                with (tr.span("read", frame=k) if tr is not None else NULL) as sp:
                    frame = video_io.read_frame()
                    if frame is None and sp is not None:
                        sp.discard()
                if frame is None:
                    break
                with (tr.span("upload", frame=k) if tr is not None else NULL), \
                        (torch.cuda.stream(self._stream) if self._stream is not None else NULL):
                    x = to_inp(frame, dst_size, dtype, device)
                    score = event = None
                    if prev is not None:
                        score = scene_ssim(prev, x)
                        prev = x
                    if self._stream is not None:
                        if score is not None:
                            slot = self._scores[i % len(self._scores)]
                            score = slot.copy_(score, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                if tr is not None and self._stream is not None:
                    tr.add("prefetch.staged")
                item = _Frame(frame, dst_size, dtype, x, score, event)
                with tr.span("put-wait", frame=k) if tr is not None else NULL:
                    self._q.put(item)
                i += 1
        except Exception as e:  # re-raised by next()
            self._exc = e
        finally:
            self._q.put(None)

    def next(self) -> Optional[_Frame]:
        item = self._q.get()
        if item is None and self._exc is not None:
            raise RuntimeError("frame decode/upload thread failed") from self._exc
        return item


class _Emitter:
    """Parallel download pool + ordered writer.

    Downloads (``to_out``: resize + quantise on the device, then the copy
    through pinned memory, waited for on an event) run on ``workers``
    threads; the writer restores the order by sequence number. A semaphore
    bounds the frames in flight. ``emit`` waits for a slot with a timeout and
    raises if a download or write failed, or if no slot frees up within
    ``_STALL_S`` seconds; ``finish`` raises if the pool cannot drain.
    With ``tracer`` (a ``StageTimes``) the threads record each frame's
    ``download`` and ``write`` spans under its sequence number and block,
    and ``to_out`` the ``download``'s ``d2h-wait`` and ``copy-out``.
    """

    def __init__(self, video_io, src_size, stats, depth: int = 12, workers: int = 4,
                 tracer=None):
        self._sem = threading.Semaphore(depth)
        self._q: queue.Queue = queue.Queue()
        self._results: dict[int, tuple] = {}  # seq -> (frame or None, block)
        self._cond = threading.Condition()
        self._video_io = video_io
        self._src_size = src_size
        self._stats = stats
        self._exc: Optional[BaseException] = None
        self._seq = 0
        self._eof_seq: Optional[int] = None
        self._tracer = tracer
        self._workers = [threading.Thread(target=self._dl_loop, name=f"download-{k}", daemon=True)
                         for k in range(max(1, workers))]
        for t in self._workers:
            t.start()
        self._writer = threading.Thread(target=self._write_loop, name="writer", daemon=True)
        self._writer.start()

    def _dl_loop(self):
        tr = self._tracer
        while True:
            item = self._q.get()
            if item is None:
                return
            seq, x, block = item
            arr = None
            if self._exc is None:
                try:
                    with tr.span("download", out=seq, block=block) if tr is not None else NULL:
                        arr = to_out(x, self._src_size)
                except Exception as e:  # re-raised by emit / finish
                    self._exc = self._exc or e
            with self._cond:
                self._results[seq] = (arr, block)
                self._cond.notify_all()

    def _write_loop(self):
        tr = self._tracer
        nxt = 0
        while True:
            with self._cond:
                while nxt not in self._results:
                    if self._eof_seq is not None and nxt >= self._eof_seq:
                        return
                    self._cond.wait(timeout=1.0)
                arr, block = self._results.pop(nxt)
            seq, nxt = nxt, nxt + 1
            self._sem.release()
            if arr is not None and self._exc is None:
                try:
                    with tr.span("write", out=seq, block=block) if tr is not None else NULL:
                        self._video_io.write_frame(arr)
                    self._stats.frames_out += 1
                except Exception as e:  # re-raised by emit / finish
                    self._exc = self._exc or e

    def _check(self):
        if self._exc is not None:
            raise RuntimeError("frame download/encode thread failed") from self._exc

    def emit(self, x, block: Optional[int] = None):
        """Queue ``x`` for download and writing; ``block`` names the block
        that made it in the spans."""
        self._check()
        deadline = time.monotonic() + _STALL_S
        while not self._sem.acquire(timeout=1.0):
            self._check()
            if time.monotonic() > deadline:
                raise RuntimeError(f"emitter stalled: no frame written for {_STALL_S:.0f} s; "
                                   f"{self._stats.frames_out}/{self._seq} frames written")
        self._q.put((self._seq, x, block))
        self._seq += 1

    def finish(self):
        for _ in self._workers:
            self._q.put(None)
        for t in self._workers:
            t.join(timeout=_STALL_S)
        with self._cond:
            self._eof_seq = self._seq
            self._cond.notify_all()
        self._writer.join(timeout=_STALL_S)
        if any(t.is_alive() for t in self._workers) or self._writer.is_alive():
            raise RuntimeError("emitter could not drain (download/encode stalled); "
                               f"{self._stats.frames_out}/{self._seq} frames written")
        self._check()


def calc_ts(idx: float, t_mapper: TMapper, times: int) -> np.ndarray:
    """Window timesteps in [0.5, 1.5) centred on I1, with the reference's
    arithmetic (infer.py:76-91): times mode builds the symmetric grid around
    t = 1; fps mode maps [idx - 0.5, idx + 0.5) through TMapper."""
    if times != -1:
        if times % 2:
            k = np.arange(1, (times - 1) // 2 + 1, dtype=np.float64) / times
            return np.concatenate([(1 - k)[::-1], [1.0], 1 + k])
        k = (np.arange(times // 2, dtype=np.float64) + 0.5) / times
        return np.concatenate([(1 - k)[::-1], 1 + k])
    timestamps = np.array(t_mapper.get_range_timestamps(
        idx - 0.5, idx + 0.5, lclose=True, rclose=False, normalize=False))
    return np.round(timestamps - idx, 4) + 1


def planned_outputs(n_frames: int, src_fps: float, dst_fps: float, times: int = -1) -> int:
    """Output frames ``run_pipeline`` writes for ``n_frames`` >= 2 input frames."""
    t_mapper = TMapper(src_fps, dst_fps, times)
    windows = n_frames - 2
    return (len(calc_ts(0, t_mapper, times))
            + sum(len(calc_ts(i, t_mapper, times)) for i in range(windows))
            + len(calc_ts(windows, t_mapper, times)))


@dataclass
class PipelineStats:
    frames_in: int = 0
    frames_out: int = 0
    windows: int = 0
    scene_cuts: int = 0
    stage_report: Optional[str] = None  # with ``profile``: wall-clock per stage
    wall_s: float = 0.0  # run_pipeline wall time (decode -> compute -> encode)
    # with a recorder active (``profile``; utils/profiling.py): seconds and
    # count by ``<thread>/<span>``, the span records, the counters
    spans: Optional[dict] = None
    records: Optional[list] = None
    counters: Optional[dict] = None


def _chained(model, reuse):
    """The carried reuse of (I1, I0) as the (I0, I1) pass, where the model's
    plain call takes one (``PLAIN_PASS``); elsewhere the carry serves drba
    windows only."""
    return reuse.swapped() if reuse is not None and model.PLAIN_PASS else None


def _window(model, I0, I1, I2, ts, left_scene: bool, right_scene: bool, reuse):
    """One body window with the reference's four-way scene branch
    (infer.py:122-143). ``reuse``: the chain's reuse, which no branch with a
    cut between I0 and I1 reads. Returns (frames, the reuse the next window
    takes)."""
    if left_scene and right_scene:
        # cuts on both sides: repeat I1 (infer.py:122-124)
        return [I1] * len(ts), None
    if left_scene:
        # cut between I0 and I1: plain interpolation on the right
        # (infer.py:126-132); its I1 -> I2 pass, swapped, is the next
        # window's chain
        out, fwd = model.inference_ts(I1, I2, ts[ts >= 1] - 1, return_reuse=True)
        return [I1] * int((ts < 1).sum()) + list(out), _chained(model, fwd)
    if right_scene:
        # cut between I1 and I2: plain interpolation on the left
        # (infer.py:134-140) on the chain's I0 -> I1 pass
        return (list(model.inference_ts(I0, I1, ts[ts <= 1], reuse=_chained(model, reuse)))
                + [I1] * int((ts > 1).sum())), None
    return model.inference_ts_drba(I0, I1, I2, ts, reuse, linear=True)


def _head(model, I0, I1, ts, cut: bool):
    """The head (infer.py:93-110): source frame on the left, plain
    interpolation on the right; a cut between the first two frames repeats
    the first."""
    if cut:
        return [I0] * len(ts)
    return [I0] * int((ts < 1).sum()) + list(model.inference_ts(I0, I1, ts[ts >= 1] - 1))


def _tail(model, I0, I1, ts, reuse):
    """The tail (infer.py:158-169): plain interpolation on the left, on the
    chain's I0 -> I1 pass; source frame on the right."""
    return (list(model.inference_ts(I0, I1, ts[ts <= 1], reuse=_chained(model, reuse)))
            + [I1] * int((ts > 1).sum()))


def run_pipeline(model, video_io, progress: Optional[Callable[[int], None]] = None,
                 times: int = -1, enable_scdet: bool = False, scdet_threshold: float = 0.3,
                 profile: bool = False, skip_outputs: int = 0,
                 max_frames: Optional[int] = None) -> PipelineStats:
    """Interpolate ``video_io``'s frames into it with ``model``.

    ``video_io`` provides ``read_frame`` (HWC uint8 or None at the end),
    ``write_frame``, ``finish_writing``, ``src_fps`` and ``dst_fps``. With
    ``enable_scdet`` a pair of frames whose SSIM is below ``scdet_threshold``
    is a scene cut: no frame is interpolated across it.

    ``skip_outputs`` resumes a run whose first N output frames were written
    (``SegmentedVideoIO.completed_frames``; see the module docstring).
    ``max_frames`` stops reading after that many input frames. With
    ``profile`` a wall-clock report per stage (``window``, ``emit-wait``,
    ``prefetch-wait``, ``scdet``, ``finish``) and per span of the other
    threads and the model calls is attached to the stats, and the spans
    and counters as data (``utils/profiling.py``: the active recorder, or
    one opened over the run); kernels launch asynchronously, so ``window``
    measures the host's dispatch (on a CUDA device, once each call's key is
    warm, a graph's copies and replay: the steady-state windows', and the
    cut windows' plain calls and chain-start passes too).

    Spans name the input frame's index (``frame``: frames 0 and 1 on this
    thread, the rest on the prefetch thread; the body window that takes
    frame k as I2 is block k - 1), the block (``block``: the head 0, the
    tail last) and the output's sequence number (``out``).
    """
    with profiling.tracer() if profile else NULL:
        st = profiling.active()
        stats = _run(model, video_io, progress, times, enable_scdet, scdet_threshold,
                     skip_outputs, max_frames, st)
    if st is not None:
        stats.spans, stats.records, stats.counters = dict(st.spans), st.records, dict(st.counters)
        if profile:
            stats.stage_report = st.report()
    return stats


def _run(model, video_io, progress, times, enable_scdet, scdet_threshold, skip_outputs,
         max_frames, st) -> PipelineStats:
    """``run_pipeline``'s body; ``st`` the active recorder or None."""
    stats = PipelineStats()
    t_start = time.perf_counter()
    src_fps, dst_fps = video_io.src_fps, video_io.dst_fps
    if dst_fps <= src_fps:
        raise ValueError(f"dst fps must exceed src fps ({dst_fps} <= {src_fps})")

    with st.span("read", frame=0) if st is not None else NULL:
        i0 = video_io.read_frame()
    with st.span("read", frame=1) if st is not None else NULL:
        i1 = video_io.read_frame()
    if i0 is None or i1 is None:
        raise ValueError("video has fewer than two frames")
    stats.frames_in = 2

    size = get_valid_net_inp_size(i0, model.scale, div=model.pad_size)
    src_size, dst_size = size["src_size"], size["dst_size"]
    dtype, device = model.config.compute_dtype, model.device
    with st.span("upload", frame=0) if st is not None else NULL:
        I0 = to_inp(i0, dst_size, dtype, device)
    with st.span("upload", frame=1) if st is not None else NULL:
        I1 = to_inp(i1, dst_size, dtype, device)
        # the head's cut flag, on this thread before any window is queued (its
        # kernels are then loaded before the prefetch thread scores a frame)
        left_scene = enable_scdet and bool(scene_ssim(I0, I1) < scdet_threshold)

    t_mapper = TMapper(src_fps, dst_fps, times)
    idx = 0
    pinned = st is not None and torch.device(device).type == "cuda"
    host_allocs = torch.cuda.host_memory_stats().get("num_host_alloc", 0) if pinned else 0
    prefetch = _Prefetcher(video_io, dst_size, dtype, device, prev=I1 if enable_scdet else None,
                           tracer=st)
    emitter = _Emitter(video_io, src_size, stats, tracer=st)

    plan_pos = 0  # output frames planned so far, skipped and emitted

    def emit_block(n_planned, build, block: int) -> bool:
        """Plan ``n_planned`` frames; build and emit the part past
        ``skip_outputs``. Returns False for a block skipped whole (``build``
        not called)."""
        nonlocal plan_pos
        start = plan_pos
        plan_pos += n_planned
        if plan_pos <= skip_outputs:
            return False
        with st.stage("window", block=block) if st is not None else NULL:
            frames = build()
        if len(frames) != n_planned:
            raise RuntimeError(f"window produced {len(frames)} frames, planned {n_planned}")
        with st.stage("emit-wait", block=block) if st is not None else NULL:
            for x in frames[max(0, skip_outputs - start):]:
                emitter.emit(x, block)
        return True

    reuse = None  # the reuse the next window takes
    # resume: (I1, I2, plain) of the last skipped window whose I1 -> I2 pass
    # is the chain (``plain``: a window with a cut between I0 and I1)
    skipped_pass = None

    def chain():
        """The chain's reuse; after skipped windows, the last one's pass,
        recomputed as the uninterrupted run computed it."""
        nonlocal reuse, skipped_pass
        if skipped_pass is not None:
            a, b, plain = skipped_pass
            skipped_pass = None
            reuse = model.next_reuse(a, b)
            if plain and not model.PLAIN_PASS:
                reuse = None  # a plain window hands on a pass only where it runs one
        return reuse

    ts = calc_ts(idx, t_mapper, times)
    stats.scene_cuts += int(left_scene)
    emit_block(len(ts), lambda: _head(model, I0, I1, ts, left_scene), 0)
    if progress:
        progress(1)

    # body (infer.py:112-156)
    while max_frames is None or stats.frames_in < max_frames:
        k = stats.frames_in  # the frame this window takes as I2; the window is block k - 1
        with st.stage("prefetch-wait", frame=k, block=k - 1) if st is not None else NULL:
            item = prefetch.next()
        if item is None:
            break
        I2 = item.take()
        with st.stage("scdet", frame=k, block=k - 1) if st is not None else NULL:
            right_scene = enable_scdet and item.cut(scdet_threshold)
        stats.frames_in += 1
        stats.scene_cuts += int(right_scene)
        ts = calc_ts(idx, t_mapper, times)

        def build(I0=I0, I1=I1, I2=I2, ts=ts, ls=left_scene, rs=right_scene):
            nonlocal reuse
            frames, reuse = _window(model, I0, I1, I2, ts, ls, rs, None if ls else chain())
            return frames

        if not emit_block(len(ts), build, k - 1):
            # skipped: the chain the uninterrupted run leaves behind it
            reuse = skipped_pass = None
            if not right_scene and not left_scene:
                skipped_pass = (I1, I2, False)
            elif not right_scene and (ts >= 1).any():
                skipped_pass = (I1, I2, True)
        I0, I1 = I1, I2
        left_scene = right_scene
        idx += 1
        stats.windows += 1
        if progress:
            progress(1)

    ts = calc_ts(idx, t_mapper, times)
    emit_block(len(ts), lambda: _tail(model, I0, I1, ts, chain()), idx + 1)
    if progress:
        progress(1)

    with st.stage("finish") if st is not None else NULL:
        emitter.finish()
        video_io.finish_writing()
    if pinned:
        st.add("pinned.host_allocs",
               torch.cuda.host_memory_stats().get("num_host_alloc", 0) - host_allocs)
    stats.wall_s = time.perf_counter() - t_start
    return stats
