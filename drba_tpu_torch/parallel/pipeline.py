"""Multi-device frame loop (counterpart of drba_tpu/parallel/pipeline.py).

The serial loop's prefetch thread, download pool and cut flags
(``pipeline._Prefetcher``, ``_Emitter``, ``_Frame.cut``) around the window
planner (``parallel/batch.py``): consecutive clean windows gather into
groups of one window per device, and each window with a scene cut runs the
serial loop's branch (``pipeline._window``) at its place in the stream, on
the first device. The reuse chain is handed on as the serial loop hands it:
after a cut between I0 and I1 that window's forward pass is the next carry,
after a cut between I1 and I2 the chain restarts. So the output is the
serial ``run_pipeline``'s.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from drba_tpu_torch.parallel.batch import WindowPlanner
from drba_tpu_torch.pipeline import (PipelineStats, _Emitter, _Frame, _head, _Prefetcher, _tail,
                                     _window, calc_ts)
from drba_tpu_torch.utils import TMapper, get_valid_net_inp_size, to_inp
from drba_tpu_torch.utils.scdet import scene_ssim


def run_pipeline_parallel(model, video_io, devices, progress: Optional[Callable[[int], None]] = None,
                          times: int = -1, enable_scdet: bool = False,
                          scdet_threshold: float = 0.3) -> PipelineStats:
    """``run_pipeline`` with the clean windows spread over ``devices`` (one
    replica of ``model`` each; ``parallel.make_devices``)."""
    stats = PipelineStats()
    t_start = time.perf_counter()
    src_fps, dst_fps = video_io.src_fps, video_io.dst_fps
    if dst_fps <= src_fps:
        raise ValueError(f"dst fps must exceed src fps ({dst_fps} <= {src_fps})")

    planner = WindowPlanner(devices, model)
    try:
        main = planner.replicas[0]
        i0, i1 = video_io.read_frame(), video_io.read_frame()
        if i0 is None or i1 is None:
            raise ValueError("video has fewer than two frames")
        stats.frames_in = 2

        size = get_valid_net_inp_size(i0, main.scale, div=main.pad_size)
        src_size, dst_size = size["src_size"], size["dst_size"]
        dtype, device = main.config.compute_dtype, main.device
        F0 = _Frame(i0, dst_size, dtype, to_inp(i0, dst_size, dtype, device))
        F1 = _Frame(i1, dst_size, dtype, to_inp(i1, dst_size, dtype, device))
        I0, I1 = F0.take(), F1.take()

        t_mapper = TMapper(src_fps, dst_fps, times)
        idx = 0
        left_scene = enable_scdet and bool(scene_ssim(I0, I1) < scdet_threshold)
        prefetch = _Prefetcher(video_io, dst_size, dtype, device,
                               prev=I1 if enable_scdet else None)
        emitter = _Emitter(video_io, src_size, stats)

        def emit(frames, n_planned):
            if len(frames) != n_planned:
                raise RuntimeError(f"window produced {len(frames)} frames, planned {n_planned}")
            for x in frames:
                emitter.emit(x)
            if progress:
                progress(1)

        ts = calc_ts(idx, t_mapper, times)
        stats.scene_cuts += int(left_scene)
        emit(_head(main, I0, I1, ts, left_scene), len(ts))

        reuse = None  # the reuse the next window takes
        group = []  # clean windows waiting for a device each

        def drain():
            nonlocal reuse
            if group:
                planner.carry = reuse
                for frames, window in zip(planner.run(group), group):
                    emit(frames, len(window[3]))
                reuse = planner.carry
                group.clear()

        while True:
            item = prefetch.next()
            if item is None:
                break
            right_scene = enable_scdet and item.cut(scdet_threshold)
            stats.frames_in += 1
            stats.scene_cuts += int(right_scene)
            ts = calc_ts(idx, t_mapper, times)
            if left_scene or right_scene:
                drain()
                frames, reuse = _window(main, F0.take(), F1.take(), item.take(), ts, left_scene,
                                        right_scene, reuse)
                emit(frames, len(ts))
            else:
                group.append((F0, F1, item, ts))
                if len(group) == planner.batch:
                    drain()
            F0, F1 = F1, item
            left_scene = right_scene
            idx += 1
            stats.windows += 1
        drain()

        ts = calc_ts(idx, t_mapper, times)
        emit(_tail(main, F0.take(), F1.take(), ts, reuse), len(ts))
        emitter.finish()
        video_io.finish_writing()
    finally:
        planner.close()
    stats.wall_s = time.perf_counter() - t_start
    return stats
