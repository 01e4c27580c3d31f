"""Faults planted in the program under a run, for the checks to catch.

Each fault breaks the timed path where its answers are made: ``plant(model)``
patches the model the run built (or the frame loop's scene score) and
returns a function that takes the patch out again. ``control.py --fault``
reads a fault on the card; ``tests/test_bench_faults.py`` holds each to
``correct`` coming out false on the CPU. (The cells run on one chip: there
is no exchange between chips to leave out.)
"""

from __future__ import annotations

import torch


def _wrap_window(model, change):
    """Patch ``model.inference_ts_drba`` through ``change(orig, *args)``."""
    orig = model.inference_ts_drba

    def window(I0, I1, I2, ts, reuse=None, linear=False):
        return change(orig, I0, I1, I2, ts, reuse, linear)

    model.inference_ts_drba = window
    return lambda: model.__dict__.pop("inference_ts_drba", None)


def frames_unchanged(model):
    """Each DRM window hands back its middle frame for every timestep."""
    def change(orig, I0, I1, I2, ts, reuse, linear):
        frames, nxt = orig(I0, I1, I2, ts, reuse, linear=linear)
        return [I1] * len(frames), nxt

    return _wrap_window(model, change)


def half_the_timesteps(model):
    """Half of a window's timesteps computed; the rest repeat the last."""
    def change(orig, I0, I1, I2, ts, reuse, linear):
        frames, nxt = orig(I0, I1, I2, ts[:(len(ts) + 1) // 2], reuse, linear=linear)
        return frames + [frames[-1]] * (len(ts) - len(frames)), nxt

    return _wrap_window(model, change)


def altered_frame(model):
    """A window's first frame mirrored where it is made."""
    def change(orig, I0, I1, I2, ts, reuse, linear):
        frames, nxt = orig(I0, I1, I2, ts, reuse, linear=linear)
        frames = list(frames)
        frames[0] = frames[0].flip(2)
        return frames, nxt

    return _wrap_window(model, change)


def stale_chain(model):
    """The state a DRM window hands on is the one it took: the reuse chain
    carries its start's passes unchanged."""
    def change(orig, I0, I1, I2, ts, reuse, linear):
        frames, nxt = orig(I0, I1, I2, ts, reuse, linear=linear)
        return frames, nxt if reuse is None else reuse

    return _wrap_window(model, change)


def _patch_scene_score(score):
    import drba_tpu_torch.pipeline as pipeline

    saved = pipeline.scene_ssim
    pipeline.scene_ssim = score(saved)

    def restore():
        pipeline.scene_ssim = saved

    return restore


def blind_scene_detection(model):
    """Every pair scores an SSIM of 1: no cut is found."""
    return _patch_scene_score(lambda orig: lambda a, b: torch.ones((), device=a.device))


def shifted_scene_detection(model):
    """Each pair gets the score of the pair before it: as many cuts as the
    stream has, each one pair late."""
    def score(orig):
        last = []

        def shifted(a, b):
            s = orig(a, b)
            prev = last[0] if last else torch.ones((), device=a.device)
            last[:] = [s]
            return prev

        return shifted

    return _patch_scene_score(score)


FAULTS = {f.__name__: f for f in (frames_unchanged, half_the_timesteps, altered_frame,
                                   stale_chain, blind_scene_detection, shifted_scene_detection)}
