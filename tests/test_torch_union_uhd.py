"""GMFSS_UNION on the 4K configuration's path (``gmfss-union-2160p``: flow
scale 0.5, padded to multiples of 256 so that the half-resolution IFNet at
scale 0.5 sees multiples of 64) through the port's normal entry point,
``drba_tpu_torch.pipeline.run_pipeline``, judged by the benchmark's frozen
reference (``benchmark/reference``) with the benchmark's own check
(``benchmark/harness.Run.judge``), on the CPU.

The run is the cell's ``union-2160p-tv`` on its seeded ``tv-shots-uhd``
stream, at 128x256 frames (256x256 on the network), in float32, so that the
program and the reference compute in the same precision. A planted case
holds the check to its job: the program at flow scale 1.0, judged by a
reference at 0.5, comes out not correct.
"""

import dataclasses
import functools

import pytest
import torch

from benchmark import cells, harness
from drba_tpu_torch import cli, config

CELL = "union-2160p-tv"
SIZE = (128, 256)
SEED = 2**31 + 41
SECONDS = 6.0


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _judged(monkeypatch, program_scale=None):
    """(checks, the run) of the cell at ``SIZE`` in float32; with
    ``program_scale`` the program's model is built at that flow scale
    while the reference keeps the configuration's."""
    cell = cells.load(CELL)
    cell = dataclasses.replace(cell, config={**cell.config, "dtype": "float32"},
                               traffic={**cell.traffic, "warmup_shot_frames": [3, 4, 3]})
    monkeypatch.setattr(config, "Config", functools.partial(config.Config,
                                                            compute_dtype=torch.float32))
    if program_scale is not None:
        load = cli.load_model
        monkeypatch.setattr(cli, "load_model", lambda model_type, root, scale, *a, **k:
                            load(model_type, root, program_scale, *a, **k))
    run = harness.Run(cell, SEED, "cpu", frame_size=SIZE)
    try:
        run.setup()
        run.window(SECONDS, False)
        run.end_to_end()
        run.free_program()
        checks = run.judge()
    finally:
        run.cleanup()
    return checks, run


def test_scale_half_path_is_correct(monkeypatch):
    checks, run = _judged(monkeypatch)
    assert run.cfg["scale"] == 0.5 and run.size == (256, 256)
    assert run.stats.windows >= 2 and run.stats.frames_out > 0
    assert all(v <= limit for v, limit in checks.values()), checks
    # in float32 the program's frames are the reference's: no value more
    # than 2 levels off in any frame compared
    assert max(bad for *_, bad, _ in run.compared) == 0.0, run.compared


def test_program_at_scale_one_is_not_correct(monkeypatch):
    checks, _ = _judged(monkeypatch, program_scale=1.0)
    value, limit = checks["frame_bad_px"]
    assert value > limit, checks
