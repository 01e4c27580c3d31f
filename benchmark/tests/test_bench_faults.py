"""A run of the benchmark with the timed path broken underneath comes out
not correct; a sound one and the control at a small size, on the CPU.

Each test drives what ``run.py`` drives, past its look for a card: set-up,
the window (a few seconds), the plan and the check. The faults
(``benchmark/faults.py``) sit in the program, where its answers are made: a
window handing back its input frame unchanged, half of a window's timesteps
left out, a frame altered as it is made, the reuse chain's state handed on
unchanged, scene detection that finds no cut, and scene detection that
finds each cut one pair late. (The cells run on one chip: no exchange
between chips to leave out.)
"""

import pytest

from benchmark import cells, faults, harness

# large enough that the seeded IFNet's flows (about 12 px) carry the
# frames, as at 1080p
SIZE = (256, 448)
# GMFSS_UNION's nets are slower on the CPU
UNION_SIZE = (128, 256)
# scene detection needs no flow, and a small frame lets the window reach cuts
CUTS_SIZE = (64, 128)
SECONDS = 8.0


def _cell(name):
    cell = cells.load(name)
    cell.traffic["warmup_shot_frames"] = [3, 4, 3]  # the CPU captures no graph
    return cell


def _verdict(cell, fault=None, seed=2**31 + 19, control=False, size=SIZE):
    run = harness.Run(_cell(cell), seed, "cpu", frame_size=size, fault=fault)
    try:
        run.setup()
        run.window(SECONDS, False)
        run.end_to_end()
        run.free_program()
        checks = run.judge(control=control)
    finally:
        run.cleanup()
    return all(v <= lim for v, lim in checks.values()), checks


def test_sound_run_is_correct():
    ok, checks = _verdict("rife-1080p-fastcut")
    assert ok, checks


@pytest.mark.parametrize("cell,fault,check,size", [
    ("rife-1080p-fastcut", "frames_unchanged", "frame_bad_px", SIZE),
    ("rife-1080p-fastcut", "half_the_timesteps", "frame_bad_px", SIZE),
    ("rife-1080p-fastcut", "altered_frame", "frame_bad_px", SIZE),
    ("rife-1080p-fastcut", "stale_chain", "frame_bad_px", SIZE),
    ("rife-1080p-fastcut", "blind_scene_detection", "cuts_off_reference", CUTS_SIZE),
    ("rife-1080p-fastcut", "shifted_scene_detection", "copy_bad_px", CUTS_SIZE),
    ("union-1080p-tv", "altered_frame", "frame_bad_px", UNION_SIZE),
    ("union-1080p-tv", "stale_chain", "frame_bad_px", UNION_SIZE)])
def test_faults_are_not_correct(cell, fault, check, size):
    ok, checks = _verdict(cell, faults.FAULTS[fault], size=size)
    assert not ok
    value, limit = checks[check]
    assert value > limit, checks


@pytest.mark.parametrize("cell,size", [("rife-1080p-tv", SIZE),
                                       ("union-1080p-tv", UNION_SIZE)])
def test_control_is_not_correct(cell, size):
    """The reference with its products in float8, in the program's place
    where frames are compared: the run's check says not correct."""
    ok, checks = _verdict(cell, control=True, size=size)
    assert not ok
    value, limit = checks["frame_bad_px"]
    assert value > limit, checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["rife-1080p-tv", "union-1080p-tv"])
def test_control_is_not_correct_on_the_card(cell, cuda):
    """The same at the cell's own 1080p size on the card, one seed; the
    program's own frames pass."""
    run = harness.Run(cells.load(cell), 2**31 + 29, cuda)
    try:
        run.setup()
        run.window(SECONDS, False)
        run.end_to_end()
        run.free_program()
        control = run.judge(control=True)
        checks = run.verdict(run.source.frames_kept())
    finally:
        run.cleanup()
    assert all(v <= lim for v, lim in checks.values()), checks
    assert control["frame_bad_px"][0] > control["frame_bad_px"][1], control
