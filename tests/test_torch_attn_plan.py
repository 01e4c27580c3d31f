"""The Python side of the port's attention kernels that the CPU reaches.

* The key split of the flash kernel (drba_tpu_torch.ops.attention):
  ``flash_split_plan``, and the kernel's two launches written in plain
  PyTorch (``flash_partials``, ``flash_combine``), held against
  drba_tpu's ``flash_attention_mxu`` (its Pallas kernel in interpret mode,
  as tests/test_attn_mxu.py runs it) with L not a multiple of the 64-key
  tile, masked and unmasked, including rows for which a whole split has no
  live key.
* The roofline bounds of drba_tpu_torch.bounds against hand counts, one
  path shape per kernel row, and the f32 products' "tf32x3" type.

Inputs come from numpy seeds; comparisons in float32.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drba_tpu.ops.attn_mxu import flash_attention_mxu
from drba_tpu_torch import bounds
from drba_tpu_torch.ops import attention as attn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this file's small PyTorch CPU ops on one thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------------------ the key split


@pytest.mark.parametrize("b,L,sms,want", [
    (1, 8160, 132, (8, 16)),   # GMFlow's global correlation, one direction: 64 query blocks
    (2, 8160, 132, (5, 26)),   # both directions stacked
    (4, 8160, 132, (3, 43)),
    (9, 8160, 132, (1, 128)),  # enough query blocks: no split
    (1, 100, 132, (2, 1)),     # never more splits than key tiles
    (1, 1100, 16, (6, 3)),
])
def test_flash_split_plan(b, L, sms, want):
    n, per = attn.flash_split_plan(b, L, sms)
    assert (n, per) == want
    k_tiles = math.ceil(L / attn.TILE)
    # every split holds at least one key tile, and the splits cover all of them
    assert 1 <= n <= attn.MAX_SPLITS and (n - 1) * per < k_tiles <= n * per


def _rid(kind, rng, b, L):
    if kind == "none":
        return None
    if kind == "random":
        return rng.integers(0, 3, (b, L)).astype(np.int32)
    # region 0 lies in the first key tile only: its rows have no live key in
    # any later split (m = -1e30, l = 0 there)
    rid = np.ones((b, L), np.int32)
    rid[:, :40] = 0
    return rid


@pytest.mark.parametrize("n_split", [1, 3, 5])
@pytest.mark.parametrize("mask", ["none", "random", "first_tile"])
def test_flash_split_matches_jax_kernel(mask, n_split):
    """L = 1100 (18 key tiles, the last one ragged) split into n_split runs."""
    rng = np.random.default_rng(10)
    b, L = 2, 1100
    q, k = (rng.normal(size=(b, L, 128)).astype(np.float32) * 0.3 for _ in range(2))
    v = rng.uniform(0, 60, (b, L, 2)).astype(np.float32)
    rid = _rid(mask, rng, b, L)
    tiles = math.ceil(math.ceil(L / attn.TILE) / n_split)
    assert math.ceil(math.ceil(L / attn.TILE) / tiles) == n_split
    dead = None if rid is None else attn._rid_dead(torch.from_numpy(rid))
    part = attn.flash_partials(*map(torch.from_numpy, (q, k, v)), dead, n_split, tiles)
    assert tuple(part.shape) == (n_split, b, L, 4) and part.dtype == torch.float32
    if mask == "first_tile" and n_split > 1:
        rows0 = torch.from_numpy(rid == 0)
        assert bool((part[1:, rows0][..., 0] == -1e30).all())
        assert bool((part[1:, rows0][..., 1:] == 0).all())
    got = attn.flash_combine(part)
    want = flash_attention_mxu(*map(jnp.asarray, (q, k, v)),
                               None if rid is None else jnp.asarray(rid),
                               with_mask=rid is not None, out_dtype=jnp.float32)
    # values up to 60 px: f32 sums of 1100 weights in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    plain = attn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 None if rid is None else torch.from_numpy(rid), rid is not None,
                                 out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------------- the bounds


def _check(work, bytes_, ops, ms, by):
    assert work.bytes == pytest.approx(bytes_, rel=1e-12)
    assert work.ops == pytest.approx(ops, rel=1e-12)
    got_ms, got_by = bounds.bound_ms(work)
    assert got_ms == pytest.approx(ms, rel=1e-9) and got_by == by


def test_bound_splat_flow_inversion():
    """RIFE's flow inversion: (2, 1088, 1920, 2) bf16 flows splat along
    themselves, avg with coverage; the weight channel's multiply-adds too."""
    px = 2 * 1088 * 1920
    _check(bounds.splat_work(2, 1088, 1920, 2, 2, 2, coverage=True),
           px * (2 * 2 + 2 * 2 + 3 * 2), {"f32": 2 * 4 * 3 * px}, px * 14 / 3.35e12 * 1e3,
           "bytes")
    # a soft splat reads the metric too; f32 values, bf16 flow and metric
    soft = bounds.splat_work(6, 272, 480, 1, 4, 2, metric_itemsize=2, coverage=True)
    assert soft.bytes == 6 * 272 * 480 * (4 + 4 + 2 + 2 * 4)


def test_bound_warp_full_res_and_tap_grid():
    px = 3 * 1088 * 1920
    # k = 1: image, flow and output once each
    _check(bounds.warp_work(3, 1088, 1920, 19, 1, 2), px * (19 * 2 + 2 * 2 + 19 * 2),
           {"f32": 2 * 4 * 19 * px}, px * 80 / 3.35e12 * 1e3, "bytes")
    # k = 8: 4 taps per 8x8 cell; the caller's count of touched pixels
    samples = 4 * 3 * 136 * 240
    want = 1000 * 19 * 2 + samples * 2 * 2 + 3 * 136 * 240 * 19 * 2
    _check(bounds.warp_work(3, 1088, 1920, 19, 8, 2, touched=1000), want,
           {"f32": 2 * 4 * 19 * samples}, want / 3.35e12 * 1e3, "bytes")


def test_bound_block_output():
    """An IFBlock's output at 1088x1920, T = 3, bf16: the lastconv's 56
    channels at half the block's resolution read once, 13 channels written
    and, past block 0, the running 4-channel flow read; downsampling (a
    block above the full resolution) reads at most the 2 x 2 taps."""
    px = 3 * 1088 * 1920
    _check(bounds.block_output_work(3, 34, 60, 56, 1088, 1920, 2, False),
           3 * 34 * 60 * 56 * 2 + px * 13 * 2, {}, (3 * 34 * 60 * 112 + px * 26) / 3.35e12 * 1e3,
           "bytes")
    _check(bounds.block_output_work(3, 544, 960, 56, 1088, 1920, 2, True),
           3 * 544 * 960 * 112 + px * 17 * 2, {}, (3 * 544 * 960 * 112 + px * 34) / 3.35e12 * 1e3,
           "bytes")
    assert bounds.block_output_work(1, 100, 100, 56, 10, 10, 4, False).bytes == \
        4 * 100 * 56 * 4 + 100 * 13 * 4


def test_warp_touched_counts_clamped_corners():
    h, w = 2, 3
    x = np.arange(w, dtype=np.float32)[None, None, :].repeat(h, 1)
    y = np.arange(h, dtype=np.float32)[None, :, None].repeat(w, 2)
    assert bounds.warp_touched(x, y, h, w) == h * w            # every pixel
    assert bounds.warp_touched(x + 10, y, h, w) == h           # all clamped to the last column
    assert bounds.warp_touched(np.stack([x[0], x[0] + 10]), np.stack([y[0], y[0]]), h, w) \
        == h * w + h                                           # two images


def test_warp_touched_counts_a_shared_frame_once():
    h, w = 2, 3
    x = np.arange(w, dtype=np.float32)[None, None, :].repeat(h, 1)
    y = np.arange(h, dtype=np.float32)[None, :, None].repeat(w, 2)
    px, py = np.concatenate([x, x, x + 10]), np.concatenate([y, y, y])
    assert bounds.warp_touched(px, py, h, w) == 2 * h * w + h
    # planes 0 and 1 read one frame (a batch stride of 0), plane 2 another
    assert bounds.warp_touched(px, py, h, w, frames=[0, 0, 1]) == h * w + h
    # all three read one frame: the clamped column is among its pixels
    assert bounds.warp_touched(px, py, h, w, frames=[0, 0, 0]) == h * w


def test_bound_conv3x3_step():
    """One IFNet ResConv step (3, 68, 120, 96) in bf16: tensor-core bound."""
    px = 3 * 68 * 120
    ops = 2 * 9 * 96 * 96 * px
    _check(bounds.conv3x3_work(3, 68, 120, 96, 96, 2),
           px * (96 + 96) * 2 + (96 * 96 * 9 + 2 * 96) * 2, {"bf16": ops},
           ops / 989e12 * 1e3, "operations")


def test_bound_window_attention_scale0():
    """(2, 68, 120, 128) k = 2: 8 windows of L = 2040, 4 L^2 c each."""
    pairs = 8 * 2040 ** 2
    ops = 4 * pairs * 128
    assert ops == pytest.approx(17.0459e9, rel=1e-5)
    _check(bounds.attention_work(8, 2040, 2), 4 * 8 * 2040 * 128 * 2, {"bf16": ops},
           ops / 989e12 * 1e3, "operations")
    # masked: only the live pairs, plus the labels
    _check(bounds.attention_work(8, 2040, 2, pairs=1000, labels=68 * 120),
           4 * 8 * 2040 * 128 * 2 + 4 * 68 * 120, {"bf16": 4 * 1000 * 128},
           (4 * 8 * 2040 * 128 * 2 + 4 * 68 * 120) / 3.35e12 * 1e3, "bytes")


def test_bound_window_attention_in_layer_scale1():
    """The layer's launch at scale 1 reads q|k|v from the (4, 136, 240, 384)
    projection: memory-bound."""
    tokens = 4 * 136 * 240
    moved = tokens * 384 * 2 + tokens * 128 * 2 + 4 * 136 * 240
    _check(bounds.attention_work(256, 510, 2, pairs=100, labels=136 * 240,
                                 qkv_bytes=tokens * 384 * 2),
           tokens * 384 * 2 + tokens * 128 * 2 + 4 * 136 * 240, {"bf16": 4 * 100 * 128},
           moved / 3.35e12 * 1e3, "bytes")


def test_bound_flash():
    """(1, 8160) bf16 q, k and an f32 2-wide value: q k^T on tensor cores,
    P v on the FMA pipes."""
    L = 8160
    _check(bounds.attention_work(1, L, 2, value_width=2),
           2 * L * 128 * 2 + 2 * L * 2 * 4, {"bf16": 2 * L * L * 128, "f32": 2 * L * L * 2},
           2 * L * L * 128 / 989e12 * 1e3, "operations")


def test_bound_transformer_layer():
    """Scale-1 self layer (4, 136, 240, 128) k = 8, bf16: x in, out, the
    q|k|v and merge weights, norm1; projection, attention and merge."""
    tokens = 4 * 136 * 240
    pairs = 4 * 64 * 510 ** 2
    macs = tokens * (128 * 384 + 128 * 128) + pairs * 2 * 128
    moved = tokens * 128 * 2 * 2 + (128 * 384 + 128 * 128) * 2 + 2 * 128 * 4
    _check(bounds.layer_work(4, 136, 240, 8, 2), moved, {"bf16": 2 * macs},
           2 * macs / 989e12 * 1e3, "operations")
    # the cross layer reads the target too and adds the 256 -> 1024 -> 128 FFN
    cross = bounds.layer_work(4, 136, 240, 8, 2, hidden=1024, cross=True, pairs=pairs,
                              labels=136 * 240)
    assert cross.bytes == moved + tokens * 128 * 2 + (256 * 1024 + 1024 * 128) * 2 \
        + 2 * 128 * 4 + 4 * 136 * 240
    assert cross.ops["bf16"] == 2 * (macs + tokens * (256 * 1024 + 1024 * 128))


def _tf32x3_ms(ops):
    """Three TF32 tensor-core operations per f32 operation, at 494.7 TFLOP/s."""
    return 3 * ops / 494.7e12 * 1e3


def test_bound_f32_window_attention_on_tensor_cores():
    """The f32 scale-0 windows: q k^T and P v are "tf32x3" products, three
    TF32 passes each (bf16's case above, in 4-byte values)."""
    ops = 4 * 8 * 2040 ** 2 * 128
    _check(bounds.attention_work(8, 2040, 4), 4 * 8 * 2040 * 128 * 4, {"tf32x3": ops},
           _tf32x3_ms(ops), "operations")
    assert bounds.PEAK_OPS_PER_S["tf32x3"] == pytest.approx(494.7e12 / 3, rel=1e-12)


def test_bound_f32_flash():
    """f32 flash: q k^T on the tensor cores in 3xTF32, the 2-wide P v still
    on the FMA pipes; the tensor cores bound it."""
    L = 8160
    _check(bounds.attention_work(1, L, 4, value_width=2),
           2 * L * 128 * 4 + 2 * L * 2 * 4, {"tf32x3": 2 * L * L * 128, "f32": 2 * L * L * 2},
           _tf32x3_ms(2 * L * L * 128), "operations")


def test_bound_f32_transformer_layer_and_conv():
    """The f32 layer's and conv's products count as "tf32x3"; their bytes
    are bf16's doubled."""
    tokens = 4 * 136 * 240
    pairs = 4 * 64 * 510 ** 2
    macs = tokens * (128 * 384 + 128 * 128) + pairs * 2 * 128
    moved = tokens * 128 * 4 * 2 + (128 * 384 + 128 * 128) * 4 + 2 * 128 * 4
    _check(bounds.layer_work(4, 136, 240, 8, 4), moved, {"tf32x3": 2 * macs},
           _tf32x3_ms(2 * macs), "operations")
    px = 3 * 68 * 120
    ops = 2 * 9 * 96 * 96 * px
    _check(bounds.conv3x3_work(3, 68, 120, 96, 96, 4),
           px * (96 + 96) * 4 + (96 * 96 * 9 + 2 * 96) * 4, {"tf32x3": ops}, _tf32x3_ms(ops),
           "operations")


def test_live_pairs():
    assert bounds.live_pairs([[0, 0, 1], [2, 2, 2]]) == 2 * 2 + 1 + 3 * 3
    lab = np.zeros((4, 34, 60), np.int32)
    assert bounds.live_pairs(lab) == 4 * 2040 ** 2
