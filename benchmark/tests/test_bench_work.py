"""The benchmark's copy of the work arithmetic against the program's
``bounds.py``, at RIFE's T=3 window shapes; the union's FLOPs at a flow
scale; and the per-layer readers on a hand-made trace."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import cells, trace, work
from benchmark.reference import models
from benchmark.reference.nn import recording


def _recorded(kind="window", T=3):
    cfg = cells.load("rife-1080p-tv").config
    ref = models.Reference(cfg, work._meta_params(models.specs("rife"), torch.bfloat16))
    I0, I1, I2 = (torch.empty((1, 1088, 1920, 3), device="meta", dtype=torch.bfloat16)
                  for _ in range(3))
    ts = torch.empty(T, device="meta")
    reuse10 = ref.chain_reuse(I0, I1, chain_start=False)
    with recording() as (warps, splats):
        pass12 = ref.flow_pass(I1, I2, reuse10[2])
        ref.window(I0, I1, I2, ts, reuse10, pass12)
    return warps, splats


def test_splat_and_warp_bytes_match_bounds():
    from drba_tpu_torch import bounds

    warps, splats = _recorded()
    # the window's pass inverts both flows in one splat; the DRM aligns both
    # maps in one, at half resolution; IFNet warps both directions per stage
    assert len(splats) == 2 and len(warps) == 10
    for s in splats:
        a, b = work.splat_work(**s), bounds.splat_work(**s)
        assert a.bytes == b.bytes and a.ops == b.ops
    for w in warps:
        a, b = work.warp_work(**w), bounds.warp_work(**w)
        assert a.bytes == b.bytes and a.ops == b.ops
    assert work.MEM_BYTES_PER_S == bounds.MEM_BYTES_PER_S
    assert work.PEAK_OPS_PER_S == bounds.PEAK_OPS_PER_S


def test_splat_shapes_at_t3():
    _, splats = _recorded()
    # the flow inversion of the (I1, I2) pass: both directions, IFNet block
    # 0's flow at full resolution, bf16; the DRM's two f32 maps at T=3, half
    # resolution
    assert splats[0] == {"n": 2, "h": 1088, "w": 1920, "c": 2, "itemsize": 2, "flow_itemsize": 2,
                         "metric_itemsize": 0, "coverage": True}
    assert splats[1] == {"n": 6, "h": 544, "w": 960, "c": 1, "itemsize": 4, "flow_itemsize": 4,
                         "metric_itemsize": 0, "coverage": True}


def test_union_flow_scale_counts_gmflow_on_the_scaled_pair(monkeypatch):
    """A union window on 2160p frames (padded to 2304x3840) counts fewer
    FLOPs at ``-scale 0.5`` than at 1.0, and the part GMFlow adds at 0.5 is
    ``gmflow.apply`` counted alone on the half-resolution pair halved again
    (IFNet's scale list moves with the scale too, so only GMFlow's part is
    compared)."""
    from benchmark.reference import gmflow

    cfg = cells.load("union-1080p-tv").config
    size = (2304, 3840)
    flops = {s: work.call_work({**cfg, "scale": s}, "window", 2, size).flops for s in (0.5, 1.0)}
    assert flops[0.5] < flops[1.0]
    pairs = []

    def no_gmflow(p, img0, img1):
        pairs.append(tuple(img0.shape))
        return torch.empty((2 * img0.shape[0], *img0.shape[1:3], 2), device="meta",
                           dtype=img0.dtype)

    monkeypatch.setattr(gmflow, "apply", no_gmflow)
    without = work.call_work({**cfg, "scale": 0.5}, "window", 2, size).flops
    monkeypatch.undo()
    assert set(pairs) == {(1, 576, 960, 3)}
    params = work._meta_params({"flownet": gmflow.spec()}, torch.bfloat16)["flownet"]
    img = torch.empty((1, 576, 960, 3), device="meta", dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        gmflow.apply(params, img, img)
    assert flops[0.5] - without == fc.get_total_flops() > 0


def _trace():
    cfg = cells.load("rife-1080p-tv").config
    w3 = work.call_work(cfg, "window", 3, (1088, 1920))
    t = trace.Trace(stages={"prefetch-wait": (0.5, 11), "emit-wait": (1.0, 11), "scdet": (0.2, 10)},
                    windows=10, window_s=2.0, work={("window", 3): w3})
    t.calls = [trace.Call("window", 3, 0.001, None) for _ in range(10)]
    t.profiled_calls = list(t.calls)
    least = work.bound_s(sum([w3.splat] * 10, work.Work()))
    t.kernels = [("void (anonymous namespace)::splat_scatter_kernel<float>(...)", 0.0, least * 2),
                 ("void warp_kernel<1>(WarpArgs)", 0.1, 1.0), ("ampere_conv", 0.2, 1.0)]
    t.span_s, t.busy_s = 4.0, 3.0
    t.window_device_ms = [20.0, 22.0]
    t.latency_ms = list(range(1, 101))
    return t, w3


@pytest.mark.parametrize("name,want", [
    ("prefetch_wait_ms", 50.0), ("emit_wait_ms", 100.0), ("scdet_wait_ms", 20.0),
    ("window_device_ms", 21.0), ("call_host_ms", 1.0), ("splat_roofline", 50.0),
    ("device_idle_share", 25.0), ("frame_latency_p95_ms", 95.05)])
def test_per_layer_readers(name, want):
    t, _ = _trace()
    assert cells.metric_reader(name)(t) == pytest.approx(want)


def test_mfu_and_warp_roofline_readers():
    t, w3 = _trace()
    assert cells.metric_reader("mfu")(t) == pytest.approx(
        10 * w3.flops / 2.0 / 989e12 * 100)
    assert cells.metric_reader("warp_roofline")(t) == pytest.approx(
        work.bound_s(sum([w3.warp] * 10, work.Work())) / 1.0 * 100)
    t.kernels = []
    assert cells.metric_reader("splat_roofline")(t) is None


def test_stage_report_parses():
    from drba_tpu_torch.utils.profiling import StageTimes

    st = StageTimes()
    for name, n in (("window", 3), ("prefetch-wait", 4)):
        for _ in range(n):
            with st.stage(name):
                pass
    got = trace.parse_stages(st.report())
    assert set(got) == {"window", "prefetch-wait"}
    assert got["window"][1] == 3 and got["prefetch-wait"][1] == 4
