#!/usr/bin/env python3
"""Time other builds of ``csrc/warp.cu`` and ``csrc/conv_chain.cu`` against the
package's, in turns, at the 1080p path shapes, on one NVIDIA GPU.

    git show <rev>:drba_tpu_torch/csrc/warp.cu > .chip_check/warp_old.cu
    git show <rev>:drba_tpu_torch/csrc/conv_chain.cu > .chip_check/conv_chain_old.cu
    python3 scripts/torch_warp_conv_compare.py [--warp .chip_check/warp_old.cu] \
        [--conv .chip_check/conv_chain_old.cu]
    git show 9e2a442:drba_tpu_torch/csrc/conv_chain.cu > .chip_check/conv_fma.cu
    python3 scripts/torch_warp_conv_compare.py --conv .chip_check/conv_fma.cu --dtype f32

The other sources are built with the package's nvcc flags next to
themselves and called through their own C entries, in the interface each
had: the warp before the two-direction warp (one image and a 2-channel
flow), the conv's eight-pointer entry with the design code that came with
the plan of designs (f080fd1 on), or, in an older source, without it
(e.g. ``git show a63d220:drba_tpu_torch/csrc/conv_chain.cu``); the design
passed is the package plan's. With ``--dtype f32`` the conv runs in f32
(TF32 off for cuDNN) on design 0 (the f32 design: the FMA kernel up to
9e2a442, which reads the OIHW weights, 3xTF32 since, which reads the split
ones: both are passed), at the same shapes and f32's chain sites at
GridNet's L2 and FeatureNet's levels 2-3. The warp is timed at the RIFE
path's five launches of a T=3 window, which the old build ran as that path
did: the tap warps on stacked inputs, stage 4 and the merge as two
one-direction launches each (inputs made once, outside the timing). The
conv at one ResConv step of each IFNet block (N = 3, summed; block 0 at N =
1 apart) and at each GMFSS and GMFSS_UNION chain step with its epilogue,
each shape printed with the design the plan gives it. Per shape, bf16: the
two outputs' largest difference, then CUDA-event times in turns (old, new,
new, old; 10 calls each after 2 warm-ups), the bound
(drba_tpu_torch/bounds.py) and, where one PyTorch call computes the same
function, its time (``F.grid_sample`` at the k = 1 warps, ``F.conv2d`` with
bias on cuDNN for the conv, without the epilogue). The last line of the
output is the table as one JSON object. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H, W = 1088, 1920
HU = 1152  # GMFSS_UNION's pad of 128
# the GMFSS and GMFSS_UNION chain steps: label -> (n, h, w, cin, cout,
# pre-PReLU, residual: none | plain | input | extra)
GMFSS_STEPS = {
    "gridnet L0 pre + extra": (3, H // 2, W // 2, 64, 64, True, "extra"),
    "gridnet L1 pre + input": (3, H // 4, W // 4, 128, 128, True, "input"),
    "gridnet head 12->64 pre": (3, H // 2, W // 2, 12, 64, True, "none"),
    "gridnet head1 128->64 pre": (3, H // 2, W // 2, 128, 64, True, "none"),
    "gridnet head2 256->128 pre": (3, H // 4, W // 4, 256, 128, True, "none"),
    "gridnet tail 64->256 pre": (3, H // 2, W // 2, 64, 256, True, "none"),
    "metricnet in 14->64": (1, H // 2, W // 2, 14, 64, False, "none"),
    "metricnet pre + plain res": (1, H // 2, W // 2, 64, 64, True, "plain"),
    "metricnet out 64->2 pre": (1, H // 2, W // 2, 64, 2, True, "none"),
    "featurenet L1 pre": (1, H // 2, W // 2, 64, 64, True, "none"),
    "union head0 9->64 pre": (3, HU // 2, W // 2, 9, 64, True, "none"),
    "union L0 pre + extra": (3, HU // 2, W // 2, 64, 64, True, "extra"),
}
# f32's chain sites only (bf16 leaves them on cuDNN)
F32_STEPS = {
    "gridnet L2 pre + input": (3, H // 8, W // 8, 192, 192, True, "input"),
    "gridnet head3 384->192 pre": (3, H // 8, W // 8, 384, 192, True, "none"),
    "featurenet L2 pre": (1, H // 4, W // 4, 128, 128, True, "none"),
    "featurenet L3 pre": (1, H // 8, W // 8, 192, 192, True, "none"),
}


def build_other(src: Path):
    from drba_tpu_torch import _build

    out = src.with_suffix(".so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    print(f"built {src.name}: " + "; ".join(ln.split(":", 1)[-1].strip()
                                             for ln in (proc.stdout + proc.stderr).splitlines()
                                             if "registers" in ln))
    return ctypes.CDLL(str(out))


def main() -> None:
    import torch
    import torch.nn.functional as F

    from chip_smoke import cmd_line, smooth_flow, timed
    from drba_tpu_torch import _build, bounds
    from drba_tpu_torch.ops.conv_chain import PATHS, chain_step, conv3x3_cuda, conv3x3_path
    from drba_tpu_torch.ops.warp import backwarp, backwarp2, sample_positions

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warp", type=Path, help="another build's warp.cu (one-direction entry)")
    ap.add_argument("--conv", type=Path, help="another build's conv_chain.cu (its "
                    "eight-pointer entry, with or without a design code)")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                    help="the conv's dtype (default bf16)")
    args = ap.parse_args()
    if not (args.warp or args.conv) or not torch.cuda.is_available():
        sys.exit(__doc__)
    P, I = ctypes.c_void_p, ctypes.c_int
    old_warp = old_conv = None
    if args.warp:
        old_warp = build_other(args.warp.resolve())
        old_warp.drba_warp.argtypes = [P, P, P] + [I] * 8 + [P]
    f32 = args.dtype == "f32"
    if args.conv:
        old_conv = build_other(args.conv.resolve())
        coded = "int dtype, int path" in args.conv.read_text()  # the entry takes a design
        old_conv.drba_conv3x3.argtypes = [P] * 8 + [I] * (7 if coded else 6) + [P]
    gpu = cmd_line(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    print(gpu)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    cdt = torch.float32 if f32 else bf16  # the conv's dtype
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def check(rc):
        if rc:
            raise RuntimeError(f"kernel launch failed: CUDA error {rc}")

    def old_warp_fn(img, flow, k, out=None):
        n, h, w, c = img.shape
        if out is None:
            out = torch.empty(n, h // k, w // k, c, dtype=img.dtype, device=dev)
        return lambda: (check(old_warp.drba_warp(img.data_ptr(), flow.data_ptr(), out.data_ptr(),
                                                 n, h, w, c, k, 0, 1, 1, stream())), out)[1]

    def grid_sample_fn(img, px, py):
        grid = torch.stack([px * (2 / (W - 1)) - 1, py * (2 / (H - 1)) - 1], -1).to(bf16)
        nchw = img.permute(0, 3, 1, 2)  # the NHWC data, channels_last
        return (lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                                      align_corners=True), "F.grid_sample")

    cases = []  # (group, label, old fn, new fn, work, (library fn, name) or None)
    # warp: the RIFE path's five launches of a T=3 window, both directions
    # of the 4-channel flow in each (B = 2T = 6 images): the tap warps of
    # stages 1-3, stage 4 (C=19) and the merge (C=3). The old build runs
    # them as the path ran it: the taps on the stacked inputs (made once,
    # outside the timing), stage 4 and the merge as two one-direction
    # launches. Extras: one direction at the two k = 1 shapes (B = T = 3).
    warps = {} if old_warp is None else {"tap k=2 C=19": (3, 19, 2, True),
                                  "tap k=4 C=19": (3, 19, 4, True),
                                  "tap k=8 C=19": (3, 19, 8, True),
                                  "stage 4 C=19": (3, 19, 1, True),
                                  "merge C=3": (3, 3, 1, True),
                                  "one direction C=19": (3, 19, 1, False),
                                  "one direction C=3": (3, 3, 1, False)}
    for label, (b, c, k, two) in warps.items():
        a = torch.rand(b, H, W, c, generator=gen, device=dev).to(bf16)
        flow = smooth_flow(gen, b, H, W, 16.0, dev, bf16)
        lib = None
        if two:
            bimg = torch.rand(b, H, W, c, generator=gen, device=dev).to(bf16)
            flow4 = torch.cat([flow, smooth_flow(gen, b, H, W, 16.0, dev, bf16)], dim=-1)
            stacked = torch.cat([a, bimg]), torch.cat([flow4[..., 0:2], flow4[..., 2:4]])
            fn = (lambda a=a, bi=bimg, f=flow4, k=k: backwarp2(a, bi, f, k, backend="cuda"))
            if k > 1:
                fo = old_warp_fn(*stacked, k)
            else:
                out = torch.empty_like(stacked[0])  # each launch writes its half
                halves = (old_warp_fn(a, flow4[..., 0:2].contiguous(), 1, out[:b]),
                          old_warp_fn(bimg, flow4[..., 2:4].contiguous(), 1, out[b:]))
                fo = (lambda h0=halves[0], h1=halves[1], out=out: (h0(), h1(), out)[2])
            px, py = sample_positions(stacked[1], k)
            if k == 1:  # both directions' images stacked outside the timing
                lib = grid_sample_fn(stacked[0], px, py)
        else:
            fn = (lambda a=a, f=flow: backwarp(a, f, backend="cuda"))
            fo = old_warp_fn(a, flow, 1)
            px, py = sample_positions(flow)
            lib = grid_sample_fn(a, px, py)
        work = bounds.warp_work(2 * b if two else b, H, W, c, k, 2,
                                bounds.warp_touched(px, py, H, W))
        cases.append(("warp" if two else "warp (extra)",
                      f"warp {label} ({2 * b if two else b},{H},{W},{c})", fo, fn, work, lib))

    # conv: one ResConv step of each IFNet block at 1080p (N = T = 3), and
    # block 0 at N = 1 (the flow pass of _calc_flow); then each GMFSS and
    # GMFSS_UNION chain step with its epilogue
    convs = {} if old_conv is None else {
        f"ifnet resconv ({n},{h},{w},{c})": (n, h, w, c, c, False, "beta")
        for n, c, h, w in ((3, 192, 17, 30), (3, 128, 34, 60), (3, 96, 68, 120),
                           (3, 64, 136, 240), (3, 32, 272, 480), (1, 192, 17, 30))}
    if old_conv is not None:
        convs.update(GMFSS_STEPS)
        if f32:
            convs.update(F32_STEPS)
    for label, (n, h, w, cin, cout, pre, residual) in convs.items():
        bound = 1.0 / (9 * cin) ** 0.5
        x = (torch.rand(n, h, w, cin, generator=gen, device=dev) * 2 - 1).to(cdt)
        extra = (torch.rand(n, h, w, cout, generator=gen, device=dev) * 2 - 1).to(cdt) \
            if residual == "extra" else None
        st = chain_step(((torch.rand(cout, cin, 3, 3, generator=gen, device=dev) * 2 - 1)
                         * bound).to(cdt),
                        ((torch.rand(cout, generator=gen, device=dev) * 2 - 1) * 0.05).to(cdt),
                        (1 + 0.2 * torch.randn(cout, generator=gen, device=dev)).to(cdt)
                        if residual == "beta" else None,
                        pre_alpha=torch.tensor(0.25, device=dev).to(cdt) if pre else None)
        res = {"plain": x, "input": x, "extra": extra}.get(residual)
        out = torch.empty(n, h, w, cout, dtype=cdt, device=dev)
        path = conv3x3_path(n, h, w, cin, cout, cdt)
        dtype_code = 0 if f32 else 1  # csrc/common.cuh
        design = (dtype_code, PATHS.index(path)) if coded else (dtype_code,)
        ptr = lambda t: None if t is None else t.data_ptr()
        fo = (lambda x=x, st=st, res=res, out=out, n=n, h=h, w=w, cin=cin, cout=cout,
              design=design:
              (check(old_conv.drba_conv3x3(x.data_ptr(), st.w.data_ptr(), st.wp.data_ptr(),
                                           st.b.data_ptr(), ptr(st.beta), ptr(st.pre_alpha),
                                           ptr(res), out.data_ptr(), n, h, w, cin, cout,
                                           *design, stream())), out)[1])
        fn = (lambda x=x, st=st, res=res: conv3x3_cuda(x, st.w, st.b, st.beta, st.wp,
                                                       st.pre_alpha, res))
        nchw = x.permute(0, 3, 1, 2)
        lib = (lambda x=nchw, st=st: F.conv2d(x, st.w, st.b, padding=1), "F.conv2d (cuDNN)")
        group = "conv" if label.startswith("ifnet") and n == 3 else \
            ("conv (extra)" if label.startswith("ifnet") else "conv (gmfss)")
        cases.append((group, f"conv {label} ({n},{h},{w},{cin})->{cout} [{path}]", fo, fn,
                      bounds.conv3x3_work(n, h, w, cin, cout, 4 if f32 else 2,
                                          beta=residual == "beta", alpha=pre,
                                          res=residual == "extra"), lib))

    rows = []
    print(f"{'shape (' + args.dtype + ')':<72} {'max|old-new|':>12} {'old ms':>8} {'new ms':>8} "
          f"{'old/new':>7} {'bound ms':>9} {'new share':>9} {'lib ms':>8} {'new/lib':>8}")
    for group, label, fo, fn, work, lib in cases:
        diff = float((fo().float() - fn().float()).abs().max())
        t_old = timed(fo, 10)
        t_new = timed(fn, 10)
        t_new = (t_new + timed(fn, 10)) / 2
        t_old = (t_old + timed(fo, 10)) / 2
        t_lib = timed(lib[0], 10) if lib else None
        b_ms, b_by = bounds.bound_ms(work)
        rows.append({"group": group, "shape": label, "max_abs_diff": diff, "old_ms": t_old,
                     "new_ms": t_new, "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_lib,
                     "library": lib[1] if lib else None})
        lib_txt = f"{t_lib:8.4f} {t_new / t_lib:8.2f}" if lib else f"{'-':>8} {'-':>8}"
        print(f"{label:<72} {diff:12.3e} {t_old:8.4f} {t_new:8.4f} {t_old / t_new:7.2f} "
              f"{b_ms:9.4f} {b_ms / t_new:9.1%} {lib_txt}  [{b_by}]")
    for group in ("warp", "conv", "conv (gmfss)"):
        sel = [r for r in rows if r["group"] == group]
        if not sel:
            continue
        old, new = sum(r["old_ms"] for r in sel), sum(r["new_ms"] for r in sel)
        bnd = sum(r["bound_ms"] for r in sel)
        libs = [r for r in sel if r["library_ms"] is not None]
        lib_txt = ""
        if libs:
            lo = sum(r["library_ms"] for r in libs)
            ln = sum(r["new_ms"] for r in libs)
            lib_txt = (f"; where a library call exists: new {ln:.4f} ms vs {libs[0]['library']} "
                       f"{lo:.4f} ms ({ln / lo:.2f})")
        print(f"sum {group} ({len(sel)} shapes): old {old:.4f} ms, new {new:.4f} ms, "
              f"{old / new:.2f}x; bound {bnd:.4f} ms ({bnd / new:.1%} of it){lib_txt}")
    print(f"package launches during the comparison: {_build.counts()}")
    print(json.dumps({"gpu": gpu, "rows": rows}))


if __name__ == "__main__":
    main()
