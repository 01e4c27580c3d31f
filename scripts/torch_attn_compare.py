#!/usr/bin/env python3
"""Time another build of ``csrc/attention.cu`` (and, with ``--layer``, of
``csrc/attn_layer.cu``) against the package's, in turns, at the GMFSS 1080p
attention and transformer-layer shapes, on one NVIDIA GPU.

    git show <rev>:drba_tpu_torch/csrc/attention.cu > .chip_check/attention_old.cu
    git show <rev>:drba_tpu_torch/csrc/attn_layer.cu > .chip_check/attn_layer_old.cu
    python3 scripts/torch_attn_compare.py .chip_check/attention_old.cu [--dtype f32] \
        [--layer .chip_check/attn_layer_old.cu]

The other sources are built with the package's nvcc flags next to
themselves (with the package's headers) and called through their own C
entries: a source with ``drba_flash_combine`` runs the package's key-split
plan (in f32 only where it takes f32 splits), one without it the flash
entry from before the key split. ``--layer``: the four summed layers
(scale 1 and 0, self and cross), the old build's projection, window and
tail against the package's ``transformer_layer``; the old source reads f32
weights packed as wgmma slabs (``pack_slabs``, as before the 3xTF32
kernels), the package's its own packing. Per shape, in ``--dtype``
(default bf16): the two outputs' largest difference, then CUDA-event times
in turns (old, new, new, old; 10 calls each after 2 warm-ups), the bound
(drba_tpu_torch/bounds.py) and the fastest single
``F.scaled_dot_product_attention`` call on the same inputs (none for a
layer). TF32 is off. The last line of the output is the table as one JSON
object. Imports no JAX.
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


def build_other(src: Path):
    """(library, whether its flash entry takes the key-split arguments)"""
    lib = build_lib(src)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.drba_window_attention.argtypes = [P] * 5 + [I] * 12 + [P]
    split = "drba_flash_combine" in src.read_text()
    lib.drba_flash_attention.argtypes = [P] * 5 + [I] * 3 + ([P, I, P] if split else [P])
    if split:
        lib.drba_flash_combine.argtypes = [P, P, I, I, P]
    return lib, split


def build_lib(src: Path):
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


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call of ``fn``: the sum of its kernels' device time
    under torch.profiler, so host overhead between launches does not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / iters


def main() -> None:
    import torch

    from chip_smoke import cmd_line, sdpa_call, timed
    from drba_tpu_torch import _build, bounds
    from drba_tpu_torch.config import full_f32_products
    from drba_tpu_torch.models.gmflow_net import shift_region_labels
    from drba_tpu_torch.ops.attention import (device_labels, flash_attention, flash_split_plan,
                                              split_windows)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("attention", help="the other attention.cu")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--layer", help="the other attn_layer.cu: also time the layers")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_attn_compare: needs a CUDA device")
    full_f32_products()
    old, old_split = build_other(Path(opts.attention).resolve())
    gpu = cmd_line(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    print(gpu)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16 if opts.dtype == "bf16" else torch.float32
    code, size = (1, 2) if dt == torch.bfloat16 else (0, 4)  # the kernels' dtype code, bytes
    # the old f32 flash entry before 3xTF32 takes the split arguments but
    # refuses more than one split
    old_splits = old_split and (dt == torch.bfloat16 or "attn_tf32_kernel" in
                                Path(opts.attention).read_text())
    randn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(dt)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def old_window(qkv_views, out, b, h, w, kk, strides, lab, half):
        q, k, v = qkv_views
        wh, ww = h // kk, w // kk
        rc = old.drba_window_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                       None if lab is None else lab.data_ptr(), b, h, w, kk,
                                       *strides, wh * ww, 0, half, code, stream())
        if rc:
            raise RuntimeError(f"window kernel launch failed: CUDA error {rc}")
        return out

    def new_window(qkv_views, out, b, h, w, kk, strides, lab, half):
        from drba_tpu_torch.ops.attention import launch_window

        launch_window(*qkv_views, out, b, h, w, kk, strides, lab, ((h // kk) * (w // kk), 0),
                      half)
        return out

    def windows(t, ks):
        s = split_windows(t, ks)
        return s.reshape(s.shape[0], 1, -1, s.shape[-1]).contiguous()

    def same_label(lab, b):
        lab = torch.as_tensor(lab.reshape(lab.shape[0], -1), device=dev)
        return (lab[:, :, None] == lab[:, None, :]).repeat(b, 1, 1)[:, None]

    cases = []
    # scale 0 NHWC windows, unmasked and shift-masked; the layer's scale-1 cross launch
    for (b, h, w, ks, interleaved, masked) in ((2, 68, 120, 2, False, False),
                                               (2, 68, 120, 2, False, True),
                                               (4, 136, 240, 8, True, True)):
        lab_np = shift_region_labels(h, w, ks)
        lab = device_labels(lab_np.reshape(ks * ks, -1), dev) if masked else None
        L = (h // ks) * (w // ks)
        if interleaved:
            qkv = randn(b, h, w, 384)
            views = qkv.split(128, dim=-1)
            strides, half = (384, 384, 384, 128), b // 2
            swap = lambda t: torch.cat([t[half:], t[:half]])
            sd = (windows(views[0], ks), windows(swap(views[1]), ks), windows(swap(views[2]), ks))
            qkv_bytes = qkv.numel() * size
            label = f"window in layer ({b},{h},{w},3x128) k={ks} swap, masked"
        else:
            views = tuple(randn(b, h, w, 128) for _ in range(3))
            strides, half = (128, 128, 128, 128), 0
            sd = tuple(windows(t, ks) for t in views)
            qkv_bytes = None
            label = f"window nhwc ({b},{h},{w},128) k={ks} mask={masked}"
        out_o, out_n = (torch.empty(b, h, w, 128, dtype=dt, device=dev) for _ in range(2))
        args = (views, None, b, h, w, ks, strides, lab, half)
        fo = lambda a=args, o=out_o: old_window(a[0], o, *a[2:])
        fn = lambda a=args, o=out_n: new_window(a[0], o, *a[2:])
        pairs = b * bounds.live_pairs(lab_np.reshape(ks * ks, -1)) if masked else None
        work = bounds.attention_work(b * ks * ks, L, size, pairs=pairs,
                                     labels=h * w if masked else 0, qkv_bytes=qkv_bytes)
        lib = sdpa_call(*sd, same_label(lab_np, b) if masked else None)
        cases.append((label, fo, fn, work, lib))

    grid = torch.stack(torch.meshgrid(torch.arange(120.0, device=dev),
                                      torch.arange(68.0, device=dev), indexing="xy"), -1)
    for b in (1, 2):
        q, k = randn(b, 8160, 128, scale=0.3), randn(b, 8160, 128, scale=0.3)
        v = grid.reshape(1, 8160, 2).expand(b, 8160, 2).contiguous()
        out_o = torch.empty(b, 8160, 2, device=dev)
        # a build with the key split runs the package's plan
        n = flash_split_plan(b, 8160, torch.cuda.get_device_properties(dev)
                             .multi_processor_count)[0] if old_splits else 1
        part = torch.empty(n, b, 8160, 4, device=dev)

        def fo(q=q, k=k, v=v, o=out_o, b=b, n=n, part=part):
            extra = (part.data_ptr() if n > 1 else None, n) if old_split else ()
            rc = old.drba_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          None, b, 8160, code, *extra, stream())
            if n > 1 and not rc:
                rc = old.drba_flash_combine(part.data_ptr(), o.data_ptr(), b * 8160, n, stream())
            if rc:
                raise RuntimeError(f"flash kernel launch failed: CUDA error {rc}")
            return o

        fn = lambda q=q, k=k, v=v: flash_attention(q, k, v, out_dtype=torch.float32,
                                                   backend="cuda")
        best = None
        for width in (8, 128):
            vp = torch.zeros(b, 1, 8160, width, dtype=dt, device=dev)
            vp[..., :2] = v[:, None].to(dt)
            f, name = sdpa_call(q[:, None], k[:, None], vp)
            t = timed(f, 3)
            if best is None or t < best[0]:
                best = (t, f, f"{name}, value padded to {width}")
        cases.append((f"flash ({b},8160,128)/({b},8160,2)", fo, fn,
                      bounds.attention_work(b, 8160, size, value_width=2), best[1:]))
    if opts.layer:
        cases += layer_cases(build_lib(Path(opts.layer).resolve()), old_window, dt, gen, dev,
                             stream)

    rows = []
    print(f"{'shape (' + opts.dtype + ')':<48} {'max|old-new|':>12} {'old ms':>8} {'new ms':>8} "
          f"{'old/new':>7} {'bound ms':>9} {'new share':>9} {'SDPA ms':>8} {'new/SDPA':>8}")
    for label, fo, fn, work, (flib, lib_name) in cases:
        diff = float((fo().float() - fn().float()).abs().max())
        t_old = timed(fo, 10)
        t_new = timed(fn, 10)
        t_new = (t_new + timed(fn, 10)) / 2
        t_old = (t_old + timed(fo, 10)) / 2
        t_lib = timed(flib, 10) if flib else float("nan")
        dev_old, dev_new = device_ms(fo), device_ms(fn)
        dev_lib = device_ms(flib) if flib else float("nan")
        b_ms, b_by = bounds.bound_ms(work)
        rows.append({"shape": label, "max_abs_diff": diff, "old_ms": t_old, "new_ms": t_new,
                     "bound_ms": b_ms, "bound_by": b_by, "sdpa_ms": t_lib, "sdpa": lib_name,
                     "device_ms": {"old": dev_old, "new": dev_new, "sdpa": dev_lib}})
        print(f"{label:<48} {diff:12.3e} {t_old:8.4f} {t_new:8.4f} {t_old / t_new:7.2f} "
              f"{b_ms:9.4f} {b_ms / t_new:9.1%} {t_lib:8.4f} {t_new / t_lib:8.2f}  "
              f"[{b_by}; SDPA {lib_name}; profiler device ms old {dev_old:.4f} new "
              f"{dev_new:.4f} SDPA {dev_lib:.4f}]")
    counts = _build.counts()
    print(f"package launches during the comparison: {counts}")
    print(json.dumps({"gpu": gpu, "dtype": opts.dtype, "rows": rows}))


def layer_cases(lib, old_window, dt, gen, dev, stream):
    """The four summed transformer layers of chip_smoke.py: the old build's
    three launches against the package's ``transformer_layer``."""
    import torch

    from drba_tpu_torch import bounds
    from drba_tpu_torch.convert import from_jax_params
    from drba_tpu_torch.models.gmflow_net import (GMFLOW_SPEC, pack_transformer_weights,
                                                  shift_region_labels)
    from drba_tpu_torch.models.layers import init_from_spec
    from drba_tpu_torch.ops import attn_layer as al
    from drba_tpu_torch.ops.attention import device_labels

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.drba_layer_proj.argtypes = [P] * 4 + [L, I, P]
    lib.drba_layer_tail.argtypes = [P] * 9 + [I, L, I, P]
    code = 1 if dt == torch.bfloat16 else 0
    params = {k: v.to(dev, dt) for k, v in
              from_jax_params(init_from_spec(GMFLOW_SPEC, seed=0), GMFLOW_SPEC).items()}
    packed = pack_transformer_weights(params)

    def check(rc):
        if rc:
            raise RuntimeError(f"old layer kernel launch failed: CUDA error {rc}")

    cases = []
    for (b, h, w, ks) in ((4, 136, 240, 8), (2, 68, 120, 2)):
        lab_np = shift_region_labels(h, w, ks)
        lab = device_labels(lab_np.reshape(ks * ks, -1), dev)
        for cross in (False, True):
            base = f"transformer.layers.1.{'cross_attn_ffn' if cross else 'self_attn'}"
            wt = al.layer_weights(packed, base, cross)
            # the old source's packing: wgmma slabs in the layer's dtype
            o_qkv = al.pack_slabs(torch.cat([wt.wq, wt.wk, wt.wv], dim=1))
            o_merge = al.pack_slabs(wt.wmerge)
            o_ffn = al.pack_ffn(wt.ffn[0], wt.ffn[1]) if cross else None
            x, tgt = ((torch.randn(b, h, w, 128, generator=gen, device=dev) * 0.5).to(dt)
                      for _ in range(2))
            t = tgt if cross else x
            M = b * h * w
            ptr = (lambda v: None if v is None else v.data_ptr())

            def fo(x=x, t=t, wt=wt, o_qkv=o_qkv, o_merge=o_merge, o_ffn=o_ffn, b=b, h=h, w=w,
                   ks=ks, cross=cross, M=M, lab=lab):
                qkv = torch.empty(b, h, w, 384, dtype=dt, device=dev)
                check(lib.drba_layer_proj(x.data_ptr(), t.data_ptr(), o_qkv.data_ptr(),
                                          qkv.data_ptr(), M, code, stream()))
                av = torch.empty(b, h, w, 128, dtype=dt, device=dev)
                old_window(qkv.split(128, dim=-1), av, b, h, w, ks, (384, 384, 384, 128),
                           lab if cross else None, b // 2 if cross else 0)
                out = torch.empty_like(x)
                g2, b2 = (wt.ffn[2], wt.ffn[3]) if cross else (None, None)
                check(lib.drba_layer_tail(x.data_ptr(), av.data_ptr(), o_merge.data_ptr(),
                                          wt.norm1[0].data_ptr(), wt.norm1[1].data_ptr(),
                                          ptr(o_ffn), ptr(g2), ptr(b2), out.data_ptr(),
                                          1024 if cross else 0, M, code, stream()))
                return out

            kw = dict(labels=lab_np, with_mask=cross, cross_swap=cross,
                      target=tgt if cross else None)
            fn = (lambda x=x, wt=wt, ks=ks, kw=kw:
                  al.transformer_layer(x, wt, ks, backend="cuda", **kw))
            work = bounds.layer_work(
                b, h, w, ks, x.element_size(), hidden=1024 if cross else 0, cross=cross,
                pairs=b * bounds.live_pairs(lab_np.reshape(ks * ks, -1)) if cross else None,
                labels=h * w if cross else 0)
            kind = "cross+ffn masked" if cross else "self"
            cases.append((f"layer ({b},{h},{w},128) k={ks} {kind}", fo, fn, work, (None, "none")))
    return cases


if __name__ == "__main__":
    main()
