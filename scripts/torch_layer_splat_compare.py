#!/usr/bin/env python3
"""Time other builds of ``csrc/attn_layer.cu`` and ``csrc/splat.cu`` against the
package's, in turns, at the GMFSS and RIFE 1080p path shapes, on one NVIDIA GPU.

    git show <rev>:drba_tpu_torch/csrc/attn_layer.cu > .chip_check/attn_layer_old.cu
    git show <rev>:drba_tpu_torch/csrc/splat.cu > .chip_check/splat_old.cu
    python3 scripts/torch_layer_splat_compare.py .chip_check/attn_layer_old.cu \\
        .chip_check/splat_old.cu

The other sources are built with the package's nvcc flags next to
themselves and called through their own C entries, in the interface they
had before the packed layer weights and the fused splat: the layer's
projection takes the (128, 384) [Wq | Wk | Wv] concatenated, its tail the
(in, out) weights and f32 norms; the splat is the raw scatter into an f32
sum the caller zeroes, with the mode's planes, division and casts in plain
PyTorch around it (that wrapper's arithmetic). Per shape, bf16 where the
path computes in bf16: the two outputs' largest difference, then CUDA-event
times in turns (old, new, new, old; 10 calls each after 2 warm-ups), the
bound (drba_tpu_torch/bounds.py) and its share of the new time.

  * layer: the four layer shapes of chip_smoke.py (scale 1 (4,136,240) k=8
    and scale 0 (2,68,120) k=2, a self layer and a cross layer with its FFN,
    shift mask, batch-half swap and target), projection + window attention
    + tail (the window launch is the package's in both), and the projection
    and the tail alone as extra rows;
  * splat: GMFSS's three soft splats of a T=3 window ((6,544,960,67) with
    coverage, (6,272,480,128), (6,136,240,192); bf16 values, flow and metric;
    smooth flows of ~12 px) and RIFE's two avg splats (flow inversion
    (2,1088,1920,2) bf16, the DRM alignment (6,544,960,1) in f32), as whole
    ``softsplat`` calls.

The last line of the output is the table as one JSON object. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H, W = 1088, 1920


def main() -> None:
    import torch

    from chip_smoke import cmd_line, smooth_flow, timed
    from drba_tpu_torch import _build, bounds
    from drba_tpu_torch.convert import from_jax_params
    from drba_tpu_torch.models.gmflow_net import (GMFLOW_SPEC, pack_transformer_weights,
                                                  shift_region_labels)
    from drba_tpu_torch.models.layers import init_from_spec
    from drba_tpu_torch.ops.attn_layer import (layer_proj_cuda, layer_tail_cuda, layer_weights,
                                               layer_window_attention, transformer_layer)
    from drba_tpu_torch.ops.softsplat import softsplat
    from scripts.torch_warp_conv_compare import build_other

    if len(sys.argv) != 3 or not torch.cuda.is_available():
        sys.exit(__doc__)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old_layer = build_other(Path(sys.argv[1]).resolve())
    old_layer.drba_layer_proj.argtypes = [P] * 4 + [L, I, P]
    old_layer.drba_layer_tail.argtypes = [P] * 10 + [I, L, I, P]
    old_splat = build_other(Path(sys.argv[2]).resolve())
    old_splat.drba_splat.argtypes = [P, P, P] + [I] * 6 + [P]
    gpu = cmd_line(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    print(gpu)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def check(rc):
        if rc:
            raise RuntimeError(f"kernel launch failed: CUDA error {rc}")

    cases = []  # (group, label, old fn, new fn, work)

    # ---- layer: the old build's three launches on the natural weights
    params = pack_transformer_weights({k: v.to(dev, bf16) for k, v in
                                       from_jax_params(init_from_spec(GMFLOW_SPEC, seed=0),
                                                       GMFLOW_SPEC).items()})
    for (b, h, w, ks) in ((4, 136, 240, 8), (2, 68, 120, 2)):
        lab = shift_region_labels(h, w, ks)
        for cross in (False, True):
            wt = layer_weights(params, f"transformer.layers.1."
                                       f"{'cross_attn_ffn' if cross else 'self_attn'}", cross)
            x, tgt = ((torch.randn(b, h, w, 128, generator=gen, device=dev) * 0.5).to(bf16)
                      for _ in range(2))
            t = tgt if cross else x
            m = b * h * w
            wqkv = torch.cat([wt.wq, wt.wk, wt.wv], dim=1).contiguous()
            g1, b1 = (v.float().contiguous() for v in wt.norm1)
            w0 = w2 = g2 = b2 = None
            hidden = 0
            if cross:
                w0, w2 = wt.ffn[0].contiguous(), wt.ffn[1].contiguous()
                g2, b2 = (v.float().contiguous() for v in wt.ffn[2:])
                hidden = w0.shape[1]
            ptr = (lambda v: None if v is None else v.data_ptr())

            def old_proj(x=x, t=t, wqkv=wqkv, m=m):
                qkv = torch.empty(x.shape[:-1] + (384,), dtype=bf16, device=dev)
                check(old_layer.drba_layer_proj(x.data_ptr(), t.data_ptr(), wqkv.data_ptr(),
                                                qkv.data_ptr(), m, 1, stream()))
                return qkv

            def old_tail(x, av, wt=wt, g1=g1, b1=b1, w0=w0, w2=w2, g2=g2, b2=b2, hidden=hidden,
                         m=m):
                out = torch.empty_like(x)
                check(old_layer.drba_layer_tail(
                    x.data_ptr(), av.data_ptr(), wt.wmerge.data_ptr(), g1.data_ptr(),
                    b1.data_ptr(), ptr(w0), ptr(w2), ptr(g2), ptr(b2), out.data_ptr(), hidden, m,
                    1, stream()))
                return out

            kw = dict(labels=lab, with_mask=cross, cross_swap=cross)
            fo = (lambda x=x, old_proj=old_proj, old_tail=old_tail, ks=ks, kw=kw:
                  old_tail(x, layer_window_attention(old_proj(), ks, **kw)))
            fn = (lambda x=x, wt=wt, ks=ks, tgt=tgt if cross else None, kw=kw:
                  transformer_layer(x, wt, ks, target=tgt, backend="cuda", **kw))
            label = f"({b},{h},{w},128) k={ks} {'cross+ffn masked' if cross else 'self'}"
            work = bounds.layer_work(b, h, w, ks, 2, hidden=hidden, cross=cross,
                                     pairs=b * bounds.live_pairs(lab.reshape(ks * ks, -1))
                                     if cross else None, labels=h * w if cross else 0)
            cases.append(("layer", f"layer {label}", fo, fn, work))
            # the projection and the tail alone, on the same q|k|v and attention output
            qkv = layer_proj_cuda(x, t, wt.qkv_p)
            av = layer_window_attention(qkv, ks, **kw)
            tokens_bytes = m * 128 * 2
            proj_work = bounds.Work(tokens_bytes * (2 if cross else 1) + 3 * tokens_bytes
                                    + 128 * 384 * 2, {"bf16": 2.0 * m * 128 * 384})
            cases.append(("layer (extra)", f"projection {label}", old_proj,
                          (lambda x=x, t=t, wt=wt: layer_proj_cuda(x, t, wt.qkv_p)), proj_work))
            ffn_macs = m * (256 * hidden + hidden * 128)
            tail_work = bounds.Work(3 * tokens_bytes + (128 * 128 + 384 * hidden) * 2,
                                    {"bf16": 2.0 * (m * 128 * 128 + ffn_macs)})
            cases.append(("layer (extra)", f"tail {label}",
                          (lambda x=x, av=av, old_tail=old_tail: old_tail(x, av)),
                          (lambda x=x, av=av, wt=wt: layer_tail_cuda(x, av, wt)), tail_work))

    # ---- splat: whole softsplat calls; the old build with its own wrapper's arithmetic
    def old_softsplat(ten, flow, metric, main, coverage):
        x = ten.float()
        if main == "avg":
            x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        else:
            mm = torch.exp(metric.float())
            x = torch.cat([x * mm, mm], dim=-1)
        n, h, w, c = x.shape
        out = torch.zeros((n, h, w, c), dtype=f32, device=dev)
        check(old_splat.drba_splat(x.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c,
                                   0, 1 if flow.dtype == bf16 else 0, stream()))
        raw = out[..., -1:]
        norm = raw + 1e-7
        result = (out[..., :-1] / norm).to(ten.dtype)
        return torch.cat([result, (raw / norm).to(ten.dtype)], -1) if coverage else result

    def new_softsplat(ten, flow, metric, main, coverage):
        r = softsplat(ten, flow, metric, main, backend="cuda", return_coverage=coverage)
        return torch.cat(r, -1) if coverage else r

    for group, label, (n, h, w, c, main, cov, vdt, fdt, mag) in (
            ("splat gmfss", "soft level 0", (6, H // 2, W // 2, 67, "soft", True, bf16, bf16,
                                             12.0)),
            ("splat gmfss", "soft level 1", (6, H // 4, W // 4, 128, "soft", False, bf16, bf16,
                                             6.0)),
            ("splat gmfss", "soft level 2", (6, H // 8, W // 8, 192, "soft", False, bf16, bf16,
                                             3.0)),
            ("splat rife", "flow inversion", (2, H, W, 2, "avg", True, bf16, bf16, 24.0)),
            ("splat rife", "drm alignment", (6, H // 2, W // 2, 1, "avg", True, f32, f32, 12.0))):
        flow = smooth_flow(gen, n, h, w, mag, dev, fdt)
        ten = flow if label == "flow inversion" else \
            torch.rand(n, h, w, c, generator=gen, device=dev).to(vdt)
        metric = None
        if main == "soft":
            metric = (torch.randn(n, h, w, 1, generator=gen, device=dev) * 0.5).to(vdt)
        work = bounds.splat_work(n, h, w, c, ten.element_size(), flow.element_size(),
                                 0 if metric is None else metric.element_size(), cov)
        cases.append((group, f"splat {label} ({n},{h},{w},{c}) {main}",
                      (lambda a=(ten, flow, metric, main, cov): old_softsplat(*a)),
                      (lambda a=(ten, flow, metric, main, cov): new_softsplat(*a)), work))

    rows = []
    print(f"{'shape':<58} {'max|old-new|':>12} {'old ms':>8} {'new ms':>8} {'old/new':>7} "
          f"{'bound ms':>9} {'new share':>9}")
    for group, label, fo, fn, work in cases:
        diff = float((fo().float() - fn().float()).abs().max())
        t_old = timed(fo, 10)
        t_new = timed(fn, 10)
        t_new = (t_new + timed(fn, 10)) / 2
        t_old = (t_old + timed(fo, 10)) / 2
        b_ms, b_by = bounds.bound_ms(work)
        rows.append({"group": group, "shape": label, "max_abs_diff": diff, "old_ms": t_old,
                     "new_ms": t_new, "bound_ms": b_ms, "bound_by": b_by})
        print(f"{label:<58} {diff:12.3e} {t_old:8.4f} {t_new:8.4f} {t_old / t_new:7.2f} "
              f"{b_ms:9.4f} {b_ms / t_new:9.1%}  [{b_by}]")
    for group in ("layer", "splat gmfss", "splat rife"):
        sel = [r for r in rows if r["group"] == group]
        old, new = sum(r["old_ms"] for r in sel), sum(r["new_ms"] for r in sel)
        bnd = sum(r["bound_ms"] for r in sel)
        print(f"sum {group} ({len(sel)} shapes): old {old:.4f} ms, new {new:.4f} ms, "
              f"{old / new:.2f}x; bound {bnd:.4f} ms ({bnd / new:.1%} of it)")
    print(f"package launches during the comparison: {_build.counts()}")
    print(json.dumps({"gpu": gpu, "rows": rows}))


if __name__ == "__main__":
    main()
