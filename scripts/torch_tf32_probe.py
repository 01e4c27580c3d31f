#!/usr/bin/env python3
"""Probe the TF32 tensor-core paths of one NVIDIA Hopper GPU for the f32
kernels' design (csrc/tf32.cuh).

    python3 scripts/torch_tf32_probe.py

Builds ``scripts/torch_tf32_probe.cu`` with the package's nvcc flags and
prints: the TF32 rate of ``mma.sync`` m16n8k8 and of ``wgmma`` m64n128k8
(A from registers, and from shared memory) in loops without loads (2 blocks
of 256 threads an SM, CUDA events); the largest error of one m64n128k8
product with A from registers in the m16n8k8 fragment layout, and of the
same product on ``mma.sync``, against float64 (exact TF32 inputs, so the
error is the f32 accumulation's); and what each path reads of f32 words
that are not TF32 values (1 + 0.75 and 1 + 0.25 TF32 ulps, and the
negative): 1.0 when it truncates, 1 + 2^-10 for the first when it rounds.
Imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch

    from chip_smoke import cmd_line
    from drba_tpu_torch import _build
    from drba_tpu_torch.ops.attn_layer import split_tf32

    if not torch.cuda.is_available():
        sys.exit("torch_tf32_probe: needs a CUDA device")
    src = ROOT / "scripts" / "torch_tf32_probe.cu"
    lib_path = ROOT / "drba_tpu_torch" / "_build" / "torch_tf32_probe.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
                           str(lib_path), str(src)], capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run_bench.argtypes = [P, I, I, I, P]
    lib.run_check.argtypes = [P, P, P, I, P]
    print(cmd_line(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]))
    dev = torch.device("cuda", 0)
    out = torch.zeros(4, device=dev)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def check(rc):
        if rc:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # flops an iteration of one block: 8 warps x 8 chains x m16n8k8, or
    # 2 warpgroups x 2 accumulators x m64n128k8
    for which, name, flops in ((0, "mma.sync m16n8k8", 8 * 8 * 2 * 16 * 8 * 8),
                               (1, "wgmma m64n128k8, A from registers", 2 * 2 * 2 * 64 * 128 * 8),
                               (2, "wgmma m64n128k8, A from shared memory",
                                2 * 2 * 2 * 64 * 128 * 8)):
        iters, blocks = 4000, 2 * sms
        for _ in range(2):
            check(lib.run_bench(out.data_ptr(), iters, which, blocks, stream()))
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        check(lib.run_bench(out.data_ptr(), iters, which, blocks, stream()))
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        tflops = flops * iters * blocks / ms / 1e9
        print(f"{name} in TF32: {tflops:.1f} TFLOP/s ({tflops / 494.7:.1%} of 494.7; {ms:.3f} ms)")

    gen = torch.Generator(device=dev).manual_seed(0)
    a = split_tf32(torch.randn(64, 8, generator=gen, device=dev))[0]
    b = split_tf32(torch.randn(8, 128, generator=gen, device=dev))[0]
    want = a.double() @ b.double()
    for which, name, rows in ((0, "wgmma (A in the m16n8k8 fragment layout)", 64),
                              (1, "mma.sync", 16)):
        d = torch.zeros(64, 128, device=dev)
        check(lib.run_check(a.data_ptr(), b.data_ptr(), d.data_ptr(), which, stream()))
        torch.cuda.synchronize()
        print(f"{name}: one product against float64, max abs error "
              f"{float((d[:rows].double() - want[:rows]).abs().max()):.3e}")
    a1 = torch.zeros(64, 8, device=dev)
    a1[:, 0] = 1.0
    b1 = torch.zeros(8, 128, device=dev)
    b1[0, :] = 1.0 + 0.75 * 2 ** -10
    b1[0, 1] = -(1.0 + 0.75 * 2 ** -10)
    b1[0, 2] = 1.0 + 0.25 * 2 ** -10
    for which, name in ((0, "wgmma"), (1, "mma.sync")):
        d = torch.zeros(64, 128, device=dev)
        check(lib.run_check(a1.data_ptr(), b1.data_ptr(), d.data_ptr(), which, stream()))
        torch.cuda.synchronize()
        got = [d[0, j].item() for j in range(3)]
        verdict = "truncates" if got[0] == 1.0 and got[1] == -1.0 else "rounds"
        print(f"{name} reads 1 + 0.75 ulp, -(1 + 0.75 ulp), 1 + 0.25 ulp as {got!r}: it "
              f"{verdict} an f32 word to TF32")


if __name__ == "__main__":
    main()
