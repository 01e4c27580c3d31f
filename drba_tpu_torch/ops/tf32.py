"""The 3xTF32 split and the split B-fragment packing of the f32 kernels on
the tensor cores (csrc/tf32.cuh): shared by the layer weights
(ops/attn_layer) and the conv weights (ops/conv_chain).
"""

from __future__ import annotations

import torch


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` = hi + lo exactly: hi is ``x`` rounded to TF32 (10 mantissa
    bits, to nearest with ties away from zero, as ``cvt.rna.tf32.f32``), lo
    = x - hi (|lo| <= 2^-11 |x|), which the tensor core reads to TF32 in
    turn. The split of the 3xTF32 products (csrc/tf32.cuh)."""
    bits = x.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x.float() - hi


def pack_frags(w: torch.Tensor) -> torch.Tensor:
    """An f32 (K, N) weight stored (in, out), K and N multiples of 8 ->
    (K/8, N/8, 32, 4): per k-step kk and column tile nt, lane 4 g + t holds
    (hi b0, hi b1, lo b0, lo b1) with b0 = w[8 kk + 2 t, 8 nt + g] and b1 =
    w[8 kk + 2 t + 1, 8 nt + g] (``split_tf32``): the m16n8k8 B fragments
    of csrc/tf32.cuh, k relabelled within each 8, already split."""
    k, n = w.shape
    hi, lo = split_tf32(w)

    def lanes(t):  # (K, N) -> (kk, t, pair, nt, g) -> (kk, nt, lane 4g + t, pair)
        return t.reshape(k // 8, 4, 2, n // 8, 8).permute(0, 3, 4, 1, 2).reshape(
            k // 8, n // 8, 32, 2)

    return torch.cat([lanes(hi), lanes(lo)], dim=-1).contiguous()


def unpack_frags(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of ``pack_frags``: (K/8, N/8, 32, 4) -> (hi, lo), each
    (K, N); the weight is hi + lo."""
    kk, nt = p.shape[:2]

    def back(t):  # (kk, nt, g, t, pair) -> (kk, t, pair, nt, g)
        return t.reshape(kk, nt, 8, 4, 2).permute(0, 3, 4, 1, 2).reshape(8 * kk, 8 * nt)

    return back(p[..., :2]), back(p[..., 2:])


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """An f32 word as a tensor core reads it as TF32: its low 13 mantissa
    bits dropped (csrc/tf32.cuh)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
