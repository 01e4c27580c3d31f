// f32-accurate matrix products on the tensor cores: 3xTF32 on mma.sync
// (m16n8k8), shared by the f32 kernels of attention.cu, attn_layer.cu and
// conv_chain.cu.
//
// A TF32 operand keeps 10 mantissa bits, so one TF32 product loses about
// three decimal digits against f32. Each operand x is split as x = hi + lo,
// hi = x rounded to TF32 (cvt.rna) and lo = x - hi (exact in f32), and
// a b = ah bh + ah bl + al bh, accumulated in f32: the dropped al bl and
// lo's own truncation are about 2^-21 |a b|, near an f32 product's 2^-24.
// The tensor cores truncate an f32 word to TF32 (1 + 0.75 ulp reads as 1,
// on mma.sync and wgmma alike; scripts/torch_tf32_probe.py), which is why
// hi is rounded explicitly and lo may be passed as it is.
//
// Why mma.sync and not wgmma: a tf32 wgmma reads B (and A, unless A comes
// from registers) K-major from shared memory, so every f32 tile would be
// staged there twice (hi and lo) in wgmma's layouts, and a value tile
// transposed: a 128-row query tile and a 64-key K/V stage with their splits
// take 128 + 128 KB of the 227 KB a block has, and the layer's FFN chunks
// double. mma.sync reads its fragments from registers, so one f32 copy of
// each tile sits in shared memory and the split is done in registers as
// the fragments are loaded (two ALU operations an element), or once, on
// the host, for weights. What bounds it: mma.sync's TF32 rate (292 TFLOP/s
// in a loop without loads on the H100, against wgmma's 428 of the 495
// peak; the probe) over three products per f32 product, and the splits'
// ALU work beside it, which the kernels' warps share with their loads.
//
// Fragments of m16n8k8 (lane = 4 g + t): A (16 x 8) a0 (row g, k t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (k t, col g),
// b1 (t + 4, g); the accumulator c0..c3 at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1): the layout of a wgmma accumulator's warp.
// The kernels relabel k inside each group of eight: A's k t is k 2t and
// its k t + 4 is k 2t + 1, in A and B alike (a sum over k does not depend
// on its order). Then an A fragment is two float2 loads, (a0, a2) from row
// g and (a1, a3) from row g + 8, and an accumulator tile over 8 columns is
// the A fragment of the next product over those 8 k: {c0, c2, c1, c3}.
#pragma once

#include <cstdint>

// accumulator tile i (8 columns: c0..c3) of a flat accumulator array
#define DRBA_ACC4(arr, i) (*reinterpret_cast<float(*)[4]>(&(arr)[4 * (i)]))

namespace drba {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi and lo of one f32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An A fragment, split
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
  // rows g and g + 8 of k group kk, from (row g: a0, a2) and (row g + 8:
  // a1, a3) pairs
  __device__ __forceinline__ FragA(float2 r0, float2 r1) : FragA(r0.x, r1.x, r0.y, r1.y) {}
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small cross terms first, then hi hi.
// b = (hi b0, hi b1, lo b0, lo b1), as the host packs weights.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, float4 b) {
  const uint32_t h0 = __float_as_uint(b.x), h1 = __float_as_uint(b.y);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, a.hi, h0, h1);
}

// the same with B given as two f32 values, split here
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

}  // namespace drba
