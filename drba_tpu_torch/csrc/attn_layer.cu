// The token-wise parts of one GMFlow TransformerLayer, head width 128.
//
// Replaces, with the window-attention kernel of attention.cu between them,
// the TPU kernel transformer_layer_mxu (drba_tpu/ops/attn_layer.py:176, body
// _kernel :125), which computes a whole layer per window in VMEM. A window
// does not fit a block here (at L = 510, c = 128, q, k and v are 130 KB each
// in bf16 and a block has 227 KB), so the layer runs as three launches:
//
//  1. drba_layer_proj: q = x Wq, k = t Wk, v = t Wv (t = the
//     cross-attention target, or x), written as one (M, 384) q|k|v map that
//     the attention kernel reads by stride;
//  2. the window attention of attention.cu;
//  3. drba_layer_tail: merge -> LayerNorm -> [concat-FFN 256 -> hidden ->
//     exact GELU -> 128 -> LayerNorm] -> residual. Tokens are independent
//     here, so a tile's intermediates never leave the block.
//
// Rounding follows the TPU kernel: q/k/v and the attention output in the
// compute dtype T, the merge and both LayerNorms in f32, the FFN hidden
// rounded to T before GELU, the FFN sum in f32, the residual sum in f32 and
// rounded once. GELU is 0.5 x erfc(-x sqrt(1/2)) with CUDA's erfcf and
// jax.nn.gelu's rounding points in T (argument, erfc, 0.5 x, product).
//
// Weights come packed once per model (ops/attn_layer.pack_layer_weights), a
// (K, N) weight stored (in, out) as N/64 slabs of K rows of 64 columns, the
// 8-element groups of row k XOR-permuted by k % 8: element (k, n) at
// ((n / 64) K + k) 64 + (((n % 64) / 8) ^ (k % 8)) 8 + n % 8. In bf16 that
// is wgmma's MN-major B operand with the 128-byte swizzle, byte for byte,
// so a weight block reaches shared memory by a linear copy. q|k|v is one
// (128, 384) weight; the FFN is hidden / 64 chunks of [W0[:, 64 j .. +64]
// (256 x 64) | W2[64 j .. +64, :] (64 x 128)], 48 KB each in bf16.
//
// bf16 (the main path), on wgmma. One block = two consumer warpgroups of 64
// tokens, a 128-token tile; the grid is persistent (a block walks tiles).
// What bounds this layer on the card and what the design does about it:
//  * Weight traffic. The projection's 96 KB weight is loaded into shared
//    memory once per block; the tail keeps the 32 KB merge weight resident
//    and streams the FFN's 48 KB chunks through a two-stage cp.async ring
//    (chunk j + 1 lands while chunk j is multiplied), each chunk shared by
//    both warpgroups: 800 KB of L2 reads per 128 tokens, where the WMMA
//    kernel this replaces read about 3 MB per 64 tokens fragment by fragment.
//  * Round trips. Every product accumulates in registers. LayerNorm works on
//    the accumulator layout (a row's 128 columns lie in one quad: two
//    shuffles a reduction). The normalised message, rounded to T, stays in
//    registers as the A fragments of the FFN's second 128 input columns
//    ([x | message] . W0: x from shared memory, the message from registers);
//    each 64-wide hidden chunk is GELU'd in its registers and fed straight
//    back as the A operand of the W2 product; the FFN sum stays in registers
//    across all chunks. Only the input tiles and the output staging touch
//    shared memory.
//  * What is left: a cross layer's tail streams its 768 KB of FFN weights
//    from L2 for every 128-token tile (0.78 GB for the 130560 tokens of
//    GMFlow's scale 1, where its products would take 0.11 ms on the tensor
//    cores). The GELU is not what holds it: an exact table of bf16 erfc
//    values, which removed most of the GELU's FP32 work, moved it by 2%;
//    the stream is the likely bound. Larger token tiles per block, or
//    cluster multicast of the chunks, would cut it.
// f32: every product on the FMA pipes (64-token tiles, 256 threads, the
// intermediates in shared memory), reading the same packed weights.

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace drba;

constexpr int kC = 128;        // channels
constexpr int kThreads = 256;  // two warpgroups (bf16) / eight warps (f32)
constexpr int kHChunk = 64;    // hidden columns per packed FFN chunk
constexpr int kW0Chunk = 2 * kC * kHChunk;        // elements of a chunk's W0 part
constexpr int kFfnChunk = kW0Chunk + kHChunk * kC;  // elements of a packed FFN chunk
constexpr float kEps = 1e-5f;
constexpr int kMaxDevices = 16;

// --------------------------------------------------------------- bf16: wgmma

constexpr int kRows = 128;                     // tokens per tile
constexpr int kTileBytes = kRows * kC * 2;     // one swizzled bf16 tile
constexpr int kSlab = kRows * 128;             // bytes of one 64-channel half of a tile
constexpr int kChunkBytes = kFfnChunk * 2;     // one packed FFN chunk in bf16

// A 128 x 128 bf16 tile is two 64-channel halves of 128 rows x 128 bytes,
// the 16-byte chunks of row r XOR-swizzled by r % 8 (wgmma's K-major A with
// the 128-byte swizzle). Byte offset of chunk cc (0..15) of row r:
__device__ __forceinline__ uint32_t tile_off(int r, int cc) {
  return (cc >> 3) * kSlab + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
}

// A operand: the 64 rows of warpgroup wg, k16 step kk
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int wg, int kk) {
  return gmma_desc(tile + (kk >> 2) * kSlab + wg * 64 * 128 + (kk & 3) * 32, 16, 1024);
}
// B operand: a packed weight block (64-column slabs `slab` bytes apart),
// k16 step t
__device__ __forceinline__ uint64_t desc_b(uint32_t w, int slab, int t) {
  return gmma_desc(w + t * 2048, slab, 1024);
}

// rows [r0, r0 + 128) of a contiguous (M, 128) bf16 array into a tile;
// rows past M are zero
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src, long long r0,
                                                long long M) {
  for (int e = threadIdx.x; e < kRows * 16; e += kThreads) {
    const int r = e >> 4, cc = e & 15;
    const bool ok = r0 + r < M;
    cp_async<16>(dst + tile_off(r, cc), src + (ok ? (r0 + r) * kC + cc * 8 : 0), ok);
  }
}

// `bytes` (a multiple of 16) of a packed weight block, as they lie
__device__ __forceinline__ void load_linear_async(uint32_t dst, const void* src, int bytes) {
  const char* s = static_cast<const char*>(src);
  for (int o = threadIdx.x * 16; o < bytes; o += kThreads * 16) cp_async<16>(dst + o, s + o, true);
}

// Thread layout of a warpgroup's 64 x N accumulator (wgmma.cuh): rows r0
// and r0 + 8 of the tile, columns 8 (i / 4) + col + (i % 2).
struct Lane {
  int wg, r0, col;
  __device__ __forceinline__ Lane() {
    const int tid = threadIdx.x, lane = tid & 31;
    wg = tid >> 7;
    r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    col = 2 * (lane & 3);
  }
};

// LayerNorm of each row of a 64 x 128 accumulator in place, in f32, with
// the statistics of drba_tpu/models/layers.py:layer_norm
__device__ __forceinline__ void layer_norm_acc(float (&d)[64], const bf16* gamma,
                                               const bf16* beta, int col) {
  float mu[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) mu[(i >> 1) & 1] += d[i];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mu[h] += __shfl_xor_sync(0xffffffffu, mu[h], 1);
    mu[h] += __shfl_xor_sync(0xffffffffu, mu[h], 2);
    mu[h] /= kC;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    d[i] -= mu[(i >> 1) & 1];
    q[(i >> 1) & 1] += d[i] * d[i];
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q[h] += __shfl_xor_sync(0xffffffffu, q[h], 1);
    q[h] += __shfl_xor_sync(0xffffffffu, q[h], 2);
    inv[h] = rsqrtf(q[h] / kC + kEps);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 g =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gamma + 8 * j + col));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(beta + 8 * j + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d[4 * j + 2 * h] = d[4 * j + 2 * h] * inv[h] * g.x + b.x;
      d[4 * j + 2 * h + 1] = d[4 * j + 2 * h + 1] * inv[h] * g.y + b.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ float gelu_exact(float h) {
  const float sqrt_half = round_to<T>(0.70710678118654752f);
  const float e = round_to<T>(erfcf(round_to<T>(-h * sqrt_half)));
  return round_to<T>(round_to<T>(0.5f * h) * e);
}

// a 64 x 128 f32 accumulator (plus the tile `add`, if any, in f32), rounded
// to bf16 once, into the swizzled staging tile
__device__ __forceinline__ void stage_acc(unsigned char* stage, const float (&d)[64],
                                          const unsigned char* add, const Lane& ln) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = ln.r0 + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + ln.col;
    const uint32_t off = tile_off(r, c >> 3) + (c & 7) * 2;
    float lo = d[i], hi = d[i + 1];
    if (add != nullptr) {
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(add + off);
      lo += __low2float(xv);
      hi += __high2float(xv);
    }
    *reinterpret_cast<uint32_t*>(stage + off) = pack_bf16(lo, hi);
  }
}

// the staged tile's valid rows to out (row stride ld elements, column
// offset c0) as 16-byte row chunks
__device__ __forceinline__ void store_tile(bf16* out, int ld, int c0, const unsigned char* stage,
                                           long long r0, long long M) {
  for (int e = threadIdx.x; e < kRows * 16; e += kThreads) {
    const int r = e >> 4, cc = e & 15;
    if (r0 + r < M)
      *reinterpret_cast<uint4*>(out + (r0 + r) * ld + c0 + cc * 8) =
          *reinterpret_cast<const uint4*>(stage + tile_off(r, cc));
  }
}

// Shared memory of the projection: the packed q|k|v weight, the x and
// target tiles, the output staging (offsets from a 1024-byte aligned base)
struct ProjSmem {
  static constexpr int kW = 0;
  static constexpr int kX = 3 * kC * kC * 2;
  static constexpr int kT = kX + kTileBytes;
  static constexpr int kO = kT + kTileBytes;
  static constexpr int kBytes = 1024 + kO + kTileBytes;
};

__global__ void __launch_bounds__(kThreads, 1)
layer_proj_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ tgt,
                        const bf16* __restrict__ wp, bf16* __restrict__ qkv, long long M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  using S = ProjSmem;
  const Lane ln;
  const bool self = tgt == x;  // k and v from x itself: one tile
  const long long tiles = (M + kRows - 1) / kRows;

  load_linear_async(base + S::kW, wp, 3 * kC * kC * 2);
  long long t = blockIdx.x;
  if (t < tiles) {
    load_tile_async(base + S::kX, x, t * kRows, M);
    if (!self) load_tile_async(base + S::kT, tgt, t * kRows, M);
  }
  cp_async_commit();
  for (; t < tiles; t += gridDim.x) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    for (int seg = 0; seg < 3; ++seg) {  // q, k, v
      const uint32_t a = base + (seg == 0 || self ? S::kX : S::kT);
      float d[64];
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        wgmma_m64n128_ss<1>(d, desc_a(a, ln.wg, kk),
                            desc_b(base + S::kW + seg * 2 * kSlab, kSlab, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d);
      if (seg == 2) {
        // both warpgroups are done with the input tiles: fetch the next ones
        // while this tile's v is stored
        __syncthreads();
        const long long tn = t + gridDim.x;
        if (tn < tiles) {
          load_tile_async(base + S::kX, x, tn * kRows, M);
          if (!self) load_tile_async(base + S::kT, tgt, tn * kRows, M);
        }
        cp_async_commit();
      }
      stage_acc(smem + S::kO, d, nullptr, ln);
      __syncthreads();
      store_tile(qkv, 3 * kC, seg * kC, smem + S::kO, t * kRows, M);
      __syncthreads();
    }
  }
  cp_async_wait<0>();
}

// Shared memory of the tail: the x tile, the attention-output tile (then the
// output staging), the packed merge weight and, with the FFN, a two-stage
// ring of packed FFN chunks
struct TailSmem {
  static constexpr int kX = 0;
  static constexpr int kA = kTileBytes;
  static constexpr int kWm = 2 * kTileBytes;
  static constexpr int kRing = kWm + kC * kC * 2;
  static constexpr int bytes(bool ffn) { return 1024 + kRing + (ffn ? 2 * kChunkBytes : 0); }
};

template <bool kFfn>
__global__ void __launch_bounds__(kThreads, kFfn ? 1 : 2)
layer_tail_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ av,
                        const bf16* __restrict__ wm, const bf16* __restrict__ g1,
                        const bf16* __restrict__ b1, const bf16* __restrict__ ffn,
                        const bf16* __restrict__ g2, const bf16* __restrict__ b2, int chunks,
                        bf16* __restrict__ out, long long M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  using S = TailSmem;
  const Lane ln;
  const long long tiles = (M + kRows - 1) / kRows;

  load_linear_async(base + S::kWm, wm, kC * kC * 2);  // resident for every tile
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    load_tile_async(base + S::kX, x, t * kRows, M);
    load_tile_async(base + S::kA, av, t * kRows, M);
    if (kFfn) load_linear_async(base + S::kRing, ffn, kChunkBytes);  // chunk 0, stage 0
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();

    // merge, then LayerNorm, on the accumulator
    float d[64];
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      wgmma_m64n128_ss<1>(d, desc_a(base + S::kA, ln.wg, kk), desc_b(base + S::kWm, kSlab, kk),
                          kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
    layer_norm_acc(d, g1, b1, ln.col);

    if constexpr (kFfn) {
      // the message in T: the A fragments of W0's rows 128..255
      uint32_t msg[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) msg[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
      // d now accumulates the FFN's output over the hidden chunks
      for (int j = 0; j < chunks; ++j) {
        const int st = j & 1;
        if (j + 1 < chunks)
          load_linear_async(base + S::kRing + (st ^ 1) * kChunkBytes,
                            ffn + static_cast<long long>(j + 1) * kFfnChunk, kChunkBytes);
        cp_async_commit();
        cp_async_wait<1>();  // chunk j has landed
        fence_async_smem();
        __syncthreads();
        const uint32_t w0 = base + S::kRing + st * kChunkBytes, w2 = w0 + kW0Chunk * 2;
        // hidden chunk (64 x 64) = [x | message] . W0 chunk
        float h[32];
        fence_regs(h);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kC / 16; ++kk)
          wgmma_m64n64_ss<1>(h, desc_a(base + S::kX, ln.wg, kk), desc_b(w0, 2 * kC * 128, kk),
                             kk > 0);
#pragma unroll
        for (int kk = 0; kk < kC / 16; ++kk)
          wgmma_m64n64_rs<1>(h, msg[4 * kk], msg[4 * kk + 1], msg[4 * kk + 2], msg[4 * kk + 3],
                             desc_b(w0, 2 * kC * 128, kC / 16 + kk), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(h);
        // hidden rounded to T, exact GELU in T: the A fragments of W2's rows
        uint32_t g[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          g[i] = pack_bf16(gelu_exact<bf16>(round_to<bf16>(h[2 * i])),
                           gelu_exact<bf16>(round_to<bf16>(h[2 * i + 1])));
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHChunk / 16; ++kk)
          wgmma_m64n128_rs<1>(d, g[4 * kk], g[4 * kk + 1], g[4 * kk + 2], g[4 * kk + 3],
                              desc_b(w2, kHChunk * 128, kk), j > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(d);
        __syncthreads();  // stage st is free for chunk j + 2
      }
      layer_norm_acc(d, g2, b2, ln.col);
    }

    // residual: x + (the message or the FFN's output), rounded once; the
    // attention tile is free (each warpgroup read only its own rows of it)
    stage_acc(smem + S::kA, d, smem + S::kX, ln);
    __syncthreads();
    store_tile(out, kC, 0, smem + S::kA, t * kRows, M);
    __syncthreads();
  }
}

// --------------------------------------------------------------------- f32: FMA

constexpr int kRowsF = 64;     // tokens per block
constexpr int kLdf = kC + 4;   // f32 row stride in shared memory

// rows [r0, r0 + 64) of a contiguous (M, 128) f32 array into shared memory;
// rows past M are zero
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long r0,
                                              long long M) {
  for (int e = threadIdx.x; e < kRowsF * kC / 4; e += kThreads) {
    const int r = e / (kC / 4), c = (e % (kC / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < M) val = *reinterpret_cast<const float4*>(src + (r0 + r) * kC + c);
    *reinterpret_cast<float4*>(dst + r * kLdf + c) = val;
  }
}

// C (64 x 128 f32 in shared memory, stride kLdf) = [C +] A . B, with A the
// 64 x K tile [A0 | A1] (each 64 x 128, stride kLdf; A1 only when K == 256)
// and B packed: row k of its 64-column slab h starts at rows(k, h). Thread
// t computes rows 4 (t / 16) .. +4, columns 4 (t % 16) .. +4 of each slab.
template <typename Rows>
__device__ __forceinline__ void tile_gemm_f32(const float* A0, const float* A1, Rows rows, int K,
                                              float* C, bool accumulate) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[r][j] = accumulate ? C[(4 * rg + r) * kLdf + (j >> 2) * 64 + 4 * cg + (j & 3)] : 0.f;
  for (int k = 0; k < K; ++k) {
    const float* A = k < kC ? A0 + k : A1 + (k - kC);
    // columns 4 cg .. +4 of a packed row: group cg / 2, XOR-permuted by k % 8
    const int e = (((cg >> 1) ^ (k & 7)) << 3) + 4 * (cg & 1);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(rows(k, 0) + e));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(rows(k, 1) + e));
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = A[(4 * rg + r) * kLdf];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a, bv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      C[(4 * rg + r) * kLdf + (j >> 2) * 64 + 4 * cg + (j & 3)] = acc[r][j];
}

// LayerNorm of each row of C (64 x 128 f32) in place; warp w takes rows
// 8w .. 8w + 8, each lane 4 channels
__device__ __forceinline__ void layer_norm_rows(float* C, const float* gamma,
                                                const float* beta) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4 gv = reinterpret_cast<const float4*>(gamma)[lane];
  const float4 bv = reinterpret_cast<const float4*>(beta)[lane];
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float4* row = reinterpret_cast<float4*>(C + r * kLdf) + lane;
    float4 x = *row;
    float s = x.x + x.y + x.z + x.w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / kC;
    x.x -= mu;
    x.y -= mu;
    x.z -= mu;
    x.w -= mu;
    float q = x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float inv = rsqrtf(q / kC + kEps);
    *row = make_float4(x.x * inv * gv.x + bv.x, x.y * inv * gv.y + bv.y,
                       x.z * inv * gv.z + bv.z, x.w * inv * gv.w + bv.w);
  }
}

// row k of 64-column slab h of a packed (K, N) weight at w
__device__ __forceinline__ const float* slab_row(const float* w, int K, int k, int h) {
  return w + (static_cast<long long>(h) * K + k) * 64;
}

__global__ void __launch_bounds__(kThreads)
layer_proj_fma_kernel(const float* __restrict__ x, const float* __restrict__ tgt,
                      const float* __restrict__ wp, float* __restrict__ qkv, long long M) {
  extern __shared__ __align__(128) unsigned char smem_f[];
  float* sX = reinterpret_cast<float*>(smem_f);
  float* sC = sX + kRowsF * kLdf;
  const int seg = blockIdx.y;  // 0: q from x; 1, 2: k, v from the target
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsF;
  load_tile_f32(sX, seg == 0 ? x : tgt, r0, M);
  __syncthreads();
  tile_gemm_f32(sX, sX, [&](int k, int h) { return slab_row(wp, kC, k, 2 * seg + h); }, kC, sC,
                false);
  __syncthreads();
  for (int e = threadIdx.x; e < kRowsF * kC; e += kThreads) {
    const int r = e / kC, c = e % kC;
    if (r0 + r < M) qkv[(r0 + r) * 3 * kC + seg * kC + c] = sC[r * kLdf + c];
  }
}

__global__ void __launch_bounds__(kThreads)
layer_tail_fma_kernel(const float* __restrict__ x, const float* __restrict__ av,
                      const float* __restrict__ wm, const float* __restrict__ g1,
                      const float* __restrict__ b1, const float* __restrict__ ffn,
                      const float* __restrict__ g2, const float* __restrict__ b2, int chunks,
                      float* __restrict__ out, long long M) {
  extern __shared__ __align__(128) unsigned char smem_f[];
  constexpr int kT = kRowsF * kLdf;
  float* sX = reinterpret_cast<float*>(smem_f);  // the layer's input
  float* sA = sX + kT;                           // attention output, then the message
  float* sH = sA + kT;                           // GELU of one 128-wide hidden chunk
  float* sC = sH + kT;                           // message, then a hidden chunk
  float* sAcc = sC + kT;                         // FFN output
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsF;

  load_tile_f32(sX, x, r0, M);
  load_tile_f32(sA, av, r0, M);
  __syncthreads();
  tile_gemm_f32(sA, sA, [&](int k, int h) { return slab_row(wm, kC, k, h); }, kC, sC, false);
  __syncthreads();
  layer_norm_rows(sC, g1, b1);
  __syncthreads();
  float* res = sC;  // what the residual adds: the message, or the FFN's output
  if (ffn != nullptr) {
    for (int e = threadIdx.x; e < kRowsF * kC; e += kThreads)
      sA[(e / kC) * kLdf + e % kC] = sC[(e / kC) * kLdf + e % kC];
    __syncthreads();
    // hidden chunks of 128 = packed chunks 2 c and 2 c + 1
    for (int c = 0; c < chunks; c += 2) {
      const float* ch = ffn + static_cast<long long>(c) * kFfnChunk;
      // hidden = [x | message] . W0[:, 64 c .. +128]
      tile_gemm_f32(sX, sA, [&](int k, int h) { return slab_row(ch + h * kFfnChunk, 2 * kC, k, 0); },
                    2 * kC, sC, false);
      __syncthreads();
      for (int e = threadIdx.x; e < kRowsF * kC; e += kThreads) {
        const int r = e / kC, cc = e % kC;
        sH[r * kLdf + cc] = gelu_exact<float>(sC[r * kLdf + cc]);
      }
      __syncthreads();
      // FFN output += gelu . W2[64 c .. +128, :] (its rows in the two chunks)
      tile_gemm_f32(sH, sH, [&](int k, int h) {
        return slab_row(ch + (k >> 6) * kFfnChunk + kW0Chunk, kHChunk, k & 63, h);
      }, kC, sAcc, c > 0);
      __syncthreads();
    }
    layer_norm_rows(sAcc, g2, b2);
    __syncthreads();
    res = sAcc;
  }
  for (int e = threadIdx.x; e < kRowsF * kC; e += kThreads) {
    const int r = e / kC, c = e % kC;
    if (r0 + r < M) out[(r0 + r) * kC + c] = sX[r * kLdf + c] + res[r * kLdf + c];
  }
}

// ----------------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// A persistent grid: as many blocks as fit on the card at once, at most
// one per tile. The occupancy of each kernel holds per device; asked once
// per kTag (one tag per kernel: kernels of one signature share K). Host
// threads may launch at once (one per device or stream): the cache is
// atomic, and a thread that finds it empty asks the runtime itself.
template <int kTag, typename K>
cudaError_t persistent_grid(K kernel, int bytes, long long tiles, int* grid) {
  static std::atomic<int> per_sm[kMaxDevices] = {};
  int dev = 0, sms = 0, nb = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && per_sm[dev] > 0) {
    nb = per_sm[dev];
  } else {
    e = allow_smem(kernel, bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, kThreads, bytes);
    if (e != cudaSuccess) return e;
    if (nb < 1) return cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) per_sm[dev] = nb;
  }
  *grid = static_cast<int>(tiles < static_cast<long long>(nb) * sms ? tiles
                                                                     : static_cast<long long>(nb) * sms);
  return cudaSuccess;
}

}  // namespace

// x, tgt (M, 128) (tgt == x for a self layer), wp the packed q|k|v weight
// (128 x 384, see above), qkv (M, 384) = [x Wq | tgt Wk | tgt Wv]; all
// contiguous, one dtype (f32|bf16), 32-byte aligned (checked by the
// caller). Returns cudaGetLastError().
extern "C" int drba_layer_proj(const void* x, const void* tgt, const void* wp, void* qkv,
                               long long M, int dtype, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == kBF16) {
    int grid = 0;
    e = persistent_grid<0>(layer_proj_wgmma_kernel, ProjSmem::kBytes, cdiv(M, kRows), &grid);
    if (e == cudaSuccess)
      layer_proj_wgmma_kernel<<<grid, kThreads, ProjSmem::kBytes, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(tgt),
          static_cast<const bf16*>(wp), static_cast<bf16*>(qkv), M);
  } else if (dtype == kF32) {
    constexpr int bytes = 2 * kRowsF * kLdf * 4;
    e = allow_smem(layer_proj_fma_kernel, bytes);
    if (e == cudaSuccess)
      layer_proj_fma_kernel<<<dim3(cdiv(M, kRowsF), 3), kThreads, bytes, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(tgt),
          static_cast<const float*>(wp), static_cast<float*>(qkv), M);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// x, av (M, 128): the layer input and the attention output; wm the packed
// merge weight (128 x 128); g1, b1 (128,): norm1's gamma and beta; ffn the
// packed FFN chunks (hidden / 64 of them, see above) and g2, b2 (128,), or
// all three NULL for a layer without FFN; out (M, 128). Weights and norms in
// x's dtype (f32|bf16), the norms applied in f32;
// all contiguous and 32-byte aligned (checked by the caller); hidden a
// multiple of 128. Returns cudaGetLastError().
extern "C" int drba_layer_tail(const void* x, const void* av, const void* wm, const void* g1,
                               const void* b1, const void* ffn, const void* g2, const void* b2,
                               void* out, int hidden, long long M, int dtype, void* stream) {
  if (M == 0) return 0;
  if (ffn != nullptr && (hidden <= 0 || hidden % kC != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = ffn != nullptr ? hidden / kHChunk : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == kBF16) {
    auto launch = [&](auto with_ffn) {  // std::true_type or std::false_type
      constexpr bool kFfn = decltype(with_ffn)::value;
      const auto kernel = layer_tail_wgmma_kernel<kFfn>;
      const int bytes = TailSmem::bytes(kFfn);
      int grid = 0;
      e = persistent_grid<1 + kFfn>(kernel, bytes, cdiv(M, kRows), &grid);
      if (e == cudaSuccess)
        kernel<<<grid, kThreads, bytes, s>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(av),
            static_cast<const bf16*>(wm), static_cast<const bf16*>(g1),
            static_cast<const bf16*>(b1), static_cast<const bf16*>(ffn),
            static_cast<const bf16*>(g2), static_cast<const bf16*>(b2), chunks,
            static_cast<bf16*>(out), M);
    };
    if (ffn != nullptr)
      launch(std::true_type{});
    else
      launch(std::false_type{});
  } else if (dtype == kF32) {
    constexpr int bytes = 5 * kRowsF * kLdf * 4;
    e = allow_smem(layer_tail_fma_kernel, bytes);
    if (e == cudaSuccess)
      layer_tail_fma_kernel<<<cdiv(M, kRowsF), kThreads, bytes, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(av),
          static_cast<const float*>(wm), static_cast<const float*>(g1),
          static_cast<const float*>(b1), static_cast<const float*>(ffn),
          static_cast<const float*>(g2), static_cast<const float*>(b2), chunks,
          static_cast<float*>(out), M);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
