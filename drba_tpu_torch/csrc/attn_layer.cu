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
// bf16 weights come packed once per model (ops/attn_layer.pack_layer_weights),
// a (K, N) weight stored (in, out) as N/64 slabs of K rows of 64 columns, the
// 8-element groups of row k XOR-permuted by k % 8: element (k, n) at
// ((n / 64) K + k) 64 + (((n % 64) / 8) ^ (k % 8)) 8 + n % 8. In bf16 that
// is wgmma's MN-major B operand with the 128-byte swizzle, byte for byte,
// so a weight block reaches shared memory by a linear copy. q|k|v is one
// (128, 384) weight; the FFN is hidden / 64 chunks of [W0[:, 64 j .. +64]
// (256 x 64) | W2[64 j .. +64, :] (64 x 128)], 48 KB each in bf16. f32
// weights come split in fragment order (see the f32 section).
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
// f32 (--fp32): every product on the tensor cores in 3xTF32 (tf32.cuh:
// mma.sync, f32-accurate), 128-token tiles of eight warps, the weights packed
// split in fragment order and streamed through a three-stage ring (see the
// f32 section below). Bound: the scale-1 cross layer's projection, merge and
// FFN, 3 x 120 GFLOP -> 0.73 ms at 495 TFLOP/s TF32; the FFN's 3 MB of
// split weights per 128 tokens, 3.2 GB from L2 over 130560 tokens, is the
// other limit. One f32 tile is 68 KB and a chunk 48 KB, so shared memory
// (212 KB: the x tile and three chunk stages) holds one block an SM.

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"
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

// ---------------------------------------------------------------- f32: 3xTF32

// The f32 weights come packed and split once per model
// (ops/attn_layer.pack_frags), in the m16n8k8 B-fragment order of
// tf32.cuh: a (K, N) weight is K/8 k-steps x N/8 column tiles x 32 lanes
// of float4 (hi b0, hi b1, lo b0, lo b1), lane 4 g + t holding rows
// 8 kk + 2 t and 8 kk + 2 t + 1 of column 8 nt + g: one 16-byte shared
// load a lane per fragment, no split in the kernel. q|k|v is three such
// (128, 128) weights; the FFN is hidden / 16 chunks of [W0[:, 16 j .. +16]
// | W2[16 j .. +16, :]], 48 KB each.
//
// One block = eight warps of 16 tokens (a 128-token tile); each warp
// keeps its rows' 128 output columns in registers (the accumulator layout
// of the bf16 kernels' warps). The weights stream through a three-stage
// cp.async ring shared by the eight warps (item i + 2 lands while item i
// is multiplied): per 128 tokens the tail reads its 128 KB merge weight
// and 3 MB of FFN chunks from L2, the projection its 384 KB. The A operands
// are split in registers: the layer input from a shared tile, the attention
// output from device memory straight into fragments, the normalised
// message and each GELU'd hidden chunk from their accumulators ({c0, c2,
// c1, c3}, the packing relabels k to match).

constexpr int kRowsT = 128;                           // tokens per block
constexpr int kLdX = kC + 8;                          // f32 pitch of the x tile
constexpr int kHT = 16;                               // hidden columns per f32 FFN chunk
constexpr int kFrag = 32;                             // float4s of one fragment block
constexpr int kItemT = 4 * (kC / 8) * kFrag * 16;     // 4 k-steps of a (128, 128) weight: 32 KB
constexpr int kChunkT = (2 * kC * kHT + kHT * kC) * 8;  // one FFN chunk: 48 KB
constexpr int kNStages = 3;

// LayerNorm of each row of a warp's 16 x 128 accumulator in place (rows in
// quads, as layer_norm_acc), f32 gamma and beta
__device__ __forceinline__ void layer_norm_f32(float (&d)[64], const float* gamma,
                                               const float* beta, int col) {
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
    const float2 g = __ldg(reinterpret_cast<const float2*>(gamma + 8 * j + col));
    const float2 b = __ldg(reinterpret_cast<const float2*>(beta + 8 * j + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d[4 * j + 2 * h] = d[4 * j + 2 * h] * inv[h] * g.x + b.x;
      d[4 * j + 2 * h + 1] = d[4 * j + 2 * h + 1] * inv[h] * g.y + b.y;
    }
  }
}

// The A fragments of 16 k-steps (128 columns) of rows r and r + 8 of a
// contiguous (M, 128) f32 array, from device memory; rows past M are zero
__device__ __forceinline__ void load_frags(float (&a)[16][4], const float* src, long long r,
                                           long long M, int col) {
  const float2 z = make_float2(0.f, 0.f);
#pragma unroll
  for (int kk = 0; kk < kC / 8; ++kk) {
    const float* p = src + r * kC + 8 * kk + col;
    const float2 u = r < M ? __ldg(reinterpret_cast<const float2*>(p)) : z;
    const float2 v = r + 8 < M ? __ldg(reinterpret_cast<const float2*>(p + 8 * kC)) : z;
    a[kk][0] = u.x;
    a[kk][1] = v.x;
    a[kk][2] = u.y;
    a[kk][3] = v.y;
  }
}

// d (16 x 128) += a (16 x 32: k-steps 4 q .. 4 q + 3 of a) . one 32 KB item
// (four k-steps x 16 column tiles; w: this lane's float4 of its first block)
__device__ __forceinline__ void mma_item(float (&d)[64], const float (&a)[16][4], int q,
                                         const float4* w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const FragA fa(a[4 * q + k][0], a[4 * q + k][1], a[4 * q + k][2], a[4 * q + k][3]);
#pragma unroll
    for (int nt = 0; nt < kC / 8; ++nt)
      mma_3xtf32(DRBA_ACC4(d, nt), fa, w[(k * 16 + nt) * kFrag]);
  }
}

// rows r and r + 8 of a warp's 16 x 128 accumulator (plus `add`'s rows,
// pitch ld, if any) to out (row pitch ldo), rows past M skipped
__device__ __forceinline__ void store_rows(float* out, int ldo, const float (&d)[64],
                                           const float* add, int ld, long long r, long long M,
                                           int col) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= M) continue;
    float* o = out + (r + 8 * h) * ldo + col;
#pragma unroll
    for (int nt = 0; nt < kC / 8; ++nt) {
      float2 v = make_float2(d[4 * nt + 2 * h], d[4 * nt + 2 * h + 1]);
      if (add != nullptr) {
        const float2 xa = *reinterpret_cast<const float2*>(add + 8 * h * ld + 8 * nt);
        v.x += xa.x;
        v.y += xa.y;
      }
      *reinterpret_cast<float2*>(o + 8 * nt) = v;
    }
  }
}

// The weight ring: item i lands in stage i % kNStages; acquire(i) waits
// for it (every thread's copies, and every warp done with item i - 1) and
// starts item i + kNStages - 1 in that freed stage.
template <typename Issue>
__device__ __forceinline__ const float4* acquire(const unsigned char* ring, int stage_bytes,
                                                 int i, Issue issue) {
  cp_async_wait<kNStages - 2>();
  __syncthreads();
  issue(i + kNStages - 1);
  return reinterpret_cast<const float4*>(ring + (i % kNStages) * stage_bytes) + (threadIdx.x & 31);
}

__global__ void __launch_bounds__(kThreads, 1)
layer_proj_tf32_kernel(const float* __restrict__ x, const float* __restrict__ tgt,
                       const float* __restrict__ wp, float* __restrict__ qkv, long long M) {
  extern __shared__ __align__(16) unsigned char smem_t[];
  const uint32_t base = smem_u32(smem_t);
  const int col = 2 * (threadIdx.x & 3);
  const long long r = static_cast<long long>(blockIdx.x) * kRowsT + (threadIdx.x >> 5) * 16 +
                      ((threadIdx.x & 31) >> 2);
  const bool self = tgt == x;  // k and v from x itself
  auto issue = [&](int i) {  // item i: k-steps 4 (i % 4) .. +4 of segment i / 4 (q, k, v)
    if (i < 12) load_linear_async(base + (i % kNStages) * kItemT, wp + i * (kItemT / 4), kItemT);
    cp_async_commit();
  };
  for (int i = 0; i < kNStages - 1; ++i) issue(i);

  float a[16][4];
  for (int seg = 0; seg < 3; ++seg) {
    if (seg == 0 || (seg == 1 && !self)) load_frags(a, seg == 0 ? x : tgt, r, M, col);
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) mma_item(d, a, q, acquire(smem_t, kItemT, 4 * seg + q, issue));
    store_rows(qkv + seg * kC, 3 * kC, d, nullptr, 0, r, M, col);
  }
  cp_async_wait<0>();
}

// Shared memory of the f32 tail: the x tile (read by the FFN and the
// residual), then the ring of kNStages stages of one FFN chunk each
struct TailF32Smem {
  static constexpr int kRing = kRowsT * kLdX * 4;
  static constexpr int kBytes = kRing + kNStages * kChunkT;
};

template <bool kFfn>
__global__ void __launch_bounds__(kThreads, 1)
layer_tail_tf32_kernel(const float* __restrict__ x, const float* __restrict__ av,
                       const float* __restrict__ wm, const float* __restrict__ g1,
                       const float* __restrict__ b1, const float* __restrict__ ffn,
                       const float* __restrict__ g2, const float* __restrict__ b2, int chunks,
                       float* __restrict__ out, long long M) {
  extern __shared__ __align__(16) unsigned char smem_t[];
  const uint32_t base = smem_u32(smem_t);
  const unsigned char* ring = smem_t + TailF32Smem::kRing;
  const int col = 2 * (threadIdx.x & 3);
  const int rt = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);  // row in the tile
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsT, r = row0 + rt;
  const int items = 4 + (kFfn ? chunks : 0);

  // the x tile (rows past M zero) lands with item 0
  for (int e = threadIdx.x; e < kRowsT * 32; e += kThreads) {
    const int rr = e >> 5, cc = e & 31;
    const bool ok = row0 + rr < M;
    cp_async<16>(base + rr * kLdX * 4 + cc * 16, x + (ok ? (row0 + rr) * kC + cc * 4 : 0), ok);
  }
  // items 0-3: the merge weight's k-quarters; 4 + j: FFN chunk j
  auto issue = [&](int i) {
    const uint32_t dst = base + TailF32Smem::kRing + (i % kNStages) * kChunkT;
    if (i < 4)
      load_linear_async(dst, wm + i * (kItemT / 4), kItemT);
    else if (i < items)
      load_linear_async(dst, ffn + static_cast<long long>(i - 4) * (kChunkT / 4), kChunkT);
    cp_async_commit();
  };
  for (int i = 0; i < kNStages - 1; ++i) issue(i);

  // merge, then LayerNorm, on the accumulator
  float d[64];
  {
    float a[16][4];
    load_frags(a, av, r, M, col);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) mma_item(d, a, q, acquire(ring, kChunkT, q, issue));
  }
  layer_norm_f32(d, g1, b1, col);

  const float* xs = reinterpret_cast<const float*>(smem_t) + rt * kLdX + col;
  if constexpr (kFfn) {
    // f accumulates the FFN's output over the hidden chunks; d is the
    // message, the A fragments of W0's rows 128..255
    float f[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) f[i] = 0.f;
    for (int j = 0; j < chunks; ++j) {
      const float4* w = acquire(ring, kChunkT, 4 + j, issue);
      // the hidden chunk (16 x 16) = [x | message] . W0 chunk, the two halves
      // in accumulators of their own (h[0..7] and h[8..15]): four
      // independent mma chains a warp, not two of twice the length
      float h[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) h[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kC / 8; ++kk) {
        const FragA ax(*reinterpret_cast<const float2*>(xs + 8 * kk),
                       *reinterpret_cast<const float2*>(xs + 8 * kLdX + 8 * kk));
        const FragA am(d[4 * kk], d[4 * kk + 2], d[4 * kk + 1], d[4 * kk + 3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_3xtf32(DRBA_ACC4(h, nt), ax, w[(2 * kk + nt) * kFrag]);
          mma_3xtf32(DRBA_ACC4(h, 2 + nt), am, w[(2 * (16 + kk) + nt) * kFrag]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = gelu_exact<float>(h[i] + h[8 + i]);
      const float4* w2 = w + 2 * (2 * kC / 8) * kFrag;  // after W0's 32 k-steps x 2 tiles
#pragma unroll
      for (int kk = 0; kk < kHT / 8; ++kk) {  // f += gelu(hidden) . W2 chunk
        const FragA a(h[4 * kk], h[4 * kk + 2], h[4 * kk + 1], h[4 * kk + 3]);
#pragma unroll
        for (int nt = 0; nt < kC / 8; ++nt)
          mma_3xtf32(DRBA_ACC4(f, nt), a, w2[(kk * 16 + nt) * kFrag]);
      }
    }
    layer_norm_f32(f, g2, b2, col);
    store_rows(out, kC, f, xs, kLdX, r, M, col);  // the residual: x + the FFN's output
  } else {
    store_rows(out, kC, d, xs, kLdX, r, M, col);  // x + the message (the tile landed with item 0)
  }
  cp_async_wait<0>();
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
    constexpr int bytes = kNStages * kItemT;
    e = allow_smem(layer_proj_tf32_kernel, bytes);
    if (e == cudaSuccess)
      layer_proj_tf32_kernel<<<cdiv(M, kRowsT), kThreads, bytes, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(tgt),
          static_cast<const float*>(wp), static_cast<float*>(qkv), M);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// x, av (M, 128): the layer input and the attention output; wm the packed
// merge weight (128 x 128); g1, b1 (128,): norm1's gamma and beta; ffn the
// packed FFN chunks (hidden / 64 of them in bf16, hidden / 16 in f32, see
// above) and g2, b2 (128,), or
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
    const auto kernel =
        ffn != nullptr ? layer_tail_tf32_kernel<true> : layer_tail_tf32_kernel<false>;
    e = allow_smem(kernel, TailF32Smem::kBytes);
    if (e == cudaSuccess)
      kernel<<<cdiv(M, kRowsT), kThreads, TailF32Smem::kBytes, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(av),
          static_cast<const float*>(wm), static_cast<const float*>(g1),
          static_cast<const float*>(b1), static_cast<const float*>(ffn),
          static_cast<const float*>(g2), static_cast<const float*>(b2),
          ffn != nullptr ? hidden / kHT : 0, static_cast<float*>(out), M);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
