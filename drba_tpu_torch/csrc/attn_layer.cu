// The token-wise parts of one GMFlow TransformerLayer, head width 128.
//
// Replaces, with the window-attention kernel of attention.cu between them,
// the TPU kernel transformer_layer_mxu (drba_tpu/ops/attn_layer.py:176, body
// _kernel :125), which computes a whole layer per window in VMEM. A window
// does not fit a block here (at L = 510, c = 128, q, k and v are 130 KB each
// in bf16 and a block has 227 KB), so the layer runs as three launches:
//
//  1. drba_layer_proj: q = x Wq, k = t Wk, v = t Wv for 64-token tiles
//     (t = the cross-attention target, or x), written as one (M, 384) q|k|v
//     map that the attention kernel reads by stride;
//  2. the window attention of attention.cu;
//  3. drba_layer_tail: merge -> LayerNorm -> [concat-FFN 256 -> 1024 in
//     128-wide hidden chunks -> exact GELU -> 1024 -> 128 -> LayerNorm] ->
//     residual, for 64-token tiles. Tokens are independent here, so a tile's
//     64 x 128 f32 intermediates stay in shared memory.
//
// Rounding follows the TPU kernel: q/k/v and the attention output in the
// compute dtype T, the merge and both LayerNorms in f32, the FFN hidden
// rounded to T before GELU, the FFN sum in f32, the residual sum in f32 and
// rounded once. GELU is 0.5 x erfc(-x sqrt(1/2)) with CUDA's erfcf and
// jax.nn.gelu's rounding points in T (argument, erfc, 0.5 x, product).
//
// Products: bf16 on tensor cores through WMMA (16x16x16, f32 accumulation),
// A operands from shared memory and B fragments (the weights, at most
// 512 KB, resident in L2) read straight from global memory; f32 on the FMA
// pipes. Eight warps per block, each a 16 x 64 quarter-column of the tile.
//
// Bound on this card: the weights are re-read from L2 by every block
// (about 3 MB per 64-token tile for a cross layer with its FFN), and the
// shared-memory round trips between the stages; staging weight slices in
// shared memory for several warps, larger token tiles and wgmma are later
// steps.

#include <mma.h>

#include "common.cuh"

namespace {

using drba::bf16;

constexpr int kC = 128;        // channels
constexpr int kRows = 64;      // tokens per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdh = kC + 8;   // bf16 row stride in shared memory
constexpr int kLdf = kC + 4;   // f32 row stride in shared memory
constexpr float kEps = 1e-5f;

template <typename T> struct Ld;
template <> struct Ld<bf16> { static constexpr int v = kLdh; };
template <> struct Ld<float> { static constexpr int v = kLdf; };

// rows [r0, r0 + 64) of a contiguous (M, 128) array into shared memory;
// rows past M are zero
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long r0, long long M) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kC / kVec;
  for (int e = threadIdx.x; e < kRows * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < M) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * kC + c);
    *reinterpret_cast<uint4*>(dst + r * Ld<T>::v + c) = val;
  }
}

// C (64 x 128 f32 in shared memory, stride kLdf) = [C +] A . B, with A the
// 64 x K tile [A0 | A1] (each 64 x 128 in shared memory, stride Ld<T>; A1
// only when K == 256) and B (K x 128) in global memory with row stride ldb.
// bf16: WMMA; warp w computes rows 16 (w % 4) .. +16, columns 64 (w / 4) .. +64.
__device__ __forceinline__ void tile_gemm(const bf16* A0, const bf16* A1, const bf16* B,
                                          int ldb, int K, float* C, bool accumulate) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int rb = warp & 3, ch = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[4];
  float* cptr = C + rb * 16 * kLdf + ch * 64;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (accumulate)
      wmma::load_matrix_sync(f[j], cptr + j * 16, kLdf, wmma::mem_row_major);
    else
      wmma::fill_fragment(f[j], 0.f);
  }
  for (int k = 0; k < K; k += 16) {
    const bf16* A = k < kC ? A0 + k : A1 + (k - kC);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + rb * 16 * kLdh, kLdh);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + static_cast<long long>(k) * ldb + ch * 64 + j * 16, ldb);
      wmma::mma_sync(f[j], a, b, f[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(cptr + j * 16, f[j], kLdf, wmma::mem_row_major);
}

// f32: FMA; thread t computes rows 4 (t / 16) .. +4 and columns
// 4 (t % 16) .. +4 and 64 + 4 (t % 16) .. +4
__device__ __forceinline__ void tile_gemm(const float* A0, const float* A1, const float* B,
                                          int ldb, int K, float* C, bool accumulate) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[r][j] = accumulate ? C[(4 * rg + r) * kLdf + (j < 4 ? 4 * cg + j : 60 + 4 * cg + j)]
                             : 0.f;
  for (int k = 0; k < K; ++k) {
    const float* A = k < kC ? A0 + k : A1 + (k - kC);
    const float* Bk = B + static_cast<long long>(k) * ldb;
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(Bk + 4 * cg));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(Bk + 64 + 4 * cg));
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
      C[(4 * rg + r) * kLdf + (j < 4 ? 4 * cg + j : 60 + 4 * cg + j)] = acc[r][j];
}

// LayerNorm of each row of C (64 x 128 f32) in place, in f32, with the
// statistics of drba_tpu/models/layers.py:layer_norm; warp w takes rows
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

template <typename T>
__device__ __forceinline__ float gelu_exact(float h) {
  const float sqrt_half = drba::round_to<T>(0.70710678118654752f);
  const float e = drba::round_to<T>(erfcf(drba::round_to<T>(-h * sqrt_half)));
  return drba::round_to<T>(drba::round_to<T>(0.5f * h) * e);
}

// the 64 x 128 f32 tile C rounded to T, into shared memory
template <typename T>
__device__ __forceinline__ void round_tile(T* dst, const float* C) {
  for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
    const int r = e / kC, c = e % kC;
    dst[r * Ld<T>::v + c] = drba::from_f32<T>(C[r * kLdf + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_proj_kernel(const T* __restrict__ x, const T* __restrict__ tgt, const T* __restrict__ w,
                  T* __restrict__ qkv, long long M) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  float* sC = reinterpret_cast<float*>(smem + kRows * Ld<T>::v * sizeof(T));
  const int seg = blockIdx.y;  // 0: q from x; 1, 2: k, v from the target
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  load_tile<T>(sX, seg == 0 ? x : tgt, r0, M);
  __syncthreads();
  tile_gemm(sX, sX, w + seg * kC, 3 * kC, kC, sC, false);
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
    const int r = e / kC, c = e % kC;
    if (r0 + r < M) qkv[(r0 + r) * 3 * kC + seg * kC + c] = drba::from_f32<T>(sC[r * kLdf + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_tail_kernel(const T* __restrict__ x, const T* __restrict__ av, const T* __restrict__ wm,
                  const float* __restrict__ g1, const float* __restrict__ b1,
                  const T* __restrict__ w0, const T* __restrict__ w2,
                  const float* __restrict__ g2, const float* __restrict__ b2, int hidden,
                  T* __restrict__ out, long long M) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kT = kRows * Ld<T>::v * sizeof(T);
  T* sX = reinterpret_cast<T*>(smem);           // the layer's input
  T* sA = reinterpret_cast<T*>(smem + kT);      // attention output, then the message in T
  T* sH = reinterpret_cast<T*>(smem + 2 * kT);  // GELU of one hidden chunk
  float* sC = reinterpret_cast<float*>(smem + 3 * kT);  // message, then a hidden chunk
  float* sAcc = sC + kRows * kLdf;                       // FFN output
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;

  load_tile<T>(sX, x, r0, M);
  load_tile<T>(sA, av, r0, M);
  __syncthreads();
  tile_gemm(sA, sA, wm, kC, kC, sC, false);  // merge
  __syncthreads();
  layer_norm_rows(sC, g1, b1);
  __syncthreads();
  float* res = sC;  // what the residual adds: the message, or the FFN's output
  if (w0 != nullptr) {
    round_tile<T>(sA, sC);  // the message in T feeds the FFN
    __syncthreads();
    for (int h0 = 0; h0 < hidden; h0 += kC) {
      // hidden chunk = [x | message] . W0[:, h0 : h0 + 128]
      tile_gemm(sX, sA, w0 + h0, hidden, 2 * kC, sC, false);
      __syncthreads();
      for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
        const int r = e / kC, c = e % kC;
        sH[r * Ld<T>::v + c] = drba::from_f32<T>(gelu_exact<T>(drba::round_to<T>(sC[r * kLdf + c])));
      }
      __syncthreads();
      tile_gemm(sH, sH, w2 + static_cast<long long>(h0) * kC, kC, kC, sAcc, h0 > 0);
      __syncthreads();
    }
    layer_norm_rows(sAcc, g2, b2);
    __syncthreads();
    res = sAcc;
  }
  for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
    const int r = e / kC, c = e % kC;
    if (r0 + r < M)
      out[(r0 + r) * kC + c] =
          drba::from_f32<T>(drba::to_f32(sX[r * Ld<T>::v + c]) + res[r * kLdf + c]);
  }
}

template <typename T>
constexpr int proj_bytes() {
  return kRows * Ld<T>::v * sizeof(T) + kRows * kLdf * 4;
}

template <typename T>
constexpr int tail_bytes() {
  return 3 * kRows * Ld<T>::v * sizeof(T) + 2 * kRows * kLdf * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// x, tgt (M, 128), w (128, 384) = [Wq | Wk | Wv] stored (in, out), qkv
// (M, 384) = [x Wq | tgt Wk | tgt Wv]; all contiguous, one dtype (f32|bf16),
// 32-byte aligned (checked by the caller). Returns cudaGetLastError().
extern "C" int drba_layer_proj(const void* x, const void* tgt, const void* w, void* qkv,
                               long long M, int dtype, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(drba::cdiv(M, kRows), 3);
  cudaError_t e = cudaErrorInvalidValue;
  DRBA_DISPATCH(dtype, T, {
    e = allow_smem(layer_proj_kernel<T>, proj_bytes<T>());
    if (e == cudaSuccess)
      layer_proj_kernel<T><<<grid, kThreads, proj_bytes<T>(), s>>>(
          static_cast<const T*>(x), static_cast<const T*>(tgt), static_cast<const T*>(w),
          static_cast<T*>(qkv), M);
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// x, av (M, 128): the layer input and the attention output; wm (128, 128);
// g1, b1 (128,) f32; w0 (256, hidden) and w2 (hidden, 128), or both NULL for
// a layer without FFN; g2, b2 (128,) f32 or NULL; out (M, 128). Weights in
// x's dtype (f32|bf16), stored (in, out); all contiguous and 32-byte
// aligned (checked by the caller); hidden a multiple of 128. Returns
// cudaGetLastError().
extern "C" int drba_layer_tail(const void* x, const void* av, const void* wm, const float* g1,
                               const float* b1, const void* w0, const void* w2,
                               const float* g2, const float* b2, void* out, int hidden,
                               long long M, int dtype, void* stream) {
  if (M == 0) return 0;
  if (w0 != nullptr && (hidden <= 0 || hidden % kC != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(drba::cdiv(M, kRows));
  cudaError_t e = cudaErrorInvalidValue;
  DRBA_DISPATCH(dtype, T, {
    e = allow_smem(layer_tail_kernel<T>, tail_bytes<T>());
    if (e == cudaSuccess)
      layer_tail_kernel<T><<<grid, kThreads, tail_bytes<T>(), s>>>(
          static_cast<const T*>(x), static_cast<const T*>(av), static_cast<const T*>(wm), g1,
          b1, static_cast<const T*>(w0), static_cast<const T*>(w2), g2, b2, hidden,
          static_cast<T*>(out), M);
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
