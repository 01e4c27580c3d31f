// Probes of the H100's TF32 tensor-core paths, for the f32 design notes of
// csrc/tf32.cuh (built and run by scripts/torch_tf32_probe.py; not part of
// the package): the throughput of mma.sync m16n8k8 and of wgmma m64n128k8
// (A from registers and from shared memory) in TF32, the wgmma register
// fragment layout of A, and what a tensor core reads of an f32 word that
// is not a TF32 value (truncation or rounding).
#include <cstdint>
#include <cuda_runtime.h>
#include "common.cuh"
#include "wgmma.cuh"
#include "tf32.cuh"

using namespace drba;

// 8 independent accumulator chains a warp, no loads: the mma.sync rate
__global__ void mma_sync_bench(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(d[j], a, a[0] + j, a[1]);
  }
  float s = 0; for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][3];
  if (s == 1.2345f) out[0] = s;
}

__device__ __forceinline__ void wg_tf32_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " DRBA_WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : DRBA_WG_OUT64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
__device__ __forceinline__ void wg_tf32_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " DRBA_WG_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : DRBA_WG_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

// two accumulators a warpgroup, one wgmma group in flight; B (N = 128 x
// K = 8) K-major without swizzle in shared memory: [ng 16][half 2][n 8][k 4]
__global__ void wgmma_bench(float* out, int iters, int ss) {
  __shared__ __align__(1024) float sB[128 * 8 * 2];
  for (int i = threadIdx.x; i < 128 * 8 * 2; i += blockDim.x) sB[i] = 0.001f * (i & 7);
  __syncthreads();
  fence_async_smem();
  const uint64_t db = gmma_desc(smem_u32(sB), 128, 256, kNoSwizzle);
  float d[2][64] = {};
  for (int i = 0; i < iters; ++i) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (ss) wg_tf32_ss_n128(d[j], db, db); else wg_tf32_rs_n128(d[j], 1u, 2u, 3u, threadIdx.x, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait_all();
  float s = 0; for (int j = 0; j < 64; ++j) s += d[0][j] + d[1][j];
  if (s == 1.2345f) out[0] = s;
}

// D (64 x 128) = A (64 x 8, row-major f32 in global) . B (8 x 128, row-major (k, n) f32 in global):
// A from registers in the assumed fragment layout (warp w rows 16w+g, +8; a0 (g,t) a1 (g+8,t) a2 (g,t+4) a3 (g+8,t+4)),
// B staged K-major no-swizzle. raw: B words as given (no cvt) -> truncation probe
__global__ void wgmma_check(const float* A, const float* B, float* D) {
  __shared__ __align__(1024) float sB[128 * 8];
  const int tid = threadIdx.x;
  for (int i = tid; i < 128 * 8; i += 128) {
    const int n = i / 8, k = i % 8;
    sB[(n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + (k % 4)] = B[k * 128 + n];
  }
  __syncthreads();
  fence_async_smem();
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = 16 * w + g;
  uint32_t a0 = __float_as_uint(A[r * 8 + t]), a1 = __float_as_uint(A[(r + 8) * 8 + t]);
  uint32_t a2 = __float_as_uint(A[r * 8 + t + 4]), a3 = __float_as_uint(A[(r + 8) * 8 + t + 4]);
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_regs(d);
  wgmma_fence();
  wg_tf32_rs_n128(d, a0, a1, a2, a3, gmma_desc(smem_u32(sB), 128, 256, kNoSwizzle));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  for (int i = 0; i < 64; ++i) {
    const int row = r + ((i & 2) ? 8 : 0), col = 8 * (i / 4) + 2 * t + (i & 1);
    D[row * 128 + col] = d[i];
  }
}
// the same product on mma.sync (one warp, 16 rows, 16 column tiles), raw words
__global__ void mma_check(const float* A, const float* B, float* D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[4] = {__float_as_uint(A[g * 8 + t]), __float_as_uint(A[(g + 8) * 8 + t]),
                   __float_as_uint(A[g * 8 + t + 4]), __float_as_uint(A[(g + 8) * 8 + t + 4])};
  for (int nt = 0; nt < 16; ++nt) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(d, a, __float_as_uint(B[t * 128 + 8 * nt + g]), __float_as_uint(B[(t + 4) * 128 + 8 * nt + g]));
    D[g * 128 + 8 * nt + 2 * t] = d[0]; D[g * 128 + 8 * nt + 2 * t + 1] = d[1];
    D[(g + 8) * 128 + 8 * nt + 2 * t] = d[2]; D[(g + 8) * 128 + 8 * nt + 2 * t + 1] = d[3];
  }
}
extern "C" int run_bench(float* out, int iters, int which, int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) mma_sync_bench<<<blocks, 256, 0, s>>>(out, iters);
  else wgmma_bench<<<blocks, 256, 0, s>>>(out, iters, which == 2);
  return (int)cudaGetLastError();
}
extern "C" int run_check(const float* A, const float* B, float* D, int which, void* stream) {
  if (which == 0) wgmma_check<<<1, 128, 0, (cudaStream_t)stream>>>(A, B, D);
  else mma_check<<<1, 32, 0, (cudaStream_t)stream>>>(A, B, D);
  return (int)cudaGetLastError();
}
