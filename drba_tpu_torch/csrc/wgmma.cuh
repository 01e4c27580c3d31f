// Hopper building blocks shared by the tensor-core kernels (attention.cu,
// attn_layer.cu, conv_chain.cu): cp.async copies into shared memory, the
// proxy fence, mbarriers, wgmma synchronisation, shared-memory matrix
// descriptors, and the bf16 wgmma shapes the kernels issue (sm_90a only).
//
// Accumulator layout of a wgmma m64nN tile (f32, N/2 registers a thread):
// warp w of the warpgroup, lane = 4 g4 + t4, holds rows 16 w + g4 and
// 16 w + g4 + 8; element i lies in column 8 (i / 4) + 2 t4 + (i % 2), the
// second row if (i & 2). The same registers, packed two bf16 to a word
// (a[j] = pack_bf16(d[2 j], d[2 j + 1])), are the A fragments of the
// k16 steps over those N columns: step t takes a[4 t .. 4 t + 3].
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace drba {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4, 8 or 16); with !valid the destination is zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(kBytes), "r"(valid ? kBytes : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// mbarriers (shared::cta): init with an arrival count, plain arrive, the
// arrive that also expects `bytes` of bulk (TMA) copies, and the wait for
// the phase of a parity to complete
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// barrier `id` (1..15) over `threads` threads (a multiple of 32)
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// keep the compiler from moving accumulator accesses across wgmma
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo/sbo in bytes.
// K-major operand (rows of 64 bf16 along K, 128 bytes): sbo is the stride
// of 8-row groups, lbo unused. MN-major operand (rows of 64 bf16 along N,
// one row per k): sbo is the stride of 8-k groups, lbo that of the 64-wide
// N slabs.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// the same for the other layouts: kNoSwizzle (K-major: 8-row core
// matrices of 16-byte rows, 128 contiguous bytes each; lbo the stride of
// the two core matrices along K, sbo that of 8-row groups) and kSwizzle32
// (K-major rows of 32 bytes whose 16-byte halves swap at bit 2 of the row
// index, 256-byte aligned atoms of 8 rows; sbo their stride, lbo unused)
enum GmmaLayout : uint64_t { kNoSwizzle = 0, kSwizzle32 = 3 };
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              GmmaLayout layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

#define DRBA_WG_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DRBA_WG_D64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DRBA_WG_OUT8(d, i)                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DRBA_WG_OUT32(d) \
  DRBA_WG_OUT8(d, 0), DRBA_WG_OUT8(d, 8), DRBA_WG_OUT8(d, 16), DRBA_WG_OUT8(d, 24)
#define DRBA_WG_OUT64(d) \
  DRBA_WG_OUT32(d), DRBA_WG_OUT8(d, 32), DRBA_WG_OUT8(d, 40), DRBA_WG_OUT8(d, 48), DRBA_WG_OUT8(d, 56)

// D (64 x 64, f32) (+)= A B for one k16 step, A and B from shared memory;
// kTransB: B is MN-major. acc = 0 overwrites D.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DRBA_WG_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : DRBA_WG_OUT32(d)
      : "l"(da), "l"(db), "r"(acc), "n"(kTransB));
}

// the same with A from registers (one k16 step of A fragments)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DRBA_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : DRBA_WG_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc), "n"(kTransB));
}

// D (64 x 128, f32) (+)= A B, A and B from shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                 int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DRBA_WG_D64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : DRBA_WG_OUT64(d)
      : "l"(da), "l"(db), "r"(acc), "n"(kTransB));
}

// D (64 x 128, f32) (+)= A B, A from registers
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DRBA_WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : DRBA_WG_OUT64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc), "n"(kTransB));
}

}  // namespace drba
