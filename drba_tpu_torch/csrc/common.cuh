// Shared helpers for the hand-written kernels: dtype codes, f32 <-> storage
// conversions, and the C-entry dispatch over (value, flow) dtypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace drba {

// dtype codes passed from Python (drba_tpu_torch/_build.py:dtype_code)
enum DType : int { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T's precision and back: models the output rounding
// of one eager tensor op in T (a no-op for f32).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// One NHWC operand read where it lies (drba_tpu_torch/ops/planes.py:Src):
// element (plane p, row y, pixel x, channel ch) at p * sb + y * sy + x * sx +
// ch * sc elements from ptr[1] where pick && pick[p], else from ptr[0]
// (a batch stride of 0 shares one frame among the planes; `pick` chooses
// one of two frames per plane), in dtype code `dtype`; `mult` scales a value
// after its rounding to the output dtype (block_input.cu).
struct Src {
  const void* ptr[2];
  const unsigned char* pick;
  long long sb, sy, sx, sc;
  int c, dtype;
  float mult;
};

// Plane p's base of operand s, as T (the operand's dtype is T's)
template <typename T>
__device__ __forceinline__ const T* src_plane(const Src& s, int p) {
  const int alt = s.pick != nullptr && s.pick[p] != 0;
  return static_cast<const T*>(s.ptr[alt]) + static_cast<long long>(p) * s.sb;
}

// Element `e` of an array of dtype code `dtype` at `base`, as f32
__device__ __forceinline__ float load_f32(int dtype, const void* base, long long e) {
  return dtype == kF32 ? __ldg(static_cast<const float*>(base) + e)
                       : to_f32(static_cast<const bf16*>(base)[e]);
}

inline unsigned int cdiv(long long a, long long b) {
  return static_cast<unsigned int>((a + b - 1) / b);
}

}  // namespace drba

// Expand `BODY` with `T` bound to the storage type of dtype code `code`;
// returns cudaErrorInvalidValue for an unknown code.
#define DRBA_DISPATCH(code, T, ...)                        \
  switch (code) {                                          \
    case drba::kF32: { using T = float; __VA_ARGS__; break; } \
    case drba::kBF16: { using T = drba::bf16; __VA_ARGS__; break; } \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
