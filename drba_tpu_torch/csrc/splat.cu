// Bilinear forward splat (summation splatting) as an exact atomic scatter,
// with softsplat's mode fused in.
//
// Replaces the TPU kernel splat_planes_stencil_batched
// (drba_tpu/ops/splat_stencil.py:282, body _kernel :106), reached through
// drba_tpu/ops/softsplat.py:softsplat(backend="stencil"). The TPU version
// enumerates integer displacements inside a radius because TPU scatters
// serialize; on Hopper the scatter is native, so this kernel follows the
// exact scatter semantics of softsplat.py:_splat_scatter / _corner_contributions
// (the reference CUDA softsplat_out): no radius, nothing dropped but
// non-finite targets and out-of-frame corners.
//
// Two launches make one softsplat:
//  1. drba_splat_scatter: zeroes an f32 accumulator of `stride` channels a
//     pixel (c + 1 rounded up to 4: the c values times the factor, the
//     factor itself in channel c, zeros after) and adds every source pixel's
//     planes into its four corners with bilinear weights. The factor is 1
//     (sum, avg), the metric (linear) or exp(metric) (soft), formed in f32
//     from the inputs in their own dtypes: each added term is (x m) w as
//     softsplat's planes [x m, m] give it, so sums differ from the plain
//     version only in the order of the atomic additions.
//  2. drba_splat_normalise: reads the accumulator once and writes the result
//     in the output dtype (divided by the weight channel under the addeps,
//     zeroeps or clipeps rule, or as it is for sum) and the coverage.
//
// Bound on this card: memory traffic and the L2's atomic throughput. At
// GMFSS's soft splats (C = 67, 128, 192 at B = 6) the accumulator is 150-850
// MB: zeroed, updated four times a pixel through the L2, read once. The
// former kernel looped one thread over a pixel's channels with scalar
// atomics: a warp's 32 atomics at one channel touched 32 lines C x 4 bytes
// apart, and one thread issued 4 C of them in sequence. Here one thread per
// source pixel computes its corners' pixels and weights and its factor into
// shared memory (phase 1); then the (pixel, 4-channel group) elements are
// spread over the lanes, channels fastest (phase 2): each lane loads its 4
// values and issues one 16-byte f32 atomic per corner (atomicAdd on a
// float4, sm_90), so a warp's atomics for one corner cover contiguous
// lines of the target pixel. The stride keeps every pixel's row 16-byte aligned. The
// grid is one block per SM, each walking tiles of 256 source pixels: the
// pixels in flight then target a band of the accumulator that stays in L2
// (~9 MB at C = 67) while its four updates a pixel arrive; a full grid
// (~270 K pixels in flight, ~73 MB of rows at C = 67) measured 19-21%
// slower at the two larger levels. At c + 1 <= 4 (RIFE's flow inversion,
// the DRM splats) a thread keeps its one pixel: corners in registers, one
// atomic per corner.

#include "common.cuh"

namespace {

using namespace drba;

constexpr int kThreads = 256;  // threads a block; source pixels a block (phase 1)
constexpr float kEps = 1e-7f;  // softsplat's denominator epsilon

// The four bilinear corners of source pixel i (of n h w): the target pixel
// (batch included) and weight, or pixel -1 where the corner is dropped.
template <typename F>
__device__ __forceinline__ void corners_of(const F* __restrict__ flow, long long i, int h, int w,
                                           int (&tp)[4], float (&tw)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    tp[q] = -1;
    tw[q] = 0.f;
  }
  const int x = static_cast<int>(i % w);
  const long long r = i / w;
  const int y = static_cast<int>(r % h);
  const int b = static_cast<int>(r / h);
  const float fx = static_cast<float>(x) + to_f32(flow[2 * i]);
  const float fy = static_cast<float>(y) + to_f32(flow[2 * i + 1]);
  if (!isfinite(fx) || !isfinite(fy)) return;  // tested before floor
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  // all four corners out of frame: nothing to add (also keeps the int
  // conversion below in range)
  if (x0f < -1.f || x0f > static_cast<float>(w - 1) || y0f < -1.f ||
      y0f > static_cast<float>(h - 1))
    return;
  const float wx = fx - x0f;
  const float wy = fy - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int dy = q >> 1, dx = q & 1;
    const int ix = x0 + dx, iy = y0 + dy;
    if (ix < 0 || ix >= w || iy < 0 || iy >= h) continue;  // per-corner drop
    tp[q] = (b * h + iy) * w + ix;
    tw[q] = (dx ? wx : 1.f - wx) * (dy ? wy : 1.f - wy);
  }
}

// the factor of source pixel i: 1 (mode 0), m (1) or exp(m) (2)
template <typename M>
__device__ __forceinline__ float factor_of(const M* __restrict__ metric, long long i, int mode) {
  if (mode == 0) return 1.f;
  const float m = to_f32(metric[i]);
  return mode == 1 ? m : expf(m);
}

// channels 4 g .. 4 g + 3 of pixel i's planes [x f, f, 0...]
template <typename T, bool kVec>
__device__ __forceinline__ float4 planes_of(const T* __restrict__ ten, long long i, int c, int g,
                                            float f) {
  float v[4];
  const T* src = ten + i * c + 4 * g;
  if (kVec) {  // c % 4 == 0: four values, then the factor's group
    if (4 * g < c) {
      if constexpr (sizeof(T) == 4) {
        const float4 q = *reinterpret_cast<const float4*>(src);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
        const uint2 q = *reinterpret_cast<const uint2*>(src);
        const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = to_f32(e[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] *= f;
      return make_float4(v[0], v[1], v[2], v[3]);
    }
    return make_float4(f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = 4 * g + j;
    v[j] = ch < c ? to_f32(src[j]) * f : (ch == c ? f : 0.f);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void add_corner(float* acc, int tp, int stride, int g, float4 v,
                                           float wgt) {
  if (tp < 0) return;
  // one 16-byte f32 atomic; its result is unused (a reduction)
  atomicAdd(reinterpret_cast<float4*>(acc + static_cast<long long>(tp) * stride + 4 * g),
            make_float4(v.x * wgt, v.y * wgt, v.z * wgt, v.w * wgt));
}

// c + 1 <= 4: one thread per source pixel, one group
template <typename T, typename F, typename M>
__global__ void __launch_bounds__(kThreads)
splat_scatter_narrow_kernel(const T* __restrict__ ten, const F* __restrict__ flow,
                            const M* __restrict__ metric, float* __restrict__ acc, int n, int h,
                            int w, int c, int mode) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= static_cast<long long>(n) * h * w) return;
  int tp[4];
  float tw[4];
  corners_of(flow, i, h, w, tp, tw);
  if ((tp[0] & tp[1] & tp[2] & tp[3]) < 0) return;  // every corner dropped
  const float4 v = planes_of<T, false>(ten, i, c, 0, factor_of(metric, i, mode));
#pragma unroll
  for (int q = 0; q < 4; ++q) add_corner(acc, tp[q], 4, 0, v, tw[q]);
}

template <typename T, typename F, typename M, bool kVec>
__global__ void __launch_bounds__(kThreads)
splat_scatter_kernel(const T* __restrict__ ten, const F* __restrict__ flow,
                     const M* __restrict__ metric, float* __restrict__ acc, int n, int h, int w,
                     int c, int stride, int mode) {
  __shared__ int s_tp[4][kThreads];
  __shared__ float s_tw[4][kThreads];
  __shared__ float s_f[kThreads];
  const long long total = static_cast<long long>(n) * h * w;
  const int groups = stride >> 2;
  const int dp = kThreads / groups, dg = kThreads % groups;

  // a block walks tiles of kThreads source pixels
  for (long long p0 = blockIdx.x * static_cast<long long>(kThreads); p0 < total;
       p0 += static_cast<long long>(gridDim.x) * kThreads) {
    // phase 1: one thread per source pixel
    {
      const long long i = p0 + threadIdx.x;
      int tp[4] = {-1, -1, -1, -1};
      float tw[4] = {0.f, 0.f, 0.f, 0.f};
      float f = 0.f;
      if (i < total) {
        corners_of(flow, i, h, w, tp, tw);
        f = factor_of(metric, i, mode);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_tp[q][threadIdx.x] = tp[q];
        s_tw[q][threadIdx.x] = tw[q];
      }
      s_f[threadIdx.x] = f;
    }
    __syncthreads();

    // phase 2: (pixel, 4-channel group) elements, channels fastest; element
    // e = p groups + g steps by kThreads (p by dp, g by dg, with carry)
    const int np = static_cast<int>(total - p0 < kThreads ? total - p0 : kThreads);
    int p = threadIdx.x / groups, g = threadIdx.x % groups;
    while (p < np) {
      const int t0 = s_tp[0][p], t1 = s_tp[1][p], t2 = s_tp[2][p], t3 = s_tp[3][p];
      if ((t0 & t1 & t2 & t3) >= 0) {  // a corner is kept (dropped ones are -1)
        const float4 v = planes_of<T, kVec>(ten, p0 + p, c, g, s_f[p]);
        add_corner(acc, t0, stride, g, v, s_tw[0][p]);
        add_corner(acc, t1, stride, g, v, s_tw[1][p]);
        add_corner(acc, t2, stride, g, v, s_tw[2][p]);
        add_corner(acc, t3, stride, g, v, s_tw[3][p]);
      }
      p += dp;
      g += dg;
      if (g >= groups) {
        g -= groups;
        ++p;
      }
    }
    __syncthreads();  // the tile's corners are read
  }
}

// one thread per (pixel, group of 4 result channels)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
splat_normalise_kernel(const float* __restrict__ acc, T* __restrict__ out, T* __restrict__ cov,
                       long long pixels, int c, int stride, int denom) {
  const int groups = (c + 3) / 4;
  const long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (e >= pixels * groups) return;
  const long long p = e / groups;
  const int g = static_cast<int>(e - p * groups);
  const float* a = acc + p * stride;
  const float4 s = *reinterpret_cast<const float4*>(a + 4 * g);
  float v[4] = {s.x, s.y, s.z, s.w};
  float raw = 0.f, norm = 1.f;
  if (denom != 0) {  // 1 addeps, 2 zeroeps, 3 clipeps
    raw = a[c];
    norm = denom == 1 ? raw + kEps : (denom == 2 ? (raw == 0.f ? 1.f : raw) : fmaxf(raw, kEps));
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = v[j] / norm;
  }
  T* dst = out + p * c + 4 * g;
  if (kVec) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 q;
      bf16* o = reinterpret_cast<bf16*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = from_f32<T>(v[j]);
      *reinterpret_cast<uint2*>(dst) = q;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * g + j < c) dst[j] = from_f32<T>(v[j]);
  }
  if (cov != nullptr && g == 0) cov[p] = from_f32<T>(raw / norm);
}

}  // namespace

// ten (n,h,w,c), flow (n,h,w,2), metric (n,h,w,1) or NULL (mode 0), each
// f32|bf16 in its own dtype code; acc (n,h,w,stride) f32, stride = c + 1
// rounded up to a multiple of 4, 16-byte aligned; mode 0: factor 1,
// 1: metric, 2: exp(metric). Zeroes acc, then scatters. n h w < 2^31.
// Returns cudaGetLastError() after the launch.
extern "C" int drba_splat_scatter(const void* ten, const void* flow, const void* metric,
                                  void* acc, int n, int h, int w, int c, int mode, int ten_dtype,
                                  int flow_dtype, int metric_dtype, void* stream) {
  const long long total = static_cast<long long>(n) * h * w;
  const int stride = (c + 4) / 4 * 4;
  if (total == 0) return 0;
  if (c < 1 || mode < 0 || mode > 2 || (mode != 0 && metric == nullptr) || total >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(acc, 0, total * stride * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned int blocks = cdiv(total, kThreads);
  // the wide kernel: one block per SM, walking the pixels in raster order
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned int wide_blocks = blocks < static_cast<unsigned int>(sms) ? blocks : sms;
  float* a = static_cast<float*>(acc);
  DRBA_DISPATCH(ten_dtype, T, DRBA_DISPATCH(flow_dtype, F, DRBA_DISPATCH(metric_dtype, M, {
    const T* tp = static_cast<const T*>(ten);
    const F* fp = static_cast<const F*>(flow);
    const M* mp = static_cast<const M*>(metric);
    if (stride == 4)
      splat_scatter_narrow_kernel<T, F, M><<<blocks, kThreads, 0, s>>>(tp, fp, mp, a, n, h, w, c,
                                                                        mode);
    else if (c % 4 == 0)
      splat_scatter_kernel<T, F, M, true><<<wide_blocks, kThreads, 0, s>>>(tp, fp, mp, a, n, h,
                                                                           w, c, stride, mode);
    else
      splat_scatter_kernel<T, F, M, false><<<wide_blocks, kThreads, 0, s>>>(tp, fp, mp, a, n, h,
                                                                            w, c, stride, mode);
  })));
  return static_cast<int>(cudaGetLastError());
}

// acc (pixels, stride) f32 from drba_splat_scatter; out (pixels, c) and cov
// (pixels,) or NULL in out_dtype (f32|bf16); denom 0: the sums as they are
// (softsplat's sum mode; cov must be NULL), 1 addeps, 2 zeroeps, 3 clipeps.
// out 8-byte aligned. Returns cudaGetLastError().
extern "C" int drba_splat_normalise(const void* acc, void* out, void* cov, long long pixels,
                                    int c, int denom, int out_dtype, void* stream) {
  if (pixels == 0) return 0;
  if (c < 1 || denom < 0 || denom > 3 || (denom == 0 && cov != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int stride = (c + 4) / 4 * 4;
  const unsigned int blocks = cdiv(pixels * ((c + 3) / 4), kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  DRBA_DISPATCH(out_dtype, T, {
    if (c % 4 == 0)
      splat_normalise_kernel<T, true><<<blocks, kThreads, 0, s>>>(
          a, static_cast<T*>(out), static_cast<T*>(cov), pixels, c, stride, denom);
    else
      splat_normalise_kernel<T, false><<<blocks, kThreads, 0, s>>>(
          a, static_cast<T*>(out), static_cast<T*>(cov), pixels, c, stride, denom);
  });
  return static_cast<int>(cudaGetLastError());
}
