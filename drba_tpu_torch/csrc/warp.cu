// Bilinear backward warp (NHWC) of one image, or of two images by the two
// halves of one 4-channel flow in one launch, optionally fused with an exact
// 2x2 tap average that realizes the k-fold bilinear downsample of the warp.
//
// Replaces the TPU kernel _sample_chw (drba_tpu/ops/warp_mxu.py:265, body
// _kernel :74) behind backwarp_mxu / sample_positions_mxu /
// warp_downsample2_mxu. The TPU version turns gathers into one-hot matmuls
// over a clamped residual window (gathers are slow there) and approximates
// the fused 2x downsample with rank-1 taps. Hopper gathers natively, so this
// kernel samples exactly what drba_tpu/ops/warp.py:_sample_pixels and
// drba_tpu/models/ifnet.py:_warp_then_downsample compute on the CPU:
//
//   k == 1: out[b,y,x]   = sample(img[b], x + flow[b,y,x,0], y + flow[b,y,x,1])
//   k even: out[b,i,j]   = mean over the 2x2 taps (ty, tx) in
//                          {k*i + k/2 - 1, k*i + k/2} x {k*j + k/2 - 1, k*j + k/2}
//                          of sample(img[b], tx + flow[b,ty,tx,0], ty + flow[b,ty,tx,1])
//
// which is downsample_k(backwarp(img, flow)) for align_corners=False bilinear
// downsampling by an even integer k (drba_tpu/ops/resize.py:_axis_down_int).
// Each sample sums its four corners in f32 in the order (0,0),(0,1),(1,0),(1,1);
// 'border' clamps corner indices, 'zeros' zeroes out-of-frame corner weights.
// A tap is rounded to the image dtype before the average, as the JAX code
// rounds the warped taps before its mean.
//
// Two directions (IFNet's backward warps of both frames): image 0 is warped
// by flow channels [0, 2) and image 1 by [off1, off1 + 2) of one flow map
// with `fstride` channels per pixel, read in place; the output stacks the
// two as (2n, h/k, w/k, c). One direction reads channels [0, 2).
//
// Bound on this card: memory (image reads, output writes; the f32 corner
// arithmetic is far below the FMA rate). A per-pixel thread looping over
// NHWC channels issues strided 2-byte accesses: at c = 19 a warp's 32
// stores touch ~32 sectors for 64 useful bytes. So the work is split in
// two phases per block of output pixels:
//  1. one thread per output pixel (k == 1) or per tap (k even) reads the
//     flow, computes the four corners' element offsets and weights and the
//     pixel's image plane once, and leaves them in shared memory;
//  2. the (pixel, channel group) elements of the block are spread over the
//     threads, channel groups fastest: neighbouring lanes read neighbouring
//     channels of the same corner and write neighbouring output elements,
//     so loads touch one or two sectors per corner run and every store is
//     coalesced. A channel group is V channels moved as one 4-, 8- or
//     16-byte access where C and the pointers' alignment allow (GMFlow's
//     c = 128: 16 bytes); at c = 19, V = 1. Per element the work is two
//     shared loads, four gathers and one store: everything that depends
//     only on the pixel stays in phase 1.
// At k == 1 and c <= 4 (the merge's c = 3) a pixel's outputs are too few
// to spread over lanes, and one thread per pixel writes them all.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Tap {
  int off[4];    // element offset (pixel index * c) of each corner in its image plane
  float wgt[4];  // bilinear weight of each corner (0 outside the frame for 'zeros')
};

__device__ __forceinline__ Tap corners(float px, float py, int h, int w, int c, bool zeros) {
  Tap k;
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  const float wx = px - x0f;
  const float wy = py - y0f;
  // clamp before the int conversion; indices beyond +-1 of the frame behave
  // the same under both padding modes (clamped / zero weight)
  const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), static_cast<float>(w + 1)));
  const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.f), static_cast<float>(h + 1)));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int dy = q >> 1, dx = q & 1;
    const int ix = x0 + dx, iy = y0 + dy;
    float wgt = (dx ? wx : 1.f - wx) * (dy ? wy : 1.f - wy);
    if (zeros && (ix < 0 || ix >= w || iy < 0 || iy >= h)) wgt = 0.f;
    const int cx = min(max(ix, 0), w - 1);
    const int cy = min(max(iy, 0), h - 1);
    k.off[q] = (cy * w + cx) * c;  // h * w * c < 2^31 (checked by the host)
    k.wgt[q] = wgt;
  }
  return k;
}

// V consecutive elements as one access of V * sizeof(T) bytes
template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&f)[V]) {
  using R = typename Raw<V * sizeof(T)>::type;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = drba::to_f32(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&f)[V]) {
  using R = typename Raw<V * sizeof(T)>::type;
  R r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = drba::from_f32<T>(f[i]);
  *reinterpret_cast<R*>(p) = r;
}

// the four corners of one sample, summed in f32 in the order (0,0),(0,1),(1,0),(1,1)
template <typename T, int V>
__device__ __forceinline__ void sample(const T* __restrict__ img, const Tap& k, float (&v)[V]) {
  float e[V];
  load_vec<T, V>(img + k.off[0], e);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = e[i] * k.wgt[0];
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    load_vec<T, V>(img + k.off[q], e);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = v[i] + e[i] * k.wgt[q];
  }
}

struct WarpArgs {
  const void* img[2];  // image of each direction, (n, h, w, c)
  const void* flow;    // (n, h, w, fstride)
  void* out;           // (planes, h / k, w / k, c), planes = n * directions
  int n, h, w, c, k, ho, wo, planes, fstride, foff1, zeros;
};

// Sample i of the block starting at output pixel p0: output pixel p0 + p
// (p = i, or i / 4 for the taps); returns its corners and sets `plane`.
template <typename F, bool kTaps>
__device__ __forceinline__ Tap sample_corners(const WarpArgs& a, long long p0, int i,
                                              int& plane) {
  const long long hw_out = static_cast<long long>(a.ho) * a.wo;
  const long long gp = p0 + (kTaps ? i >> 2 : i);
  plane = static_cast<int>(gp / hw_out);
  const int r = static_cast<int>(gp - plane * hw_out);
  const int oy = r / a.wo, ox = r - oy * a.wo;
  const int d = plane >= a.n;
  int ty = oy, tx = ox;
  if (kTaps) {
    const int t = i & 3;
    ty = a.k * oy + a.k / 2 - 1 + (t >> 1);
    tx = a.k * ox + a.k / 2 - 1 + (t & 1);
  }
  const F* f = static_cast<const F*>(a.flow) +
               ((static_cast<long long>(plane - d * a.n) * a.h + ty) * a.w + tx) * a.fstride +
               (d ? a.foff1 : 0);
  return corners(static_cast<float>(tx) + drba::to_f32(f[0]),
                 static_cast<float>(ty) + drba::to_f32(f[1]), a.h, a.w, a.c, a.zeros != 0);
}

template <typename T>
__device__ __forceinline__ const T* plane_ptr(const WarpArgs& a, int plane) {
  const int d = plane >= a.n;
  return static_cast<const T*>(d ? a.img[1] : a.img[0]) +
         static_cast<long long>(plane - d * a.n) * a.h * a.w * a.c;
}

// The channel-parallel form: kPix output pixels per block; kTaps: the
// k-even tap form (4 taps a pixel)
template <typename T, typename F, int V, bool kTaps>
__global__ void __launch_bounds__(kThreads) warp_kernel(const WarpArgs a) {
  constexpr int kPix = kTaps ? kThreads / 2 : kThreads;
  __shared__ Tap s_tap[kTaps ? 4 * kPix : kPix];
  __shared__ const T* s_img[kPix];  // each pixel's image plane

  const long long p0 = static_cast<long long>(blockIdx.x) * kPix;
  const int npix = static_cast<int>(
      min(static_cast<long long>(kPix), static_cast<long long>(a.planes) * a.ho * a.wo - p0));

  // phase 1: corner offsets and weights of every sample of the block
  for (int i = threadIdx.x; i < (kTaps ? 4 * npix : npix); i += kThreads) {
    int plane;
    s_tap[i] = sample_corners<F, kTaps>(a, p0, i, plane);
    if (!kTaps || (i & 3) == 0) s_img[kTaps ? i >> 2 : i] = plane_ptr<T>(a, plane);
  }
  __syncthreads();

  // phase 2: (pixel, channel group) elements e = p * cv + g, channel groups
  // fastest; element e is V outputs at out + e * V. U elements a thread at
  // once (taps: 2), so their corner loads are in flight together; elements
  // past the block's end repeat its last pixel and are not stored
  constexpr int U = kTaps ? 2 : 1;
  const int cv = a.c / V;
  const int total = npix * cv;
  const int dp = kThreads / cv, dc = kThreads % cv;
  int p = threadIdx.x / cv, g = threadIdx.x % cv;
  T* out = static_cast<T*>(a.out) + p0 * a.c;
  for (int e = threadIdx.x; e < total; e += U * kThreads) {
    int pu[U], gu[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pu[u] = min(p, npix - 1);
      gu[u] = g;
      p += dp;
      g += dc;
      if (g >= cv) {
        g -= cv;
        ++p;
      }
    }
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* img = s_img[pu[u]] + gu[u] * V;
      if (!kTaps) {
        sample<T, V>(img, s_tap[pu[u]], v[u]);
      } else {
        float s[V];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sample<T, V>(img, s_tap[4 * pu[u] + t], s);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float r = drba::round_to<T>(s[i]);
            v[u][i] = t == 0 ? r : v[u][i] + r;
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) v[u][i] = v[u][i] * 0.25f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e + u * kThreads < total) store_vec<T, V>(out + (e + u * kThreads) * V, v[u]);
  }
}

// k == 1 at narrow C (the merge's c = 3): one thread per output pixel and
// all its channels; its c * sizeof(T) bytes are too few to spread over lanes
template <typename T, typename F>
__global__ void __launch_bounds__(kThreads) warp_narrow_kernel(const WarpArgs a) {
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads;
  if (p0 + threadIdx.x >= static_cast<long long>(a.planes) * a.h * a.w) return;
  int plane;
  const Tap k = sample_corners<F, false>(a, p0, threadIdx.x, plane);
  const T* img = plane_ptr<T>(a, plane);
  T* dst = static_cast<T*>(a.out) + (p0 + threadIdx.x) * a.c;
  for (int ch = 0; ch < a.c; ++ch) {
    float v[1];
    sample<T, 1>(img + ch, k, v);
    dst[ch] = drba::from_f32<T>(v[0]);
  }
}

constexpr int kNarrowC = 4;  // widest C of the per-pixel form

template <typename T, typename F, int V>
int launch(const WarpArgs& a, cudaStream_t s) {
  const long long pix = static_cast<long long>(a.planes) * a.ho * a.wo;
  if (a.k == 1 && a.c <= kNarrowC) {
    warp_narrow_kernel<T, F><<<drba::cdiv(pix, kThreads), kThreads, 0, s>>>(a);
  } else if (a.k == 1) {
    warp_kernel<T, F, V, false><<<drba::cdiv(pix, kThreads), kThreads, 0, s>>>(a);
  } else {
    warp_kernel<T, F, V, true><<<drba::cdiv(pix, kThreads / 2), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the widest channel group: V channels of T in one 16-, 8-, 4- or 2-byte access
template <typename T, typename F>
int dispatch_vec(const WarpArgs& a, cudaStream_t s) {
  constexpr int kMax = 16 / sizeof(T);
  for (int v = kMax; v > 1; v /= 2) {
    const int bytes = v * static_cast<int>(sizeof(T));
    if (a.c % v == 0 && aligned(a.img[0], bytes) && aligned(a.img[1], bytes) &&
        aligned(a.out, bytes)) {
      if (v == 8) return launch<T, F, (kMax >= 8 ? 8 : 1)>(a, s);
      if (v == 4) return launch<T, F, 4>(a, s);
      return launch<T, F, 2>(a, s);
    }
  }
  return launch<T, F, 1>(a, s);
}

}  // namespace

// img0 (n,h,w,c) f32|bf16, img1 the same or NULL, flow (n,h,w,fstride)
// f32|bf16 (direction 0 reads its channels [0,2), direction 1 [foff1,
// foff1+2)), out (n or 2n, h/k, w/k, c) in the images' dtype; k is 1 or
// even with h % k == 0 and w % k == 0 (checked by the caller). Returns
// cudaGetLastError() after the launch.
extern "C" int drba_warp(const void* img0, const void* img1, const void* flow, void* out, int n,
                         int h, int w, int c, int k, int zeros, int fstride, int foff1,
                         int img_dtype, int flow_dtype, void* stream) {
  WarpArgs a{{img0, img1}, flow, out, n, h, w, c, k, h / k, w / k, img1 ? 2 * n : n,
             fstride, foff1, zeros};
  if (static_cast<long long>(a.planes) * a.ho * a.wo * c == 0) return 0;
  // corner offsets are 32-bit element offsets within an image plane
  if (static_cast<long long>(h) * w * c >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DRBA_DISPATCH(img_dtype, T, DRBA_DISPATCH(flow_dtype, F, return dispatch_vec<T, F>(a, s)));
  return 0;
}
