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
// with `fstride` channels per pixel, read in place. One direction reads
// channels [0, 2). Each direction's image is read where it lies, as one or
// two operands (common.cuh:Src) side by side in its channels: IFNet's frame
// (3 of its channels) and its 16 encoder features, with no concatenation;
// an operand may share one frame among the planes (batch stride 0) or
// choose one of two frames per plane. Output pixel q of direction d in plane
// p goes to out + p * ob + q * opitch + off[d]: the two directions stacked
// as (2n, h/k, w/k, c), or each written into its channel slots of an
// IFBlock's input (pitch 56, offsets 0 and 19; block_input.cu writes the
// rest).
//
// Bound on this card: memory (image reads, output writes; the f32 corner
// arithmetic is far below the FMA rate). A per-pixel thread looping over
// NHWC channels issues strided 2-byte accesses: at c = 19 a warp's 32
// stores touch ~32 sectors for 64 useful bytes. So the work is split in
// two phases per block of output pixels:
//  1. one thread per output pixel (k == 1) or per tap (k even) reads the
//     flow, computes the four corners' pixel indices and weights, the
//     pixel's image planes and its output address once, and leaves them in
//     shared memory;
//  2. the (pixel, channel group) elements of the block are spread over the
//     threads, channel groups fastest: neighbouring lanes read neighbouring
//     channels of the same corner and write neighbouring output elements,
//     so loads touch one or two sectors per corner run and every store is
//     coalesced. A channel group is V channels moved as one 4-, 8- or
//     16-byte access where C and the pointers' alignment allow (GMFlow's
//     c = 128: 16 bytes); at c = 19, V = 1. Per element the work is two
//     shared loads, four gathers and one store: everything that depends
//     only on the pixel stays in phase 1.
// At k == 1 and c <= 4 (the merge's c = 3, one operand) a pixel's outputs
// are too few to spread over lanes, and one thread per pixel writes them all.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Tap {
  int off[4];    // pixel index (cy * w + cx) of each corner in its image plane
  float wgt[4];  // bilinear weight of each corner (0 outside the frame for 'zeros')
};

__device__ __forceinline__ Tap corners(float px, float py, int h, int w, bool zeros) {
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
    k.off[q] = cy * w + cx;
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

// the four corners of one sample (pixels `sx` elements apart), summed in f32
// in the order (0,0),(0,1),(1,0),(1,1)
template <typename T, int V>
__device__ __forceinline__ void sample(const T* __restrict__ img, int sx, const Tap& k,
                                       float (&v)[V]) {
  float e[V];
  load_vec<T, V>(img + static_cast<long long>(k.off[0]) * sx, e);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = e[i] * k.wgt[0];
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    load_vec<T, V>(img + static_cast<long long>(k.off[q]) * sx, e);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = v[i] + e[i] * k.wgt[q];
  }
}

struct WarpArgs {
  drba::Src img[2][2];  // direction d's operands: channels [0, c0) from img[d][0], [c0, c) from
                        // img[d][1]; per operand the same c and sx in both directions
  const void* flow;     // (n, h, w, fstride)
  void* out;            // see the header: out + p * ob + q * opitch + off[d]
  long long ob, off[2];
  int n, h, w, c, c0, k, ho, wo, planes, fstride, foff1, zeros, opitch;
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
                 static_cast<float>(ty) + drba::to_f32(f[1]), a.h, a.w, a.zeros != 0);
}

// Where `plane` (of planes = n * directions) reads operand s of its
// direction, and where its output pixel r (in the plane) goes
template <typename T>
__device__ __forceinline__ const T* plane_ptr(const WarpArgs& a, int plane, int s) {
  const int d = plane >= a.n;
  return drba::src_plane<T>(a.img[d][s], plane - d * a.n);
}

template <typename T>
__device__ __forceinline__ T* out_ptr(const WarpArgs& a, int plane, long long r) {
  const int d = plane >= a.n;
  return static_cast<T*>(a.out) + (plane - d * a.n) * a.ob + r * a.opitch + a.off[d];
}

// The channel-parallel form: kPix output pixels per block; kTaps: the
// k-even tap form (4 taps a pixel)
template <typename T, typename F, int V, bool kTaps>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const __grid_constant__ WarpArgs a) {
  constexpr int kPix = kTaps ? kThreads / 2 : kThreads;
  __shared__ Tap s_tap[kTaps ? 4 * kPix : kPix];
  __shared__ const T* s_img[2][kPix];  // each pixel's image plane, per operand
  __shared__ T* s_out[kPix];           // each pixel's first output channel

  const long long hw_out = static_cast<long long>(a.ho) * a.wo;
  const long long p0 = static_cast<long long>(blockIdx.x) * kPix;
  const int npix = static_cast<int>(
      min(static_cast<long long>(kPix), static_cast<long long>(a.planes) * hw_out - p0));

  // phase 1: corner offsets and weights of every sample of the block
  for (int i = threadIdx.x; i < (kTaps ? 4 * npix : npix); i += kThreads) {
    int plane;
    s_tap[i] = sample_corners<F, kTaps>(a, p0, i, plane);
    if (!kTaps || (i & 3) == 0) {
      const int p = kTaps ? i >> 2 : i;
      s_img[0][p] = plane_ptr<T>(a, plane, 0);
      s_img[1][p] = a.c0 < a.c ? plane_ptr<T>(a, plane, 1) - a.c0 : nullptr;
      s_out[p] = out_ptr<T>(a, plane, p0 + p - plane * hw_out);
    }
  }
  __syncthreads();

  // phase 2: (pixel, channel group) elements e = p * cv + g, channel groups
  // fastest; element e is V outputs at channel g * V of pixel p. U elements
  // a thread at once (taps: 2), so their corner loads are in flight
  // together; elements past the block's end repeat its last pixel and are
  // not stored
  constexpr int U = kTaps ? 2 : 1;
  const int cv = a.c / V;
  const int total = npix * cv;
  const int dp = kThreads / cv, dc = kThreads % cv;
  const int sx0 = static_cast<int>(a.img[0][0].sx), sx1 = static_cast<int>(a.img[0][1].sx);
  int p = threadIdx.x / cv, g = threadIdx.x % cv;
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
      const int ch = gu[u] * V;
      const int s = ch >= a.c0;  // V divides c0: a group lies in one operand
      const T* img = s_img[s][pu[u]] + ch;
      const int sx = s ? sx1 : sx0;
      if (!kTaps) {
        sample<T, V>(img, sx, s_tap[pu[u]], v[u]);
      } else {
        float t4[V];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sample<T, V>(img, sx, s_tap[4 * pu[u] + t], t4);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float r = drba::round_to<T>(t4[i]);
            v[u][i] = t == 0 ? r : v[u][i] + r;
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) v[u][i] = v[u][i] * 0.25f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e + u * kThreads < total) store_vec<T, V>(s_out[pu[u]] + gu[u] * V, v[u]);
  }
}

// k == 1 at narrow C (the merge's c = 3, one operand): one thread per output
// pixel and all its channels; its c * sizeof(T) bytes are too few to spread
// over lanes
template <typename T, typename F>
__global__ void __launch_bounds__(kThreads)
    warp_narrow_kernel(const __grid_constant__ WarpArgs a) {
  const long long hw = static_cast<long long>(a.h) * a.w;
  const long long gp = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (gp >= a.planes * hw) return;
  int plane;
  const Tap k = sample_corners<F, false>(a, gp, 0, plane);
  const T* img = plane_ptr<T>(a, plane, 0);
  T* dst = out_ptr<T>(a, plane, gp - plane * hw);
  const int sx = static_cast<int>(a.img[0][0].sx);
  for (int ch = 0; ch < a.c; ++ch) {
    float v[1];
    sample<T, 1>(img + ch, sx, k, v);
    dst[ch] = drba::from_f32<T>(v[0]);
  }
}

constexpr int kNarrowC = 4;  // widest C of the per-pixel form

template <typename T, typename F, int V>
int launch(const WarpArgs& a, cudaStream_t s) {
  const long long pix = static_cast<long long>(a.planes) * a.ho * a.wo;
  if (a.k == 1 && a.c <= kNarrowC && a.c0 == a.c) {
    warp_narrow_kernel<T, F><<<drba::cdiv(pix, kThreads), kThreads, 0, s>>>(a);
  } else if (a.k == 1) {
    warp_kernel<T, F, V, false><<<drba::cdiv(pix, kThreads), kThreads, 0, s>>>(a);
  } else {
    warp_kernel<T, F, V, true><<<drba::cdiv(pix, kThreads / 2), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(long long v, int elems) { return v % elems == 0; }

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// V channels of T in one access: V divides every operand's channels, pixel
// and plane strides and the output's, and the pointers are aligned to it
template <typename T>
bool fits(const WarpArgs& a, int v) {
  const int bytes = v * static_cast<int>(sizeof(T));
  if (a.c % v || a.c0 % v || !aligned(a.ob, v) || !aligned(a.opitch, v) ||
      !aligned(a.off[0], v) || !aligned(a.off[1], v) || !aligned(a.out, bytes))
    return false;
  for (int d = 0; d < 2; ++d)
    for (int s = 0; s < 2; ++s) {
      const drba::Src& o = a.img[d][s];
      if (!aligned(o.sb, v) || !aligned(o.sx, v) || !aligned(o.ptr[0], bytes) ||
          !aligned(o.ptr[1], bytes))
        return false;
    }
  return true;
}

// the widest channel group: V channels of T in one 16-, 8-, 4- or 2-byte access
template <typename T, typename F>
int dispatch_vec(const WarpArgs& a, cudaStream_t s) {
  constexpr int kMax = 16 / sizeof(T);
  for (int v = kMax; v > 1; v /= 2) {
    if (fits<T>(a, v)) {
      if (v == 8) return launch<T, F, (kMax >= 8 ? 8 : 1)>(a, s);
      if (v == 4) return launch<T, F, 4>(a, s);
      return launch<T, F, 2>(a, s);
    }
  }
  return launch<T, F, 1>(a, s);
}

}  // namespace

// `args`, a WarpArgs: the images of one or two directions (drba_tpu_torch/
// ops/warp_cuda.py builds it; operands in one dtype, `img_dtype`), the
// (n, h, w, fstride) flow (direction 0 reads its channels [0, 2), direction
// 1 [foff1, foff1 + 2)) and the output; k is 1 or even with h % k == 0 and
// w % k == 0, every corner's pixel index times an operand's pixel stride is
// below 2^31, and the narrow form takes one operand (checked by the caller).
// Returns cudaGetLastError() after the launch.
extern "C" int drba_warp(const void* args, int img_dtype, int flow_dtype, void* stream) {
  const WarpArgs& a = *static_cast<const WarpArgs*>(args);
  if (static_cast<long long>(a.planes) * a.ho * a.wo * a.c == 0) return 0;
  const long long sx = a.img[0][0].sx > a.img[0][1].sx ? a.img[0][0].sx : a.img[0][1].sx;
  if (static_cast<long long>(a.h) * a.w * sx >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DRBA_DISPATCH(img_dtype, T, DRBA_DISPATCH(flow_dtype, F, return dispatch_vec<T, F>(a, s)));
  return 0;
}
