// An IFBlock's input, written once at the block's working resolution into a
// buffer whose channel count is padded to a multiple of 8.
//
// Replaces no TPU kernel. On the TPU, XLA fused IFNet's concatenations into
// their consumers (drba_tpu/models/ifnet.py:ifnet_apply builds each block's
// input with jnp.concatenate and a resize, and the first conv reads the
// fusion). Eager PyTorch writes each concatenation out: full-resolution
// NHWC copies of 1-, 3- and 16-channel pieces (CatArrayBatchedCopy), the
// resize of the result, T-fold copies of the window's shared frame, and
// cuDNN's copy that pads 39 / 52 input channels to 40 / 56. This kernel
// writes the channels [first, cout) of the (n, ho, wo, cout) block input
// once: up to kMaxSrc operands side by side, each read where it lies
// (common.cuh:Src:
// any strides, a batch stride of 0 for a frame shared by the planes, one of
// two frames chosen per plane), each resized from the IFNet's full
// resolution (h, w) to (ho, wo) as it is written, or placed as it is where
// it already lies at (ho, wo), then zeros up to cout. At an even integer
// scale the warps write channels [0, first) themselves, at the k-fold
// downsample's tap grid (warp.cu's pitched output); elsewhere they are
// operands here.
//
// Per channel, resizing each operand and then placing it equals placing
// and then resizing. The resize is F.interpolate's align_corners=False
// bilinear (upsample_bilinear2d): source index max(scale * (i + 0.5) - 0.5,
// 0) with scale = in / out in f32, the lower tap its truncation, the upper
// one clamped to the edge, and h0 * (w0 * v00 + w1 * v01) + h1 * (w0 * v10 +
// w1 * v11) in f32; an even integer factor k gives the mean of the 2x2 taps
// {k*i + k/2 - 1, k*i + k/2} exactly. Each tap is first rounded to the output
// dtype (the operands' conversion to it before the resize), the result
// rounded again, then multiplied by the operand's `mult` (the flow's 1 /
// scale) in f32 and rounded on the store, as the eager ops round.
//
// Bound on this card: memory. The work per element is a few integer and
// f32 operations beside up to four loads and one store. The work is split
// in two phases per block of kPix output pixels: (1) one thread per pixel
// computes its plane, rows, columns, bilinear weights and per-plane picks,
// into shared memory; (2) each thread takes one channel of every P-th pixel
// of the block, neighbouring lanes neighbouring channels, so lanes store
// neighbouring channels of one pixel. (At full resolution the warps write
// to a buffer of their own and this kernel places them with the rest, all
// of a pixel's channels at once: written in place they would fill 38 of a
// pixel's 56 channels and leave 32-byte sectors part-written, and stage 4's
// warps took 1.44 ms so, against 0.82 ms into a buffer of their own, at
// 1088x1920, T = 3; at the tap grid the difference is 4%.) What each output
// channel reads is staged in shared memory once, then held in registers:
// the kernel parameters indexed by lane would be read one address at a
// time, and from shared memory per element the descriptors cost more than
// the data (3.6 ms for stage 4's 56 channels).

#include "bilinear.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = kThreads;
constexpr int kMaxSrc = 8;
constexpr int kMaxC = 64;
constexpr int U = 4;  // pixels a thread at once

struct AssembleArgs {
  drba::Src src[kMaxSrc];
  unsigned char at_out[kMaxSrc];  // operand i lies at (ho, wo) already: placed, not resized
  signed char src_of[kMaxC];      // output channel first + j: operand index, or -1 (zero)
  unsigned char ch_of[kMaxC];     // and its channel in that operand
  void* out;                      // (n, ho, wo, cout), contiguous
  int n, h, w, ho, wo, cout, first;
  float sh, sw;                   // h / ho and w / wo in f32 (F.interpolate's scales)
};

// what output channel first + j reads: its operand's frames, strides and
// the channel's element offset c0, the operand's index (its bit in a
// pixel's `alt`), whether it is resized, its dtype (-1: a zero channel)
// and factor
struct Chan {
  const void* ptr[2];
  long long sb, sy, sx, c0;
  int src, resize, dtype;
  float mult;
};

// one output pixel: its plane, row and column; the bilinear taps of the
// resize, rows y0, y1 and columns x0, x1 of the full-resolution plane, with
// the weights of each; bit i of `alt`: operand i reads its second frame
struct Taps {
  int plane, oy, ox, y0, y1, x0, x1, alt;
  float ly0, ly1, lx0, lx1;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_input_kernel(const __grid_constant__ AssembleArgs a) {
  __shared__ Taps s_tap[kPix];
  __shared__ Chan s_ch[kMaxC];
  const int hw = a.ho * a.wo;
  const int p0 = blockIdx.x * kPix;
  const int npix = min(kPix, a.n * hw - p0);
  const int nc = a.cout - a.first;

  // each output channel's operand
  for (int j = threadIdx.x; j < nc; j += kThreads) {
    Chan c{};
    c.dtype = -1;
    const int si = a.src_of[j];
    if (si >= 0) {
      const drba::Src& s = a.src[si];
      c.ptr[0] = s.ptr[0];
      c.ptr[1] = s.ptr[1];
      c.sb = s.sb;
      c.sy = s.sy;
      c.sx = s.sx;
      c.c0 = a.ch_of[j] * s.sc;
      c.src = si;
      c.resize = !a.at_out[si];
      c.dtype = s.dtype;
      c.mult = s.mult;
    }
    s_ch[j] = c;
  }

  // phase 1: each pixel's plane, position, taps, weights and picks
  for (int i = threadIdx.x; i < npix; i += kThreads) {
    Taps t;
    t.plane = (p0 + i) / hw;
    const int r = p0 + i - t.plane * hw;
    t.oy = r / a.wo;
    t.ox = r - t.oy * a.wo;
    drba::axis(a.sh, t.oy, a.h, t.y0, t.y1, t.ly0, t.ly1);
    drba::axis(a.sw, t.ox, a.w, t.x0, t.x1, t.lx0, t.lx1);
    t.alt = 0;
    for (int si = 0; si < kMaxSrc; ++si)
      if (a.src[si].pick != nullptr && a.src[si].pick[t.plane] != 0) t.alt |= 1 << si;
    s_tap[i] = t;
  }
  __syncthreads();

  // phase 2: thread (q, j) writes channel first + j of the block's pixels
  // q, q + P, q + 2P, ... (P = kThreads / nc), U pixels at once, their taps
  // loaded before any is used, so that more loads are in flight
  const int P = kThreads / nc;
  const int q = threadIdx.x / nc, j = threadIdx.x - q * nc;
  if (q >= P) return;
  const Chan c = s_ch[j];
  T* out = static_cast<T*>(a.out) + static_cast<long long>(p0) * a.cout + a.first + j;
  for (int p = q; p < npix; p += U * P) {
    float v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const Taps& t = s_tap[min(p + u * P, npix - 1)];
      const void* base = c.ptr[(t.alt >> c.src) & 1];
      const long long c0 = t.plane * c.sb + c.c0;
      if (c.dtype < 0) {
        v[u][0] = 0.f;
      } else if (!c.resize) {
        v[u][0] = drba::load_f32(c.dtype, base, c0 + t.oy * c.sy + t.ox * c.sx);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[u][k] = drba::load_f32(c.dtype, base, c0 + ((k >> 1) ? t.y1 : t.y0) * c.sy +
                                                      ((k & 1) ? t.x1 : t.x0) * c.sx);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pu = p + u * P;
      if (pu >= npix) break;
      const Taps& t = s_tap[pu];
      // each tap rounded to the output dtype, then F.interpolate's sum
      float r = drba::round_to<T>(v[u][0]);
      if (c.dtype >= 0 && c.resize)
        r = drba::round_to<T>(drba::bilerp(t.ly0, t.ly1, t.lx0, t.lx1, r,
                                           drba::round_to<T>(v[u][1]),
                                           drba::round_to<T>(v[u][2]),
                                           drba::round_to<T>(v[u][3])));
      out[static_cast<long long>(pu) * a.cout] = drba::from_f32<T>(r * c.mult);
    }
  }
}

}  // namespace

// Write channels [first, cout) of `out` (n, ho, wo, cout) from the operands
// of `args`, an AssembleArgs (drba_tpu_torch/ops/block_input.py builds it;
// every operand is (n, h, w, .), or (n, ho, wo, .) where at_out is set, in
// the output's dtype or f32); n * ho * wo * cout < 2^31 (checked by the
// caller). The argument is untyped, as every C entry here takes plain C
// types only. Returns cudaGetLastError() after the launch.
extern "C" int drba_block_input(const void* args, int dtype, void* stream) {
  const AssembleArgs& a = *static_cast<const AssembleArgs*>(args);
  const int pix = a.n * a.ho * a.wo;
  if (pix == 0 || a.cout <= a.first) return 0;
  if (a.cout > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DRBA_DISPATCH(dtype, T,
                block_input_kernel<T><<<drba::cdiv(pix, kPix), kThreads, 0, s>>>(a));
  return static_cast<int>(cudaGetLastError());
}
