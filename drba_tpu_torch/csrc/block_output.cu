// An IFBlock's output, written once at the IFNet's full resolution: the
// lastconv's pixel shuffle, the bilinear resize, the flow's scale and its
// accumulation in one pass.
//
// Replaces no TPU kernel. On the TPU, XLA fused the tail of each block
// (drba_tpu/models/ifnet.py:311-313: pixel_shuffle, resize_bilinear, the
// flow times the scale) and the sum of the flows (:427) into their
// consumers. Eager PyTorch writes each out: upsample_bilinear2d of the 13
// shuffled channels to full resolution, a multiply of the 4 flow channels
// by the scale, and the add of the running flow. This kernel reads the
// lastconv's output (n, hl, wl, C >= 52: 4 x 13 channels in pixel-shuffle
// order) and writes, for each full-resolution pixel (ho, wo):
//   flow_out (n, ho, wo, 4) = flow + round(resize(shuffled[:4]) * scale)
//     (no `flow` at block 0),
//   mf_out (n, ho, wo, 9) = resize(shuffled[4:13]): the mask, then the
//     features,
// where shuffled is pixel_shuffle(lc, 2)[..., :13] at the block's
// resolution (hb, wb) = (2 hl, 2 wl): its (y, x, c) is the lastconv's
// (y / 2, x / 2, 4 c + 2 (y % 2) + x % 2), an index map, nothing written.
// The resize is F.interpolate's align_corners=False bilinear (bilinear.cuh,
// the same arithmetic as block_input.cu); where (hb, wb) is (ho, wo) already
// the value is read as it is. Each step rounds as the eager ops do: the
// resized value to the output dtype, then its product with the scale in f32,
// then the sum with the flow in f32 (separate roundings, no fused
// multiply-add), so that the kernel equals the plain version bit for bit
// wherever F.interpolate's taps and weights are exact.
//
// Bound on this card: memory. Per output pixel 13 values are written (26
// bytes in bf16) and up to 4 taps of 13 values read, which neighbouring
// pixels share through L1 (at RIFE's block 0 a 32 x 32 patch of output
// pixels reads one lastconv pixel); the incoming flow is read once. One
// thread writes one pixel. The 13 values of a tap's phase lie 4 channels
// apart; in bf16 each is read as the 32-bit word that holds it and its
// neighbour, and its half picked with a select (no local memory). The
// outputs go through shared memory: a block's 256 pixels are contiguous in
// both, and the block writes them as whole 16-byte vectors. Measured on an
// H100 over RIFE's five blocks at 1088x1920, T = 3, bf16: each thread
// storing its pixel's 9 mask and feature values itself, 18 bytes apart,
// part-wrote each 32-byte sector nine times (1.217 ms against 0.878 ms);
// reading each tap's whole 112-byte lastconv pixel as seven 16-byte vectors
// took 0.878 ms against 0.714 ms for the 32-bit words, 16-bit loads 0.882
// ms, one load of a lastconv pixel for every tap that shares it 1.357 ms
// (99 registers, and the branches diverge within a warp), and a shared
// memory row padded against bank conflicts 0.761 ms.

#include "bilinear.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 13;   // the block's output channels: flow 4, mask 1, features 8
constexpr int kFlow = 4;

struct OutputArgs {
  const void* lc;           // the lastconv's output (n, hl, wl, C >= 52), channels contiguous
  long long sb, sy, sx;     // its plane, row and pixel strides in elements
  const void* flow;         // the running flow (n, ho, wo, 4), contiguous, or null
  void* flow_out;           // (n, ho, wo, 4), contiguous
  void* mf_out;             // (n, ho, wo, 9), contiguous: the mask, then the features
  int n, hb, wb, ho, wo;    // (hb, wb) = (2 hl, 2 wl): the block's resolution
  int resize;               // 0: (hb, wb) == (ho, wo), each value read as it is
  float sh, sw;             // hb / ho and wb / wo in f32 (F.interpolate's scales)
  float scale;              // the flow's factor
};

// the 13 values of phase ph (0-3) of the lastconv pixel at `p`: its
// channels 4 c + ph, as f32
__device__ __forceinline__ void load_phase(const float* p, int ph, float (&v)[kOut]) {
#pragma unroll
  for (int c = 0; c < kOut; ++c) v[c] = __ldg(p + 4 * c + ph);
}

__device__ __forceinline__ void load_phase(const drba::bf16* p, int ph, float (&v)[kOut]) {
  // 32-bit word 2c + ph / 2 holds channels 4c + 2 (ph / 2) and the one after,
  // the even channel in its low half
  const unsigned* q = reinterpret_cast<const unsigned*>(p);
  const int w = ph >> 1;
  const bool high_half = ph & 1;
#pragma unroll
  for (int c = 0; c < kOut; ++c) {
    const unsigned u = __ldg(q + 2 * c + w);
    v[c] = __uint_as_float(high_half ? u & 0xffff0000u : u << 16);
  }
}

// the 13 values of the shuffled block output at (y, x) of one plane
template <typename T>
__device__ __forceinline__ void shuffled(const OutputArgs& a, const T* lc, int y, int x,
                                         float (&v)[kOut]) {
  load_phase(lc + (y >> 1) * a.sy + (x >> 1) * a.sx, 2 * (y & 1) + (x & 1), v);
}

// four values of T, stored or loaded as one vector
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  __device__ static float4 pack(const float (&f)[kFlow]) { return {f[0], f[1], f[2], f[3]}; }
  __device__ static void unpack(float4 u, float (&f)[kFlow]) {
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
};
template <> struct Vec4<drba::bf16> {
  using type = uint2;
  __device__ static unsigned two(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static uint2 pack(const float (&f)[kFlow]) {
    return {two(f[0], f[1]), two(f[2], f[3])};
  }
  __device__ static void unpack(uint2 u, float (&f)[kFlow]) {
    f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & 0xffff0000u);
  }
};

// copy `n` elements of T from shared memory to `dst` (16-byte aligned), as
// 16-byte vectors, then the tail element by element
template <typename T>
__device__ __forceinline__ void copy_out(const T* src, T* dst, int n) {
  const int vecs = n * static_cast<int>(sizeof(T)) / 16;
  for (int k = threadIdx.x; k < vecs; k += kThreads)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
  for (int e = vecs * 16 / static_cast<int>(sizeof(T)) + threadIdx.x; e < n; e += kThreads)
    dst[e] = src[e];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_output_kernel(const __grid_constant__ OutputArgs a) {
  constexpr int kMf = kOut - kFlow;
  __shared__ __align__(16) T s_flow[kThreads * kFlow];
  __shared__ __align__(16) T s_mf[kThreads * kMf];
  // pixel indices fit an int: n * ho * wo * 9 < 2^31 (checked by the caller)
  const int hw = a.ho * a.wo;
  const int p0 = blockIdx.x * kThreads;
  const int npix = min(kThreads, a.n * hw - p0);
  const int i = p0 + threadIdx.x;

  if (threadIdx.x < npix) {
    const int plane = i / hw;
    const int r = i - plane * hw;
    const int oy = r / a.wo, ox = r - oy * a.wo;
    const T* lc = static_cast<const T*>(a.lc) + plane * a.sb;

    float v[kOut];
    if (!a.resize) {
      shuffled(a, lc, oy, ox, v);
    } else {
      int y0, y1, x0, x1;
      float ly0, ly1, lx0, lx1;
      drba::axis(a.sh, oy, a.hb, y0, y1, ly0, ly1);
      drba::axis(a.sw, ox, a.wb, x0, x1, lx0, lx1);
      float v00[kOut], v01[kOut], v10[kOut], v11[kOut];
      shuffled(a, lc, y0, x0, v00);
      shuffled(a, lc, y0, x1, v01);
      shuffled(a, lc, y1, x0, v10);
      shuffled(a, lc, y1, x1, v11);
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        v[c] = drba::round_to<T>(
            drba::bilerp(ly0, ly1, lx0, lx1, v00[c], v01[c], v10[c], v11[c]));
    }

    using V = Vec4<T>;
    float f[kFlow];
#pragma unroll
    for (int c = 0; c < kFlow; ++c) f[c] = drba::round_to<T>(__fmul_rn(v[c], a.scale));
    if (a.flow != nullptr) {
      float g[kFlow];
      V::unpack(__ldg(static_cast<const typename V::type*>(a.flow) + i), g);
#pragma unroll
      for (int c = 0; c < kFlow; ++c) f[c] = __fadd_rn(g[c], f[c]);
    }
    reinterpret_cast<typename V::type*>(s_flow)[threadIdx.x] = V::pack(f);
#pragma unroll
    for (int c = kFlow; c < kOut; ++c)
      s_mf[threadIdx.x * kMf + c - kFlow] = drba::from_f32<T>(v[c]);
  }
  __syncthreads();
  // the block's pixels are contiguous in both outputs: whole vectors out
  copy_out(s_flow, static_cast<T*>(a.flow_out) + static_cast<long long>(p0) * kFlow,
           npix * kFlow);
  copy_out(s_mf, static_cast<T*>(a.mf_out) + static_cast<long long>(p0) * kMf, npix * kMf);
}

}  // namespace

// Write an IFBlock's output from `args`, an OutputArgs (drba_tpu_torch/
// ops/block_output.py builds and checks it: the lastconv's output with at
// least 52 contiguous channels and 4-byte aligned pixels, every tensor in
// the dtype of code `dtype`, the flows 16-byte aligned). The argument is
// untyped, as every C entry here takes plain C types only. Returns
// cudaGetLastError() after the launch.
extern "C" int drba_block_output(const void* args, int dtype, void* stream) {
  const OutputArgs& a = *static_cast<const OutputArgs*>(args);
  const long long pix = static_cast<long long>(a.n) * a.ho * a.wo;
  if (pix == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DRBA_DISPATCH(dtype, T,
                block_output_kernel<T><<<drba::cdiv(pix, kThreads), kThreads, 0, s>>>(a));
  return static_cast<int>(cudaGetLastError());
}
