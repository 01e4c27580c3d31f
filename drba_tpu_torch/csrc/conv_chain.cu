// 3x3 / stride-1 / pad-1 convolution (NHWC) with a fused bias and the
// epilogues of one conv-chain step:
//   * pre-PReLU: y = conv(prelu(x, alpha)) with one scalar slope alpha,
//     applied to the conv's input (GridNet's and MetricNet's Sequential
//     (PReLU, Conv) pairs);
//   * ResConv: y = leaky_relu(conv(x) * beta + x, 0.2) (IFNet);
//   * residual: y = y + res, where res is this step's un-activated input
//     (MetricNet's plain residual), the chain's input (a final 'input'
//     residual) or another tensor (a final 'extra' residual: GridNet's
//     lattice sums).
//
// Replaces the TPU kernel conv_chain (drba_tpu/ops/conv_chain.py:349, body
// _kernel :116) on the IFNet ResConv runs (drba_tpu/models/ifnet.py:203-264)
// and on the GMFSS nets under conv_backend='pallas' (MetricNet, FeatureNet
// level 1, GridNet L0/L1 and tail: drba_tpu/models/gmfss_nets.py:150-172,
// 225-234, 387-467). The TPU kernel packs narrow channels into 128 lanes
// and keeps a whole chain in VMEM over row bands; neither constraint exists
// here. Both kernels below are implicit GEMMs (M = output pixels, N =
// output channels, K = 9 taps x input channels), one launch per chain
// step, for all channel counts and every spatial size, with f32
// accumulation and the epilogues fused.
//
// bf16 (the main path): tensor cores through mma.sync m16n8k16 fed by
// ldmatrix. What bounds it on this card: the large IFNet steps (c = 64 and
// 32 at 1/4 and 1/2 resolution) and the GMFSS steps at 544x960 by memory;
// the deep narrow ones (c = 192 and 128 at 1/16 and 1/8: 1530 and 6120
// pixels at N = 3, K up to 1728) by latency, since even split into
// 64-pixel x 32-channel blocks their grid holds ~3 warps an SM, each
// waiting on its own ldmatrix -> mma chain (split-K over warps is the next
// step). The design:
//  * weights are packed once per model (ops/conv_chain.pack_weights) into
//    (ceil(Cin/16), 9, Cout, 16): one K chunk of 16 input channels is 9
//    contiguous runs of Cout 32-byte rows, the "col" B operand of the MMA
//    as ldmatrix reads it. No block transposes weights;
//  * a block covers a tile of 2*WM output rows x 16 columns and NB output
//    channels: all Cout of its pixels up to 128 (each input patch staged
//    once); wider layers (c = 192, 256) and the steps with too few tiles
//    for the card split Cout into 96-, 64- or 32-channel blocks (the last
//    one masked where Cout is no multiple) and, first, halve the tile's
//    rows. The host picks the first such plan that gives at least one
//    block per SM;
//  * per K chunk the (rows+2) x 18 x 16-channel input patch (zero outside
//    the frame and past Cin) and the chunk's 9 x NB x 16 weights are copied
//    by cp.async into a ring of 2-3 stages, so staging overlaps the MMAs of
//    the chunks before it; one barrier per chunk. Cin that is no multiple
//    of 8 (MetricNet's 14, GridNet's heads 12 and 9) is staged by plain
//    loads instead;
//  * the pre-PReLU runs once per staged element, in place on the landed
//    patch, behind one more barrier per chunk (prelu(0) = 0, so the zero
//    padding stays exact); a simple placement, not yet overlapped;
//  * each warp owns 2 output rows x 16 columns x NB/WN channels. A tap's
//    shifted window is only another row address for ldmatrix (rows are 32
//    bytes, the two 16-byte halves swapped by bit 2 of the row index, so
//    the 8 rows of every 8x8 matrix hit distinct banks);
//  * accumulators stay in registers. The epilogue swaps the accumulators
//    of each group of four n8 tiles across the lanes of a quad, so that
//    each lane holds 8 consecutive channels of one pixel; bias and beta
//    come from shared memory (staged once per block), the residuals x and
//    res are read and the output written as 16-byte vectors (one value at
//    a time where Cout is no multiple of 8, as MetricNet's Cout = 2).
// mma.sync rather than wgmma: the tile has to shrink to 64 pixels and 32
// channels to fill the card at the small steps, and the shifted windows
// are plain ldmatrix row addresses; wgmma's 64-row warpgroup tiles and
// shared-memory descriptors are a later step.
//
// f32: the FMA pipes (the tensor cores have no full-f32 mode), on the
// PyTorch OIHW weights. Block tile 8 x 32 pixels x 32 channels, 256 threads
// of 4 pixels x 8 channels each; patch and weights staged as f32 (the
// pre-PReLU applied as the patch is staged), 96 FMAs per 30 shared loads.
// Bound by FMA issue; not the main path.
//
// Rounding follows the plain PyTorch chain in the storage dtype T: the
// pre-PReLU's product is rounded to T; the conv output with its bias is
// rounded to T, then y * beta, + x and the leaky product are each rounded
// to T, and so is + res, as separate eager ops would.

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCO = 32;  // f32: output channels per block
constexpr int kCK = 16;  // input channels per shared-memory chunk

// prelu(v) = v >= 0 ? v : v * alpha, the product rounded to T (NaN stays NaN)
template <typename T>
__device__ __forceinline__ float prelu(float v, float alpha) {
  return v >= 0.f ? v : drba::round_to<T>(v * alpha);
}

// out[pix, co] from the f32 sum ``acc`` of conv(x) at that pixel and channel
template <typename T>
__device__ __forceinline__ void epilogue(float acc, const T* __restrict__ x,
                                         const T* __restrict__ bias,
                                         const T* __restrict__ beta,
                                         const T* __restrict__ res, T* __restrict__ out,
                                         long long pix, int co, int cin, int cout) {
  float y = drba::round_to<T>(acc + drba::to_f32(bias[co]));
  if (beta != nullptr) {  // ResConv: cin == cout, the residual is this conv's input
    const float t = drba::round_to<T>(y * drba::to_f32(beta[co]));
    const float u = drba::round_to<T>(t + drba::to_f32(x[pix * cin + co]));
    y = u >= 0.f ? u : drba::round_to<T>(u * 0.2f);
  }
  if (res != nullptr) y = drba::round_to<T>(y + drba::to_f32(res[pix * cout + co]));
  out[pix * cout + co] = drba::from_f32<T>(y);
}

// ------------------------------------------------------- bf16: mma.sync m16n8k16

constexpr int kMTW = 16;  // output columns per tile: the 16 rows of an A fragment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte half `c` of 32-byte row `r`: the halves of rows
// 4..7 (mod 8) are swapped, so 8 consecutive rows cover all 32 banks
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// WM x WN warps; each warp 2 m16 tiles (2 output rows x 16 columns) x NT n8
// tiles; the block NB = 8 * NT * WN output channels
template <int WM, int WN, int NT>
struct MmaCfg {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kTH = 2 * WM;  // output rows per tile
  static constexpr int kNB = 8 * NT * WN;
  static constexpr int kStages = kNB <= 64 ? 3 : 2;
  static constexpr int kPatchPix = (kTH + 2) * (kMTW + 2);
  static constexpr int kPatchBytes = kPatchPix * 32;  // 16 bf16 channels a pixel
  static constexpr int kStageBytes = kPatchBytes + 9 * kNB * 32;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kNB * 4;  // + bias, beta (f32)
};

struct ConvArgs {
  const drba::bf16* x;      // (n, h, w, cin)
  const drba::bf16* wp;     // packed (ceil(cin / 16), 9, cout, 16)
  const drba::bf16* bias;   // (cout,)
  const drba::bf16* beta;   // (cout,) or nullptr
  const drba::bf16* alpha;  // the pre-PReLU's scalar slope, or nullptr
  const drba::bf16* res;    // (n, h, w, cout) added last, or nullptr
  drba::bf16* out;          // (n, h, w, cout)
  int h, w, cin, cout, tiles_w;
  bool vec_in;   // cin % 8 == 0 and x 16-byte aligned: cp.async of 8 channels
  bool vec_out;  // cout % 8 == 0 and x, res, out 16-byte aligned: 16-byte epilogue
};

// the pre-PReLU in place on a staged patch of `bytes` bf16 bytes (a
// multiple of 16), 8 values a thread per step
template <int kThreads>
__device__ __forceinline__ void prelu_patch(unsigned char* patch, int bytes, float alpha,
                                            int tid) {
  for (int i = tid; i < bytes / 16; i += kThreads) {
    uint4 v = reinterpret_cast<uint4*>(patch)[i];
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      h2[e] = __floats2bfloat162_rn(prelu<drba::bf16>(f.x, alpha),
                                    prelu<drba::bf16>(f.y, alpha));
    }
    reinterpret_cast<uint4*>(patch)[i] = v;
  }
}

// thread `t` of a quad holds 2 channels (a float2) of each of 4 n8 tiles;
// afterwards it holds the 8 channels of tile t: o[2r], o[2r+1] from lane r
__device__ __forceinline__ void quad_transpose(const float2 (&in)[4], float (&o)[8], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int si = (t - s) & 3;  // this lane sends tile si ...
    float2 v = in[0];
    if (si == 1) v = in[1];
    if (si == 2) v = in[2];
    if (si == 3) v = in[3];
    const int src = (t + s) & 3;  // ... and receives its own tile from lane src
    const float vx = __shfl_sync(0xffffffffu, v.x, (lane & ~3) | src);
    const float vy = __shfl_sync(0xffffffffu, v.y, (lane & ~3) | src);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r == src) {
        o[2 * r] = vx;
        o[2 * r + 1] = vy;
      }
    }
  }
}

template <int WM, int WN, int NT>
__global__ void __launch_bounds__(MmaCfg<WM, WN, NT>::kThreads)
conv3x3_mma_kernel(const ConvArgs a) {
  using C = MmaCfg<WM, WN, NT>;
  static_assert(NT % 4 == 0, "the epilogue transposes groups of four n8 tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_bias = reinterpret_cast<float*>(smem + C::kStages * C::kStageBytes);
  float* s_beta = s_bias + C::kNB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int nb = blockIdx.z;
  const int co0 = blockIdx.y * C::kNB;
  const int ty0 = (blockIdx.x / a.tiles_w) * C::kTH;
  const int tx0 = (blockIdx.x % a.tiles_w) * kMTW;
  const drba::bf16* xn = a.x + static_cast<long long>(nb) * a.h * a.w * a.cin;
  const uint32_t s0 = smem_u32(smem);
  const float alpha = a.alpha != nullptr ? drba::to_f32(*a.alpha) : 0.f;

  for (int i = tid; i < C::kNB; i += C::kThreads) {
    const int co = co0 + i;
    s_bias[i] = co < a.cout ? drba::to_f32(a.bias[co]) : 0.f;
    s_beta[i] = co < a.cout && a.beta != nullptr ? drba::to_f32(a.beta[co]) : 0.f;
  }

  // K chunk ci0 .. ci0 + 15 into ring stage `st`
  auto stage = [&](int ci0, int st) {
    const uint32_t patch = s0 + st * C::kStageBytes;
    const uint32_t wsm = patch + C::kPatchBytes;
    for (int i = tid; i < C::kPatchPix * 2; i += C::kThreads) {
      const int half = i & 1, pix = i >> 1;
      const int r = pix / (kMTW + 2), col = pix - r * (kMTW + 2);
      const int gy = ty0 - 1 + r, gx = tx0 - 1 + col;
      const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      if (a.vec_in) {
        const int ci = ci0 + half * 8;
        const bool valid = inside && ci < a.cin;
        cp_async16(patch + swz(pix, half),
                   valid ? xn + (static_cast<long long>(gy) * a.w + gx) * a.cin + ci : xn,
                   valid);
      } else {
        drba::bf16* dst = reinterpret_cast<drba::bf16*>(smem + (patch - s0) + swz(pix, half));
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ci = ci0 + half * 8 + e;
          dst[e] = inside && ci < a.cin
                       ? xn[(static_cast<long long>(gy) * a.w + gx) * a.cin + ci]
                       : __float2bfloat16_rn(0.f);
        }
      }
    }
    const drba::bf16* wk = a.wp + static_cast<long long>(ci0 / 16) * 9 * a.cout * 16;
    for (int i = tid; i < 9 * C::kNB * 2; i += C::kThreads) {
      const int half = i & 1, row = i >> 1;  // row = tap * NB + channel in the block
      const int tap = row / C::kNB, co = co0 + row - tap * C::kNB;
      const bool valid = co < a.cout;
      cp_async16(wsm + swz(row, half),
                 valid ? wk + (static_cast<long long>(tap) * a.cout + co) * 16 + half * 8
                       : a.wp,
                 valid);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nch = (a.cin + kCK - 1) / kCK;
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nch) stage(s * kCK, s);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<C::kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();                  // ... everyone's, and stage (c - 1) is free
    const int nx = c + C::kStages - 1;
    if (nx < nch) stage(nx * kCK, nx % C::kStages);
    cp_async_commit();

    if (a.alpha != nullptr) {  // chunk c's patch is complete: activate it in place
      prelu_patch<C::kThreads>(smem + (c % C::kStages) * C::kStageBytes, C::kPatchBytes,
                               alpha, tid);
      __syncthreads();
    }
    const uint32_t patch = s0 + (c % C::kStages) * C::kStageBytes;
    const uint32_t wsm = patch + C::kPatchBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)  // rows: 16 neighbouring pixels; halves: channels 0-7, 8-15
        ldmatrix_x4(af[i], patch + swz((wm * 2 + i + dy) * (kMTW + 2) + (lane & 15) + dx,
                                       lane >> 4));
      uint32_t bf[NT][2];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {  // two n8 tiles x both channel halves
        uint32_t r[4];
        const int n = wn * NT * 8 + jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, wsm + swz(tap * C::kNB + n, (lane >> 3) & 1));
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  // epilogue from the registers: lane (g, t) holds pixels g and g + 8 of
  // each m16 tile, channels 2t, 2t + 1 of each n8 tile
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oy = ty0 + wm * 2 + i;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ox = tx0 + g + 8 * hh;
      const bool inside = oy < a.h && ox < a.w;
      const long long pix = (static_cast<long long>(nb) * a.h + oy) * a.w + ox;
#pragma unroll
      for (int q = 0; q < NT / 4; ++q) {
        float2 in[4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
          in[s] = make_float2(acc[i][4 * q + s][2 * hh], acc[i][4 * q + s][2 * hh + 1]);
        float o[8];
        quad_transpose(in, o, lane);
        const int nl = wn * NT * 8 + (4 * q + (lane & 3)) * 8;  // channel in the block
        const int co = co0 + nl;
        if (!inside || co >= a.cout) continue;
        if (a.vec_out && co + 8 <= a.cout) {
          float y[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = drba::round_to<drba::bf16>(o[e] + s_bias[nl + e]);
          if (a.beta != nullptr) {
            const uint4 xr = *reinterpret_cast<const uint4*>(a.x + pix * a.cin + co);
            const drba::bf16* xv = reinterpret_cast<const drba::bf16*>(&xr);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float t = drba::round_to<drba::bf16>(y[e] * s_beta[nl + e]);
              const float u = drba::round_to<drba::bf16>(t + drba::to_f32(xv[e]));
              y[e] = u >= 0.f ? u : drba::round_to<drba::bf16>(u * 0.2f);
            }
          }
          if (a.res != nullptr) {
            const uint4 rr = *reinterpret_cast<const uint4*>(a.res + pix * a.cout + co);
            const drba::bf16* rv = reinterpret_cast<const drba::bf16*>(&rr);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              y[e] = drba::round_to<drba::bf16>(y[e] + drba::to_f32(rv[e]));
          }
          uint4 orow;
          drba::bf16* ov = reinterpret_cast<drba::bf16*>(&orow);
#pragma unroll
          for (int e = 0; e < 8; ++e) ov[e] = drba::from_f32<drba::bf16>(y[e]);
          *reinterpret_cast<uint4*>(a.out + pix * a.cout + co) = orow;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (co + e < a.cout)
              epilogue<drba::bf16>(o[e], a.x, a.bias, a.beta, a.res, a.out, pix, co + e,
                                   a.cin, a.cout);
        }
      }
    }
  }
}

constexpr int kMaxDevices = 16;

template <int WM, int WN, int NT>
int launch_mma(const ConvArgs& a, int n, int dev, cudaStream_t s) {
  using C = MmaCfg<WM, WN, NT>;
  auto kernel = conv3x3_mma_kernel<WM, WN, NT>;
  // the attribute holds per device: set once per instantiation and device
  // (on every launch past kMaxDevices); atomic, as host threads may launch
  // at once, and setting it twice is harmless
  static std::atomic<bool> smem_set[kMaxDevices] = {};
  if (dev >= kMaxDevices || !smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const dim3 grid(drba::cdiv(a.h, C::kTH) * a.tiles_w, drba::cdiv(a.cout, C::kNB), n);
  kernel<<<grid, C::kThreads, C::kSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// output channels per block -> (WN, NT)
int launch_plan(const ConvArgs& a, int n, int wm, int nb, int dev, cudaStream_t s) {
  if (wm == 4) {
    switch (nb) {
      case 32: return launch_mma<4, 1, 4>(a, n, dev, s);
      case 64: return launch_mma<4, 1, 8>(a, n, dev, s);
      case 96: return launch_mma<4, 1, 12>(a, n, dev, s);
      default: return launch_mma<4, 2, 8>(a, n, dev, s);
    }
  }
  switch (nb) {
    case 32: return launch_mma<2, 1, 4>(a, n, dev, s);
    case 64: return launch_mma<2, 1, 8>(a, n, dev, s);
    case 96: return launch_mma<2, 1, 12>(a, n, dev, s);
    default: return launch_mma<2, 2, 8>(a, n, dev, s);
  }
}

int conv3x3_bf16(ConvArgs a, int n, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  a.tiles_w = static_cast<int>(drba::cdiv(a.w, kMTW));
  // all of Cout in one block up to 128 channels, else 96-channel halves;
  // then, while the grid has fewer blocks than SMs: half the rows, 64 and
  // 32 channels a block
  const int full = a.cout <= 128 ? ((a.cout + 31) / 32) * 32 : 96;
  const int plans[4][2] = {{4, full}, {2, full}, {2, full > 64 ? 64 : full},
                           {2, full > 32 ? 32 : full}};
  int wm = 2, nb = 32;
  for (const auto& p : plans) {
    wm = p[0];
    nb = p[1];
    const long long blocks = static_cast<long long>(drba::cdiv(a.h, 2 * wm)) * a.tiles_w *
                             drba::cdiv(a.cout, nb) * n;
    if (blocks >= sms) break;
  }
  return launch_plan(a, n, wm, nb, dev, s);
}

// ------------------------------------------------------------------ f32: FMA

constexpr int kTH = 8;   // output rows per block
constexpr int kTW = 32;  // output columns per block

__global__ void __launch_bounds__(kThreads)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ bias, const float* __restrict__ beta,
                   const float* __restrict__ alpha, const float* __restrict__ res,
                   float* __restrict__ out, int h, int w, int cin, int cout, int tiles_w) {
  __shared__ float s_in[kCK][kTH + 2][kTW + 2];
  __shared__ float s_w[kCK][9][kCO];

  const int nb = blockIdx.z;
  const int co0 = blockIdx.y * kCO;
  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int tid = threadIdx.x;
  const int cg = tid & 3;       // channel group: 8 output channels
  const int pg = tid >> 2;      // pixel group: 4 consecutive columns
  const int pr = pg >> 3;       // row in the tile
  const int pc = (pg & 7) * 4;  // first column in the tile

  const float* xn = x + static_cast<long long>(nb) * h * w * cin;
  const float a_pre = alpha != nullptr ? *alpha : 0.f;
  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[p][k] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += kCK) {
    for (int i = tid; i < (kTH + 2) * (kTW + 2) * kCK; i += kThreads) {
      const int c = i % kCK;
      const int p = i / kCK;
      const int r = p / (kTW + 2), col = p % (kTW + 2);
      const int gy = ty0 - 1 + r, gx = tx0 - 1 + col, ci = ci0 + c;
      float v = (gy >= 0 && gy < h && gx >= 0 && gx < w && ci < cin)
                    ? xn[(static_cast<long long>(gy) * w + gx) * cin + ci]
                    : 0.f;
      if (alpha != nullptr) v = prelu<float>(v, a_pre);
      s_in[c][r][col] = v;
    }
    for (int i = tid; i < kCO * kCK * 9; i += kThreads) {
      const int tap = i % 9;
      const int c = (i / 9) % kCK;
      const int co = i / (9 * kCK);
      const int gco = co0 + co, ci = ci0 + c;
      s_w[c][tap][co] = (gco < cout && ci < cin)
                            ? wt[(static_cast<long long>(gco) * cin + ci) * 9 + tap]
                            : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < kCK; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xin[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) xin[j] = s_in[c][pr + dy][pc + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float wv[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) wv[k] = s_w[c][dy * 3 + dx][cg * 8 + k];
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[p][k] = fmaf(xin[p + dx], wv[k], acc[p][k]);
        }
      }
    }
    __syncthreads();
  }

  const int oy = ty0 + pr;
  if (oy >= h) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ox = tx0 + pc + p;
    if (ox >= w) continue;
    const long long pix = (static_cast<long long>(nb) * h + oy) * w + ox;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int co = co0 + cg * 8 + k;
      if (co < cout) epilogue<float>(acc[p][k], x, bias, beta, res, out, pix, co, cin, cout);
    }
  }
}

}  // namespace

// x (n,h,w,cin), bias (cout,), beta (cout,) or NULL, alpha (1,) or NULL,
// res (n,h,w,cout) or NULL, out (n,h,w,cout); all in one dtype (f32|bf16),
// contiguous. bf16 reads the weights packed by ops/conv_chain.pack_weights,
// wp (ceil(cin/16), 9, cout, 16), 16-byte aligned; f32 reads wt
// (cout,cin,3,3). With beta, cin == cout and no alpha (checked by the
// caller). Returns cudaGetLastError().
extern "C" int drba_conv3x3(const void* x, const void* wt, const void* wp, const void* bias,
                            const void* beta, const void* alpha, const void* res, void* out,
                            int n, int h, int w, int cin, int cout, int dtype, void* stream) {
  if (static_cast<long long>(n) * h * w * cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == drba::kBF16) {
    using T = drba::bf16;
    if (wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool res16 = reinterpret_cast<uintptr_t>(res) % 16 == 0;  // NULL is aligned
    const ConvArgs a{static_cast<const T*>(x), static_cast<const T*>(wp),
                     static_cast<const T*>(bias), static_cast<const T*>(beta),
                     static_cast<const T*>(alpha), static_cast<const T*>(res),
                     static_cast<T*>(out), h, w, cin, cout, 0,
                     cin % 8 == 0 && x16,
                     cout % 8 == 0 && x16 && res16 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0};
    return conv3x3_bf16(a, n, s);
  }
  if (dtype == drba::kF32) {
    const int tiles_w = static_cast<int>(drba::cdiv(w, kTW));
    const dim3 grid(drba::cdiv(h, kTH) * tiles_w, drba::cdiv(cout, kCO), n);
    conv3x3_fma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<const float*>(bias), static_cast<const float*>(beta),
        static_cast<const float*>(alpha), static_cast<const float*>(res),
        static_cast<float*>(out), h, w, cin, cout, tiles_w);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
