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
// here. The kernels below are implicit GEMMs (M = output pixels, N =
// output channels, K = 9 taps x input channels), one launch per chain
// step, with f32 accumulation and the epilogues fused. The C entry runs
// the design the caller names (ops/conv_chain.conv3x3_path plans it from
// the shape) and refuses one the shape does not fit.
//
// The weights of both bf16 designs are packed once per model
// (ops/conv_chain.pack_weights) into (ceil(Cin/16), 9, Cout, 16): one K
// chunk of 16 input channels is 9 contiguous runs of Cout 32-byte rows.
// With the two 16-byte halves of each row swapped where bit 2 of the row
// index is set (as mma.sync's staging writes them, and as a TMA box with
// the 32-byte swizzle lands), those rows are byte for byte wgmma's K-major
// B operand with the 32-byte swizzle, so neither design transposes weights.
//
// bf16, large steps ("wgmma": Cin a multiple of 16, Cout of 64 up to 256;
// the plan sends the GMFSS nets' 64-256-channel steps at 544x960 and
// 272x480, and RIFE's 64-channel step, whose weights fit resident). What
// bounds them on this card: the tensor cores at Cin 128 and Cout 256
// (0.12-0.47 ms at 989 TFLOP/s), memory at 64 -> 64 (0.18 ms for an L0
// step's 600 MB). What held the mma.sync design back there: each of its
// 12 240 blocks staged the whole weight tensor again (more bytes from L2
// than the step's activations), Cout above 128 restaged each patch, and
// 16-channel chunks gave short K loops with a prologue and drain a block.
// The design:
//  * persistent blocks, one an SM, each two pairs of (producer warp,
//    consumer warpgroup) with a ring of stages a pair; a pair walks its
//    own tiles of MT rows x 64 columns, so one pair's epilogue overlaps the
//    other's wgmmas;
//  * the block keeps its NB output channels' weights (all K) in shared
//    memory for its life: NB = 128 where those fit (<= 144 KB: Cin 64),
//    else 64; Cout splits into Cout / NB groups of blocks, each group
//    restaging only the patches (Cout 256: two groups, where mma.sync
//    restaged every patch three times). Where even 64 channels do not fit
//    (Cin > 128), the weights stream with each K chunk (slower than
//    mma.sync at GridNet's 256 -> 128 head, so the plan keeps it there);
//  * one producer lane loads each 16-channel K chunk's patch by TMA: two
//    boxes of 8 channels x 66 x (MT + 2) pixels, zero outside the frame
//    (the pad-1 border for free), completing the stage's mbarrier. The
//    loader is a handful of instructions a chunk, where per-thread
//    cp.async copies with their addressing and mbarrier arrivals measured
//    slower than the wgmmas they fed;
//  * A from shared memory with no swizzle: pixels of 16 bytes in a row of
//    the patch, the chunk's two 8-channel halves a box apart, so the
//    tap's shift is only the descriptor's start (16 bytes a pixel); B the
//    resident (or staged) rows above. 9 taps x MT wgmma m64nNBk16 a chunk,
//    one chunk's group in flight while the next is issued;
//  * the pre-PReLU runs on the landed patch in place, bf16 pairs at a
//    time (the product rounded as prelu<bf16>), behind one barrier of the
//    warpgroup's 128 threads;
//  * the epilogue works on the accumulator layout: each lane rounds, adds
//    and stores bf16 pairs of its channels (bias and beta read once a
//    block; res loaded while the last chunk's wgmmas run).
//
// bf16, small and narrow steps ("mma": RIFE's deep ResConvs, Cin 9/12/14,
// Cout 2, GridNet's 256 -> 128 head): tensor cores through mma.sync
// m16n8k16 fed by ldmatrix. What bounds it on this card: the deep narrow
// steps (c = 192 and 128 at 1/16 and 1/8: 1530 and 6120 pixels at N = 3,
// K up to 1728) by latency, since even split into 64-pixel x 32-channel
// blocks their grid holds ~3 warps an SM, each waiting on its own ldmatrix
// -> mma chain (split-K over warps is the next step). The design:
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
//    padding stays exact);
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
// Why two designs: wgmma's 64-row warpgroup tiles and resident weights
// need enough 64-column tiles to fill 132 SMs twice and Cout in blocks of
// 64; the deep narrow steps have neither (6120 pixels, Cout 192 = 3 x 64
// but too few tiles), and odd widths cannot be TMA boxes of 16 bytes.
//
// f32 (--fp32, every step: "tf32"): the tensor cores in 3xTF32 on mma.sync
// m16n8k8 (csrc/tf32.cuh; why mma.sync and not wgmma is said there, and
// the conv adds one more reason: the split weights of a 64 -> 64 step take
// 295 KB, so no block keeps them resident). What bounds it on this card:
// mma.sync's TF32 rate over three products per f32 product (GridNet's L0
// step, 116 GFLOP f32, is 0.70 ms at the 3xTF32 bound, 1.18 ms at
// mma.sync's 295 TFLOP/s), then the splits' ALU work and the weight
// fragments every block stages again from L2. The design, the bf16
// mma.sync kernel's with f32 operands:
//  * a block covers 8 output rows x 32 columns x 64 output channels (Cout
//    <= 8: 8 channels; steps too small to fill the SMs: 4 or 2 rows, 32
//    channels); each warp 4 m16 tiles (2 rows x 2 halves of 16 columns) x
//    4 n8 tiles, 64 accumulators a thread;
//  * K chunks of 8 input channels (one k8 step; Cin 9/12/14 zero-padded
//    to a multiple of 8 in the patch and the packed weights): the
//    (rows + 2) x 34 x 8-channel patch (32 bytes a pixel) and the chunk's
//    9 taps of B fragments, copied by cp.async into a two-stage ring;
//    Cin that is no multiple of 4 is staged by plain loads;
//  * the weights are split on the host once per model and packed in
//    fragment order (ops/conv_chain.pack_weights_tf32: per chunk, tap,
//    n8 tile and lane, (hi b0, hi b1, lo b0, lo b1) with k relabelled
//    within each 8), so a B fragment is one 16-byte shared load;
//  * k relabelled within each 8 (tf32.cuh): lane (g, t4) reads channels
//    2 t4 and 2 t4 + 1 of its pixel, one float2, and 16 lanes read 4
//    neighbouring pixels' 128 contiguous bytes: no bank conflict and no
//    swizzle. A tap's shift is only another pixel offset;
//  * the pre-PReLU runs in place on each landed patch; the patch is split
//    into hi and lo in registers as each A fragment is loaded, 9 times an
//    element (once a tap): splitting it once into hi and lo planes in
//    shared memory, behind one more barrier a chunk, measured 1.25-1.54x
//    slower on the H100 (twice the shared loads for A);
//  * the epilogue works on the accumulator layout, channel pairs a lane.
// The f32 FMA design it replaced (an 8 x 32-pixel x 32-channel tile on the
// FMA pipes) ran GMFSS's steps at 0.84-1.41x cuDNN in f32.
//
// Rounding follows the plain PyTorch chain in the storage dtype T: the
// pre-PReLU's product is rounded to T; the conv output with its bias is
// rounded to T, then y * beta, + x and the leaky product are each rounded
// to T, and so is + res, as separate eager ops would.

#include <cuda.h>

#include <atomic>
#include <mutex>

#include "common.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kCK = 16;  // bf16: input channels per shared-memory chunk

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

// ------------------------------------------- bf16: wgmma, persistent blocks

constexpr int kWCols = 64;                    // output columns of a tile row: one m64
constexpr int kWPatchW = kWCols + 2;          // patch columns
constexpr int kWThreads = 320;                // 2 consumer warpgroups + 2 producer warps
constexpr int kWMaxResident = 9 * 128 * 64 * 2;  // the most weight bytes a block keeps
constexpr int kWSmemLimit = 232448;           // shared memory a block may use
constexpr int kWMaxStages = 8;

// NB output channels a block, MT output rows (one m64 tile each) a
// warpgroup tile, weights resident (RES) or streamed with each K chunk
template <int NB, int MT, bool RES>
struct WgCfg {
  static constexpr int kBox = (MT + 2) * kWPatchW * 16;  // one 8-channel half of a patch
  static constexpr int kHalf = (kBox + 127) / 128 * 128;  // its stride: TMA writes 128-aligned
  static constexpr int kWChunk = 9 * NB * 32;             // a 16-channel K chunk's weights
  static constexpr int kStage = (((RES ? 0 : kWChunk) + 2 * kHalf) + 255) / 256 * 256;
  static int stages(int cin) {  // ring stages per warpgroup that fit beside the weights
    const int fixed = 1024 + (RES ? (cin / 16) * kWChunk : 0) + 64 * 8;
    const int s = (kWSmemLimit - fixed) / (2 * kStage);
    return s < kWMaxStages ? s : kWMaxStages;
  }
  static int smem(int cin, int stages) {
    return 1024 + (RES ? (cin / 16) * kWChunk : 0) + 2 * stages * kStage + (4 * stages + 1) * 8;
  }
};

// one box of a 4-d tensor map into shared memory, signalled on `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// two bf16 values as one 32-bit word (lo in the low half)
__device__ __forceinline__ uint32_t bf16x2_bits(drba::bf16 lo, drba::bf16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 bf16x2_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// both values rounded to bf16 and back
__device__ __forceinline__ float2 round2(float2 v) {
  return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
}
// prelu of two bf16 values with the slope pair alpha2: the product rounded
// to bf16 (bf16x2 multiply, exact before its one rounding) where a value is
// below zero (sign set, magnitude non-zero), the value itself elsewhere, as
// prelu<bf16> (NaN stays NaN)
__device__ __forceinline__ uint32_t prelu2(uint32_t v, uint32_t alpha2) {
  const __nv_bfloat162 prod = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                      *reinterpret_cast<const __nv_bfloat162*>(&alpha2));
  const uint32_t nz = ((v & 0x7fff7fffu) + 0x7fff7fffu) & 0x80008000u;  // magnitude > 0
  const uint32_t m = ((v & nz) >> 15) * 0xffffu;                         // negative halves
  return (*reinterpret_cast<const uint32_t*>(&prod) & m) | (v & ~m);
}
// the pre-PReLU in place on `bytes` (a multiple of 16) of a staged patch,
// by the 128 threads of a warpgroup
__device__ __forceinline__ void prelu_patch2(unsigned char* patch, int bytes, uint32_t alpha2,
                                             int tid) {
  for (int i = tid; i < bytes / 16; i += 128) {
    uint4 v = reinterpret_cast<uint4*>(patch)[i];
    v.x = prelu2(v.x, alpha2);
    v.y = prelu2(v.y, alpha2);
    v.z = prelu2(v.z, alpha2);
    v.w = prelu2(v.w, alpha2);
    reinterpret_cast<uint4*>(patch)[i] = v;
  }
}

// Persistent, warp-specialised: warps 0-7 are two consumer warpgroups,
// warps 8 and 9 their producers. Pair p (producer warp p, warpgroup p)
// walks the tiles blockIdx.x * 2 + p, + 2 * gridDim.x, ... of output
// channel block blockIdx.y; a tile is MT rows x 64 columns of one image.
// One lane of the producer loads each 16-channel K chunk's patch (two TMA
// boxes of 8 channels x 66 x (MT + 2) pixels, zero outside the frame) and,
// streamed, the chunk's weights (one box, 32-byte swizzle) into its pair's
// ring; the stage's full mbarrier completes when their bytes land. The
// warpgroup runs the 9 taps x MT wgmma m64nNBk16 on it (A: the patch at the
// tap's shifted start, B: the weights), keeps one chunk's wgmmas in flight
// and frees the stage before it when they are done. Resident weights are
// loaded once and signalled on their own mbarrier.
template <int NB, int MT, bool RES>
__global__ void __launch_bounds__(kWThreads, 1)
conv3x3_wgmma_kernel(const ConvArgs a, const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw, int n, int bands, int stages) {
  using C = WgCfg<NB, MT, RES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const int nch = a.cin / 16;
  const uint32_t wres = base;  // resident weights (chunk, tap, NB rows of 32 bytes)
  const uint32_t ring = base + (RES ? nch * C::kWChunk : 0);
  const uint32_t bars = ring + 2 * stages * C::kStage;
  const uint32_t wbar = bars + 4 * stages * 8;  // the resident weights have landed
  // full / empty mbarrier of stage s of pair p
  auto full = [&](int p, int s) { return bars + (p * stages + s) * 8; };
  auto empty = [&](int p, int s) { return bars + ((2 + p) * stages + s) * 8; };
  auto stage_at = [&](int p, int s) { return ring + (p * stages + s) * C::kStage; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int p = 0; p < 2; ++p)
      for (int s = 0; s < stages; ++s) {
        drba::mbar_init(full(p, s), 1);   // the producer's expect_tx
        drba::mbar_init(empty(p, s), 4);  // one lane of each of the warpgroup's warps
      }
    drba::mbar_init(wbar, 1);
    drba::mbar_fence_init();
  }
  __syncthreads();

  const int co0 = blockIdx.y * NB;
  const int tiles = n * bands * a.tiles_w;  // < 2^31: the host checks
  const int step = 2 * gridDim.x;

  if (warp >= 8) {  // ------------------------------------------- producers
    const int p = warp - 8;
    if (lane != 0) return;
    if (RES && p == 0) {  // the block's weights, once: (chunk, tap, NB rows)
      drba::mbar_expect_tx(wbar, nch * C::kWChunk);
      for (int c = 0; c < nch; ++c) tma_load4(wres + c * C::kWChunk, &tw, wbar, 0, co0, 0, c);
    }
    int k = 0;
    for (int t = blockIdx.x * 2 + p; t < tiles; t += step) {
      const int cb = t % a.tiles_w, rest = t / a.tiles_w;
      const int band = rest % bands, nb = rest / bands;
      const int ty0 = band * MT, tx0 = cb * kWCols;
      for (int c = 0; c < nch; ++c, ++k) {
        const int s = k % stages;
        drba::mbar_wait(empty(p, s), ((k / stages) & 1) ^ 1);
        const uint32_t st = stage_at(p, s), bar = full(p, s);
        drba::mbar_expect_tx(bar, 2 * C::kBox + (RES ? 0 : C::kWChunk));
        if (!RES) tma_load4(st, &tw, bar, 0, co0, 0, c);
        const uint32_t patch = st + (RES ? 0 : C::kWChunk);
        tma_load4(patch, &tx, bar, c * 16, tx0 - 1, ty0 - 1, nb);
        tma_load4(patch + C::kHalf, &tx, bar, c * 16 + 8, tx0 - 1, ty0 - 1, nb);
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  const int p = warp >> 2, wtid = tid & 127, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t alpha2 = a.alpha != nullptr ? bf16x2_bits(*a.alpha, *a.alpha) : 0u;
  // this lane's output channels: co0 + 8 j + 2 t4, + 1 of each n8 tile j;
  // their bias and ResConv beta as bf16 pairs, read once
  uint32_t bias[NB / 8], beta[NB / 8];
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int co = co0 + 8 * j + 2 * t4;
    bias[j] = bf16x2_bits(a.bias[co], a.bias[co + 1]);
    beta[j] = a.beta != nullptr ? bf16x2_bits(a.beta[co], a.beta[co + 1]) : 0u;
  }
  if (RES) drba::mbar_wait(wbar, 0);
  int s = 0;         // ring stage of the next chunk
  uint32_t ph = 0;   // and the parity of its fill
  for (int t = blockIdx.x * 2 + p; t < tiles; t += step) {
    const int cb = t % a.tiles_w, rest = t / a.tiles_w;
    const int band = rest % bands, nb = rest / bands;
    const int ty0 = band * MT, tx0 = cb * kWCols;

    float acc[MT][NB / 2];
    int prev = 0;
    for (int c = 0; c < nch; ++c) {
      drba::mbar_wait(full(p, s), ph);
      const uint32_t st = stage_at(p, s);
      const uint32_t patch = st + (RES ? 0 : C::kWChunk);
      if (a.alpha != nullptr) {  // activate the landed patch in place
        for (int h = 0; h < 2; ++h)
          prelu_patch2(sbase + (patch - base) + h * C::kHalf, C::kBox, alpha2, wtid);
        drba::fence_async_smem();
        drba::named_bar_sync(1 + p, 128);
      }
      // A: 64 patch pixels from the tap's shifted start (16 bytes a pixel,
      // the channel halves kHalf apart); B: the tap's NB x 32-byte rows
      const uint64_t da = drba::gmma_desc(patch, C::kHalf, 128, drba::kNoSwizzle);
      const uint64_t db =
          drba::gmma_desc(RES ? wres + c * C::kWChunk : st, 16, 256, drba::kSwizzle32);
#pragma unroll
      for (int r = 0; r < MT; ++r) drba::fence_regs(acc[r]);
      drba::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          // descriptors hold addresses in 16-byte units in their low bits
          const uint64_t dat = da + ((r + dy) * kWPatchW + dx);
          const uint64_t dbt = db + tap * NB * 2;
          if constexpr (NB == 64)
            drba::wgmma_m64n64_ss<0>(acc[r], dat, dbt, c > 0 || tap > 0);
          else
            drba::wgmma_m64n128_ss<0>(acc[r], dat, dbt, c > 0 || tap > 0);
        }
      }
      drba::wgmma_commit();
      drba::wgmma_wait<1>();  // chunk c - 1's products are done: free its stage
      if (c > 0 && lane == 0) drba::mbar_arrive(empty(p, prev));
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    // the epilogue, from the accumulator layout (wgmma.cuh): lane (g, t4)
    // of warp wq holds pixels 16 wq + g and + 8 of each row, channels 8 j +
    // 2 t4, + 1 of each n8 tile j, stored as bf16 pairs. res is loaded
    // while the last chunk's products run.
    uint32_t rv[MT][2][NB / 8];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int oy = ty0 + r, ox = tx0 + 16 * wq + g + 8 * hh;
        const long long pix = (static_cast<long long>(nb) * a.h + oy) * a.w + ox;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          rv[r][hh][j] = 0u;
          if (a.res != nullptr && oy < a.h && ox < a.w)
            rv[r][hh][j] = *reinterpret_cast<const uint32_t*>(a.res + pix * a.cout + co0 +
                                                              8 * j + 2 * t4);
        }
      }
    drba::wgmma_wait<0>();
    if (lane == 0) drba::mbar_arrive(empty(p, prev));
#pragma unroll
    for (int r = 0; r < MT; ++r) drba::fence_regs(acc[r]);
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int oy = ty0 + r, ox = tx0 + 16 * wq + g + 8 * hh;
        if (oy >= a.h || ox >= a.w) continue;
        const long long pix = (static_cast<long long>(nb) * a.h + oy) * a.w + ox;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int co = co0 + 8 * j + 2 * t4;
          const float2 b2 = bf16x2_f2(bias[j]);
          float2 y = round2(make_float2(acc[r][4 * j + 2 * hh] + b2.x,
                                        acc[r][4 * j + 2 * hh + 1] + b2.y));
          if (a.beta != nullptr) {  // ResConv: cin == cout, x at the same channels
            const float2 xv =
                bf16x2_f2(*reinterpret_cast<const uint32_t*>(a.x + pix * a.cin + co));
            const float2 be = bf16x2_f2(beta[j]);
            const float2 tb = round2(make_float2(y.x * be.x, y.y * be.y));
            const float2 u = round2(make_float2(tb.x + xv.x, tb.y + xv.y));
            const float2 lk = round2(make_float2(u.x * 0.2f, u.y * 0.2f));
            y = make_float2(u.x >= 0.f ? u.x : lk.x, u.y >= 0.f ? u.y : lk.y);
          }
          if (a.res != nullptr) {
            const float2 rf = bf16x2_f2(rv[r][hh][j]);
            y = round2(make_float2(y.x + rf.x, y.y + rf.y));
          }
          *reinterpret_cast<__nv_bfloat162*>(a.out + pix * a.cout + co) =
              __floats2bfloat162_rn(y.x, y.y);
        }
      }
  }
}

// cuTensorMapEncodeTiled, found once through the runtime's entry-point
// query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// a bf16 4-d tensor map, dims and box innermost first, strides in bytes of dims 1-3
bool tensor_map(CUtensorMap* m, const void* ptr, const cuuint64_t (&dims)[4],
                const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB, int MT, bool RES>
int launch_wgmma(ConvArgs a, int n, int dev, cudaStream_t s) {
  using C = WgCfg<NB, MT, RES>;
  auto kernel = conv3x3_wgmma_kernel<NB, MT, RES>;
  static std::atomic<bool> smem_set[kMaxDevices] = {};
  if (dev >= kMaxDevices || !smem_set[dev]) {  // as launch_mma: the most any shape needs
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const int stages = C::stages(a.cin);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  a.tiles_w = static_cast<int>(drba::cdiv(a.w, kWCols));
  const int bands = static_cast<int>(drba::cdiv(a.h, MT));
  const int cblocks = a.cout / NB;
  const long long tiles = static_cast<long long>(n) * bands * a.tiles_w;
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // x (n, h, w, cin): boxes of 8 channels x 66 x (MT + 2) pixels of one
  // image; the packed weights (cin / 16, 9, cout, 16): a chunk's 9 x NB rows
  CUtensorMap tx, tw;
  const cuuint64_t row = 2ull * a.cin;
  if (!tensor_map(&tx, a.x, {static_cast<cuuint64_t>(a.cin), static_cast<cuuint64_t>(a.w),
                             static_cast<cuuint64_t>(a.h), static_cast<cuuint64_t>(n)},
                  {row, row * a.w, row * a.w * a.h}, {8, kWPatchW, MT + 2, 1},
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&tw, a.wp, {16, static_cast<cuuint64_t>(a.cout), 9,
                              static_cast<cuuint64_t>(a.cin / 16)},
                  {32, 32ull * a.cout, 288ull * a.cout}, {16, NB, 9, 1},
                  CU_TENSOR_MAP_SWIZZLE_32B))
    return static_cast<int>(cudaErrorInvalidValue);
  long long gx = (sms + cblocks - 1) / cblocks;
  if (gx > (tiles + 1) / 2) gx = (tiles + 1) / 2;
  const dim3 grid(static_cast<unsigned>(gx), cblocks);
  kernel<<<grid, kWThreads, C::smem(a.cin, stages), s>>>(a, tx, tw, n, bands, stages);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma design's shape rules: bf16 with 16-byte rows (vec_in,
// vec_out), Cin a multiple of 16, Cout a multiple of 64 up to 256. Output
// channels a block: 128 where those weights fit resident, else 64 where
// they do, else 128 (or 64) streamed with each K chunk.
int conv3x3_wgmma(const ConvArgs& a, int n, cudaStream_t s) {
  if (!a.vec_in || !a.vec_out || a.cin % 16 != 0 || a.cout % 64 != 0 || a.cout > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  const long long wbytes = 9ll * a.cin * 2;  // per output channel
  if (a.cout % 128 == 0 && wbytes * 128 <= kWMaxResident)
    return launch_wgmma<128, 1, true>(a, n, dev, s);
  if (wbytes * 64 <= kWMaxResident) return launch_wgmma<64, 2, true>(a, n, dev, s);
  if (a.cout % 128 == 0) return launch_wgmma<128, 1, false>(a, n, dev, s);
  return launch_wgmma<64, 2, false>(a, n, dev, s);
}

// ------------------------------------------------- f32: 3xTF32 on mma.sync m16n8k8

constexpr int kFCols = 32;             // output columns of an f32 tile: two m16 tiles
constexpr int kFPatchW = kFCols + 2;   // patch columns
constexpr int kFChunk = 8;             // input channels a K chunk: one k8 step, 32 bytes a pixel

// WM x WN warps; each warp MT m16 tiles (MT / 2 output rows x the tile's 32
// columns) x NT n8 tiles: the block covers WM * MT / 2 rows x 32 columns and
// NB = 8 * NT * WN output channels
template <int WM, int WN, int MT, int NT>
struct Tf32Cfg {
  static_assert(MT % 2 == 0, "a warp's m16 tiles cover both 16-column halves of its rows");
  static constexpr int kThreads = 32 * WM * WN;
  // 8 x 32 x 64 tiles: two blocks an SM (<= 128 registers a thread:
  // faster on the H100 than one block with 204); the smaller plans run
  // where the grid does not fill the SMs, so registers matter and
  // occupancy does not (up to 255: faster)
  static constexpr int kMinBlocks = kThreads == 256 ? 2 : 1;
  static constexpr int kTH = WM * MT / 2;            // output rows a block
  static constexpr int kNB = 8 * NT * WN;
  static constexpr int kPatchPix = (kTH + 2) * kFPatchW;
  static constexpr int kPatchFloats = kPatchPix * kFChunk;
  static constexpr int kWFrags = 9 * (kNB / 8) * 32;  // float4 B fragments a chunk
  static constexpr int kStageBytes = kPatchFloats * 4 + kWFrags * 16;
  static constexpr int kStages = 2;
  static constexpr int kSmem = kStages * kStageBytes;
};

struct Tf32Args {
  const float* x;      // (n, h, w, cin)
  const float4* wp;    // packed split (ceil(cin / 8), 9, ceil(cout / 8), 32 lanes, float4)
  const float* bias;   // (cout,)
  const float* beta;   // (cout,) or nullptr
  const float* alpha;  // the pre-PReLU's scalar slope, or nullptr
  const float* res;    // (n, h, w, cout) added last, or nullptr
  float* out;          // (n, h, w, cout)
  int h, w, cin, cout, tiles_w, ntiles;  // ntiles = ceil(cout / 8)
  bool vec_in;   // cin % 4 == 0 and x 16-byte aligned: cp.async of 4 channels
  bool vec_out;  // cout % 2 == 0 and x, res, out 8-byte aligned: channel pairs
};

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(Tf32Cfg<WM, WN, MT, NT>::kThreads,
                                  Tf32Cfg<WM, WN, MT, NT>::kMinBlocks)
conv3x3_tf32_kernel(const Tf32Args a) {
  using C = Tf32Cfg<WM, WN, MT, NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int nb = blockIdx.z;
  const int co0 = blockIdx.y * C::kNB;
  const int ty0 = (blockIdx.x / a.tiles_w) * C::kTH;
  const int tx0 = (blockIdx.x % a.tiles_w) * kFCols;
  const float* xn = a.x + static_cast<long long>(nb) * a.h * a.w * a.cin;
  const uint32_t s0 = smem_u32(smem);
  const float alpha = a.alpha != nullptr ? *a.alpha : 0.f;

  // K chunk c (input channels 8 c .. 8 c + 7) into ring stage `st`: the
  // (rows + 2) x 34-pixel patch, 32 bytes a pixel (zero outside the frame
  // and past cin), then the chunk's B fragments, tap-major runs of the
  // block's NB / 8 n8 tiles x 32 lanes x 16 bytes (zero past cout)
  auto stage = [&](int c, int st) {
    const int ci0 = c * kFChunk;
    const uint32_t patch = s0 + st * C::kStageBytes;
    for (int i = tid; i < C::kPatchPix * 2; i += C::kThreads) {
      const int half = i & 1, pix = i >> 1;
      const int r = pix / kFPatchW, col = pix - r * kFPatchW;
      const int gy = ty0 - 1 + r, gx = tx0 - 1 + col;
      const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      const int ci = ci0 + 4 * half;
      const long long src = (static_cast<long long>(gy) * a.w + gx) * a.cin + ci;
      if (a.vec_in) {
        const bool valid = inside && ci < a.cin;
        cp_async16(patch + pix * 32 + half * 16, valid ? xn + src : xn, valid);
      } else {
        float* dst = reinterpret_cast<float*>(smem + st * C::kStageBytes + pix * 32 + half * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = inside && ci + e < a.cin ? xn[src + e] : 0.f;
      }
    }
    const uint32_t wsm = patch + C::kPatchFloats * 4;
    const float4* wk = a.wp + static_cast<long long>(c) * 9 * a.ntiles * 32;
    for (int i = tid; i < C::kWFrags; i += C::kThreads) {
      const int ln = i & 31, rest = i >> 5;
      const int tap = rest / (C::kNB / 8), nt = co0 / 8 + rest - tap * (C::kNB / 8);
      const bool valid = nt < a.ntiles;
      cp_async16(wsm + i * 16, valid ? wk + (static_cast<long long>(tap) * a.ntiles + nt) * 32 + ln
                                     : a.wp,
                 valid);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nch = (a.cin + kFChunk - 1) / kFChunk;
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nch) stage(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<C::kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();                  // ... everyone's, and stage (c - 1) is free
    const int nx = c + C::kStages - 1;
    if (nx < nch) stage(nx, nx % C::kStages);
    cp_async_commit();

    float* patch = reinterpret_cast<float*>(smem + (c % C::kStages) * C::kStageBytes);
    if (a.alpha != nullptr) {  // chunk c's patch is complete: activate it in place
      for (int i = tid; i < C::kPatchFloats / 4; i += C::kThreads) {  // prelu(0) = 0
        float4 v = reinterpret_cast<float4*>(patch)[i];
        v.x = prelu<float>(v.x, alpha);
        v.y = prelu<float>(v.y, alpha);
        v.z = prelu<float>(v.z, alpha);
        v.w = prelu<float>(v.w, alpha);
        reinterpret_cast<float4*>(patch)[i] = v;
      }
      __syncthreads();
    }
    const float4* wsm = reinterpret_cast<const float4*>(patch + C::kPatchFloats);
    // a tap row at a time: the nine taps unrolled spilled 140 bytes a
    // thread at 128 registers and ran ~6% slower on the H100
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      float4 bf[NT];  // this lane's (hi b0, hi b1, lo b0, lo b1) of each n8 tile
#pragma unroll
      for (int j = 0; j < NT; ++j) bf[j] = wsm[(tap * (C::kNB / 8) + wn * NT + j) * 32 + lane];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // m16 tile i: row wm * MT / 2 + i / 2 of the block, columns 16 (i % 2)
        // .. + 15; lane (g, t4) reads channels 2 t4, 2 t4 + 1 (k t4 and t4 + 4,
        // relabelled) of pixels g and g + 8, at the tap's shift
        const int off = (((wm * MT / 2 + i / 2 + dy) * kFPatchW) + 16 * (i % 2) + g + dx) *
                            kFChunk + 2 * t4;
        const drba::FragA fa(*reinterpret_cast<const float2*>(patch + off),
                             *reinterpret_cast<const float2*>(patch + off + 8 * kFChunk));
#pragma unroll
        for (int j = 0; j < NT; ++j) drba::mma_3xtf32(acc[i][j], fa, bf[j]);
      }
    }
  }

  // epilogue from the registers: lane (g, t4) holds pixels g and g + 8 of
  // each m16 tile, channels 2 t4, 2 t4 + 1 of each n8 tile. f32 as the
  // plain chain computes it, one rounding an op: bias, y * beta, + x,
  // leaky, + res (the _rn intrinsics keep the compiler from fusing them)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int co = co0 + 8 * (wn * NT + j) + 2 * t4;
    if (co >= a.cout) continue;
    const bool two = co + 1 < a.cout;
    const float2 b2 = make_float2(a.bias[co], two ? a.bias[co + 1] : 0.f);
    const float2 be = a.beta != nullptr ? make_float2(a.beta[co], two ? a.beta[co + 1] : 0.f)
                                        : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int oy = ty0 + wm * MT / 2 + i / 2;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ox = tx0 + 16 * (i % 2) + g + 8 * hh;
        if (oy >= a.h || ox >= a.w) continue;
        const long long pix = (static_cast<long long>(nb) * a.h + oy) * a.w + ox;
        float y[2] = {__fadd_rn(acc[i][j][2 * hh], b2.x), __fadd_rn(acc[i][j][2 * hh + 1], b2.y)};
        const bool pair = two && a.vec_out;
        if (a.beta != nullptr) {  // ResConv: cin == cout, the residual is this conv's input
          float xv[2];
          if (pair) {
            const float2 v = *reinterpret_cast<const float2*>(a.x + pix * a.cin + co);
            xv[0] = v.x;
            xv[1] = v.y;
          } else {
            xv[0] = a.x[pix * a.cin + co];
            xv[1] = two ? a.x[pix * a.cin + co + 1] : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float u = __fadd_rn(__fmul_rn(y[e], e ? be.y : be.x), xv[e]);
            y[e] = u >= 0.f ? u : __fmul_rn(u, 0.2f);
          }
        }
        if (a.res != nullptr) {
          if (pair) {
            const float2 v = *reinterpret_cast<const float2*>(a.res + pix * a.cout + co);
            y[0] = __fadd_rn(y[0], v.x);
            y[1] = __fadd_rn(y[1], v.y);
          } else {
            y[0] = __fadd_rn(y[0], a.res[pix * a.cout + co]);
            if (two) y[1] = __fadd_rn(y[1], a.res[pix * a.cout + co + 1]);
          }
        }
        if (pair) {
          *reinterpret_cast<float2*>(a.out + pix * a.cout + co) = make_float2(y[0], y[1]);
        } else {
          a.out[pix * a.cout + co] = y[0];
          if (two) a.out[pix * a.cout + co + 1] = y[1];
        }
      }
    }
  }
}

template <int WM, int WN, int MT, int NT>
int launch_tf32(const Tf32Args& a, int n, int dev, cudaStream_t s) {
  using C = Tf32Cfg<WM, WN, MT, NT>;
  auto kernel = conv3x3_tf32_kernel<WM, WN, MT, NT>;
  static std::atomic<bool> smem_set[kMaxDevices] = {};  // as launch_mma
  if (dev >= kMaxDevices || !smem_set[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const dim3 grid(drba::cdiv(a.h, C::kTH) * a.tiles_w, drba::cdiv(a.cout, C::kNB), n);
  kernel<<<grid, C::kThreads, C::kSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The f32 tile plans: Cout <= 8 (MetricNet's 2) one n8 tile a block over
// 8 x 32 pixels; else 8 x 32 pixels x 64 channels, then, while the grid has
// fewer blocks than SMs, 4 rows, 32 channels, 2 rows (IFNet's deep steps)
int conv3x3_tf32(Tf32Args a, int n, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  a.tiles_w = static_cast<int>(drba::cdiv(a.w, kFCols));
  a.ntiles = static_cast<int>(drba::cdiv(a.cout, 8));
  auto fills = [&](int rows, int nb) {
    return static_cast<long long>(drba::cdiv(a.h, rows)) * a.tiles_w * drba::cdiv(a.cout, nb) *
               n >= sms;
  };
  if (a.cout <= 8) return launch_tf32<4, 1, 4, 1>(a, n, dev, s);
  if (fills(8, 64)) return launch_tf32<4, 2, 4, 4>(a, n, dev, s);
  if (fills(4, 64)) return launch_tf32<2, 2, 4, 4>(a, n, dev, s);
  if (fills(4, 32)) return launch_tf32<2, 1, 4, 4>(a, n, dev, s);
  return launch_tf32<1, 1, 4, 4>(a, n, dev, s);
}

}  // namespace

// x (n,h,w,cin), bias (cout,), beta (cout,) or NULL, alpha (1,) or NULL,
// res (n,h,w,cout) or NULL, out (n,h,w,cout); all in one dtype (f32|bf16),
// contiguous. The weights packed once per model, 16-byte aligned: bf16 by
// ops/conv_chain.pack_weights, wp (ceil(cin/16), 9, cout, 16); f32 split by
// ops/conv_chain.pack_weights_tf32, wp (ceil(cin/8), 9, ceil(cout/8), 32,
// 4); wt (cout,cin,3,3) is not read. With beta, cin == cout and no alpha
// (checked by the caller). path (ops/conv_chain.conv3x3_path): 0 the f32
// 3xTF32 kernel, 1 the bf16 mma.sync kernel, 2 the bf16 wgmma kernel; a
// path that does not take the dtype, or whose shape rules the call fails,
// is refused (cudaErrorInvalidValue) and nothing runs. Returns
// cudaGetLastError().
extern "C" int drba_conv3x3(const void* x, const void* wt, const void* wp, const void* bias,
                            const void* beta, const void* alpha, const void* res, void* out,
                            int n, int h, int w, int cin, int cout, int dtype, int path,
                            void* stream) {
  (void)wt;
  const bool f32 = dtype == drba::kF32 && path == 0;
  const bool bf = dtype == drba::kBF16 && (path == 1 || path == 2);
  if (!f32 && !bf) return static_cast<int>(cudaErrorInvalidValue);
  if (wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(n) * h * w * cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (f32) {
    const auto al8 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
    const Tf32Args a{static_cast<const float*>(x), static_cast<const float4*>(wp),
                     static_cast<const float*>(bias), static_cast<const float*>(beta),
                     static_cast<const float*>(alpha), static_cast<const float*>(res),
                     static_cast<float*>(out), h, w, cin, cout, 0, 0,
                     cin % 4 == 0 && x16,
                     cout % 2 == 0 && al8(x) && al8(res) && al8(out)};
    return conv3x3_tf32(a, n, s);
  }
  using T = drba::bf16;
  const bool res16 = reinterpret_cast<uintptr_t>(res) % 16 == 0;  // NULL is aligned
  const ConvArgs a{static_cast<const T*>(x), static_cast<const T*>(wp),
                   static_cast<const T*>(bias), static_cast<const T*>(beta),
                   static_cast<const T*>(alpha), static_cast<const T*>(res),
                   static_cast<T*>(out), h, w, cin, cout, 0,
                   cin % 8 == 0 && x16,
                   cout % 8 == 0 && x16 && res16 && reinterpret_cast<uintptr_t>(out) % 16 == 0};
  return path == 2 ? conv3x3_wgmma(a, n, s) : conv3x3_bf16(a, n, s);
}
