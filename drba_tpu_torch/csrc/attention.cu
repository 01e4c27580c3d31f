// Window attention and flash attention with a narrow value, head width 128.
//
// Replaces three TPU kernels of drba_tpu/ops/attn_mxu.py:
//  * window_attention_mxu (:63, body _kernel :37) and window_attention_nhwc
//    (:281, body _nhwc_kernel :253): softmax(q k^T / sqrt(c), masked by
//    region id) v per window. The TPU kernels hold a whole (rows, Lpad) f32
//    score chunk in VMEM; here one block takes one (window, 128-query tile)
//    and walks the window's keys in 64-key tiles with an online softmax
//    (running max, sum and accumulator in f32). Windows are addressed by
//    token strides, so the same kernel reads an NHWC map in place (no
//    split/merge copies), the (B, L, c) layout, and the q|k|v columns of the
//    transformer layer's projection; keys and values may come from another
//    image of the batch (the cross-attention batch-half swap).
//  * flash_attention_mxu (:150, body _flash_kernel :110): the same key-tile
//    loop with a value of width 2 (pixel coordinates or flow), for GMFlow's
//    global correlation and flow propagation at L = 8160. The (B, L, L)
//    scores never leave the registers.
//
// A key is dead where it lies past L or, with labels, where its region id
// differs from the query's; dead keys get weight exactly 0 (the TPU
// kernels' -1e9 fill).
//
// Bound on this card at the GMFSS 1080p path shapes (989 TFLOP/s bf16 on
// tensor cores, 3.35 TB/s; softmax attention over L keys costs 4 L^2 c):
//  * scale 0, (2,68,120,128) k=2, L = 2040: 17.0 GFLOP -> 17.2 us; q, k, v
//    and out 16.7 MB -> 5 us: bound by the tensor cores;
//  * scale 1 inside the layer, (4,136,240,128) k=8, L = 510: 34.1 GFLOP ->
//    34.5 us; q|k|v and out 134 MB -> 40 us: bound by memory;
//  * flash (1,8160): q k^T 2 L^2 c = 17.0 GFLOP -> 17.2 us, and 66.6 M
//    exponentials on the SFUs (~16 us): tensor cores and SFUs together.
//
// What bounds a WMMA design of this loop, and what this one does about it.
// bf16 (the main path), one block = two consumer warpgroups of 64 query rows
// (128 rows) sharing each key/value tile:
//  * S = Q K^T is wgmma.m64n64k16 with Q and K in shared memory in the
//    128-byte-swizzled K-major layout and S in registers (32 f32 a thread),
//    not a WMMA fragment stored to shared memory and read back.
//  * The online softmax works on those registers. Each row of S lives in
//    one quad of four threads, so the row maximum takes two shfl_xor steps
//    per row and tile (was ten per row); the row sums stay per thread and
//    meet once, at the end. Scores are prescaled by log2(e)/sqrt(c) and
//    exponentiated with exp2f; full tiles without labels skip the masking.
//  * 128-wide value: P goes to bf16 in registers (the S accumulator layout
//    is the A-fragment layout) and O += P V is wgmma.m64n128k16 with A from
//    registers and V in shared memory as an MN-major B. O stays in registers
//    (64 f32 a thread) and is rescaled there; WMMA fragments have no
//    documented layout, so a WMMA kernel keeps O in shared memory and moves
//    it through every tile.
//  * 2-wide f32 value (flash): P V stays in f32 on the FMA pipes (the values
//    are pixel coordinates up to a few hundred, where a bf16 P would cost
//    about a pixel); each thread folds its own S elements against V[key]
//    from shared memory into per-row partial sums, reduced over the quad
//    once, at the end.
//  * K, V and the key labels stream through a 2-stage ring in shared memory
//    with cp.async (per-row addresses, so every layout and the ragged last
//    tile are covered; rows past L are zero-filled): tile j+1 arrives while
//    tile j is computed, instead of a load between two barriers. Token
//    addresses divide by the window width through a reciprocal.
//  * Enough work in flight: 128 registers a thread and 98 KB of shared
//    memory (flash: 96 and 67 KB) let two blocks, four warpgroups, share an
//    SM. The windows give 128 (scale 0) and 1024 (scale 1) blocks; flash
//    at B = 1 has only 64 query blocks, so the wrapper splits the keys over
//    up to 8 blocks each (flash-decoding): each writes its partial
//    (m, l, acc) to scratch and a second launch combines them.
// f32 (--fp32): the same block of 128 query rows and key loop, with S = Q K^T
// and the 128-wide P V on the tensor cores in 3xTF32 (tf32.cuh: mma.sync
// m16n8k8, each operand split into a TF32 hi and lo, three products each),
// which keeps the f32 parity with the plain version that one TF32 product
// would break. The f32 tiles are twice bf16's: Q (68 KB with its padding)
// and two K/V stages (2 x 67 KB) fill 203 KB, one block an SM of eight warps
// of 16 query rows. Bound at the 1080p scale-0 window, 3 x 17.0 GFLOP ->
// 103 us at 495 TFLOP/s TF32; mma.sync reaches a smaller share of that than
// wgmma, and the split costs two ALU operations per operand element loaded
// (K's and V's in every warp): see tf32.cuh for why not wgmma. Flash
// splits its keys as bf16 does.

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

using namespace drba;

constexpr int kC = 128;       // head width
constexpr int kQT = 64;       // queries per block
constexpr int kKT = 64;       // keys per tile
constexpr int kWG = 2;        // bf16 kernel: consumer warpgroups per block, 64 query rows each
constexpr int kWgThreadsAll = 128 * kWG;  // threads of either kernel
constexpr int kRowsWG = kQT * kWG;  // query rows per block (f32: eight warps of 16)
constexpr float kNegInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Geom {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* labels;  // or nullptr
  int b, h, w, kk, wh, ww, L;
  int q_stride, k_stride, v_stride, o_stride;  // elements between tokens
  int lab_win_stride, lab_b_stride;
  int half;  // keys/values of image i come from image (i + half) % b
  float scale;
  float inv_ww;  // 1 / ww
};

// Key split: block z walks key tiles [z * tiles, (z + 1) *
// tiles); with part set it writes its partial (m, l, acc0, acc1) per query
// row to part[z][row] instead of the output.
struct Split {
  float4* part;
  int tiles;
};

struct Window {
  int bq, bkv, wy, wx;
  const int* lab;  // this window's labels, or nullptr
};

__device__ __forceinline__ Window window_of(const Geom& g) {
  Window win;
  const int nwin = g.kk * g.kk;
  win.bq = blockIdx.x / nwin;
  const int wi = blockIdx.x % nwin;
  win.wy = wi / g.kk;
  win.wx = wi % g.kk;
  win.bkv = (win.bq + g.half) % g.b;
  win.lab = g.labels == nullptr ? nullptr
                                : g.labels + static_cast<long long>(wi) * g.lab_win_stride +
                                      static_cast<long long>(win.bq) * g.lab_b_stride;
  return win;
}

// global token index of window token i of image bb; i / ww through the
// reciprocal, exact for i < 2^21 (the host checks L)
__device__ __forceinline__ long long token(const Geom& g, const Window& win, int bb, int i) {
  const int ly = __float2int_rz((static_cast<float>(i) + 0.5f) * g.inv_ww);
  const int lx = i - ly * g.ww;
  return (static_cast<long long>(bb) * g.h + win.wy * g.wh + ly) * g.w + win.wx * g.ww + lx;
}

// --------------------------------------------------------------- bf16: wgmma

// A 64 x 128 bf16 tile is two 64 x 64 halves of 8 KB (channels [0, 64) and
// [64, 128)); each row of a half is 128 bytes whose 16-byte chunks are
// XOR-swizzled by (row % 8), the layout wgmma reads with 128-byte swizzle.
// Byte offset of 16-byte chunk cc (0..15) of row r:
__device__ __forceinline__ uint32_t sw128(int r, int cc) {
  return (cc >> 3) * 8192 + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
}

// K-major operand (Q as A, K as B): 8-row groups 1024 B apart; k-step kk of
// 16 channels starts 32 B further into the swizzle atom, or in the next half
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
}
// MN-major B (V, keys x channels with channels contiguous): 8-key groups
// 1024 B apart (SBO), the two 64-channel halves 8192 B apart (LBO); k-step t
// covers keys [16 t, 16 t + 16)
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int t) {
  return gmma_desc(tile + t * 2048, 8192, 1024);
}

// Shared memory of the bf16 kernel (offsets from a 1024-byte aligned base):
// Q (kWG tiles), K[2], V[2], key labels[2], query labels
template <int VW>
struct WgSmem {
  static constexpr int kTile = kQT * kC * 2;                // one swizzled bf16 tile
  static constexpr int kV = VW == kC ? kTile : kKT * 2 * 4;  // one value tile
  static constexpr int kQ = 0;                               // + warpgroup * kTile
  static constexpr int kK = kWG * kTile;                     // + stage * kTile
  static constexpr int kVal = kK + 2 * kTile;                // + stage * kV
  static constexpr int kKLab = kVal + 2 * kV;                // + stage * 256
  static constexpr int kQLab = kKLab + 2 * kKT * 4;
  static constexpr int kBytes = 1024 + kQLab + kRowsWG * 4;  // 1024: alignment slack
};

// rows [i0, i0 + 64 * tiles) of a window (128 bf16 channels each) into
// consecutive swizzled tiles by cp.async; rows past L are zero. Keys and
// values share their rows, so a second source (v, or nullptr) is loaded with
// the same token indices.
__device__ __forceinline__ void load_rows_async(uint32_t dst, const bf16* src, int stride,
                                                uint32_t dst2, const bf16* src2, int stride2,
                                                int tiles, const Geom& g, const Window& win,
                                                int bb, int i0) {
  const int cc = threadIdx.x & 15;
  for (int r = threadIdx.x >> 4; r < kQT * tiles; r += kWgThreadsAll / 16) {
    const bool ok = i0 + r < g.L;
    const long long t = ok ? token(g, win, bb, i0 + r) : 0;
    const uint32_t off = (r >> 6) * (kQT * kC * 2) + sw128(r & 63, cc);
    cp_async<16>(dst + off, src + t * stride + cc * 8, ok);
    if (src2 != nullptr) cp_async<16>(dst2 + off, src2 + t * stride2 + cc * 8, ok);
  }
}

// keys, values and key labels of the tile at key k0 into ring stage st
template <int VW>
__device__ __forceinline__ void load_kv_async(const Geom& g, const Window& win, uint32_t base,
                                              int st, int k0) {
  using SM = WgSmem<VW>;
  const bool wide = VW == kC;
  load_rows_async(base + SM::kK + st * SM::kTile, static_cast<const bf16*>(g.k), g.k_stride,
                  base + SM::kVal + st * SM::kV, wide ? static_cast<const bf16*>(g.v) : nullptr,
                  g.v_stride, 1, g, win, win.bkv, k0);
  const int t = threadIdx.x;
  if (!wide && t < kKT) {
    const float* v = static_cast<const float*>(g.v);
    const bool ok = k0 + t < g.L;
    cp_async<8>(base + SM::kVal + st * SM::kV + t * 8,
                v + (ok ? token(g, win, win.bkv, k0 + t) * g.v_stride : 0), ok);
  }
  if (g.labels != nullptr && t >= kWgThreadsAll - kKT) {
    const int j = t - (kWgThreadsAll - kKT);
    const bool ok = k0 + j < g.L;
    cp_async<4>(base + SM::kKLab + st * kKT * 4 + j * 4, win.lab + (ok ? k0 + j : 0), ok);
  }
}

// Online-softmax update of one 64-key tile on the S registers (log2 domain):
// rescale factors into corr, P into s, row maxima into m, per-thread row
// sums into l. kMasked: the tile is ragged or the keys carry labels.
template <bool kMasked>
__device__ __forceinline__ void softmax_regs(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2, int lim, int col,
                                             const int* klab, int ql0, int ql1) {
  float mx[2] = {kNegInit, kNegInit};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    if constexpr (kMasked) {
      const int j = 8 * (i >> 2) + col + (i & 1);
      const bool live = j < lim && (klab == nullptr || klab[j] == (h ? ql1 : ql0));
      s[i] = live ? s[i] * sl2 : kNegInit;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // unmasked: the raw maximum, scaled once (sl2 > 0)
    const float m_new = fmaxf(m[h], kMasked ? mx[h] : mx[h] * sl2);
    corr[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    if constexpr (kMasked)
      s[i] = s[i] == kNegInit ? 0.f : exp2f(s[i] - m[h]);  // dead keys: exactly 0
    else
      s[i] = exp2f(fmaf(s[i], sl2, -m[h]));
    l[h] += s[i];
  }
}

// One block: kWG consumer warpgroups, warpgroup w owning query rows
// [q0 + 64 w, q0 + 64 w + 64) of window blockIdx.x, q0 = blockIdx.y * 64 kWG,
// against key tiles [z * tiles, (z + 1) * tiles) of that window, z =
// blockIdx.z; the K/V ring is shared. Thread layout (wgmma accumulators):
// warp w of its warpgroup, lane = 4 * g4 + t4 holds rows r0 = 16 w + g4 and
// r1 = r0 + 8 of the warpgroup's tile; element i of an accumulator lies in
// column 8 (i / 4) + 2 t4 + (i % 2), row r1 if (i & 2) else r0.
template <int VW>
__global__ void __launch_bounds__(kWgThreadsAll) attn_wgmma_kernel(Geom g, Split sp) {
  using SM = WgSmem<VW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const int* qlab = reinterpret_cast<const int*>(smem + SM::kQLab);

  const Window win = window_of(g);
  const int q0 = blockIdx.y * kRowsWG;
  const int nkt = (g.L + kKT - 1) / kKT;
  const int kt0 = blockIdx.z * sp.tiles, kt1 = min(nkt, kt0 + sp.tiles);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int r0 = wg * kQT + ((tid >> 5) & 3) * 16 + (lane >> 2), col = 2 * (lane & 3);
  const uint32_t sQ = base + SM::kQ + wg * SM::kTile;

  load_rows_async(base + SM::kQ, static_cast<const bf16*>(g.q), g.q_stride, 0, nullptr, 0, kWG,
                  g, win, win.bq, q0);
  if (g.labels != nullptr && tid < kRowsWG) {
    const bool ok = q0 + tid < g.L;
    cp_async<4>(base + SM::kQLab + tid * 4, win.lab + (ok ? q0 + tid : 0), ok);
  }
  if (kt0 < kt1) load_kv_async<VW>(g, win, base, 0, kt0 * kKT);
  cp_async_commit();

  constexpr int kAcc = VW == kC ? 64 : 4;  // O, or the 2-wide sums of rows r0 and r1
  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  const float sl2 = g.scale * kLog2e;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) load_kv_async<VW>(g, win, base, st ^ 1, (kt + 1) * kKT);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) have landed
    fence_async_smem();
    __syncthreads();

    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      wgmma_m64n64_ss<0>(s, desc_kmajor(sQ, kk),
                         desc_kmajor(base + SM::kK + st * SM::kTile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int lim = g.L - kt * kKT;
    float corr[2];
    if (g.labels == nullptr && lim >= kKT) {
      softmax_regs<false>(s, m, l, corr, sl2, lim, col, nullptr, 0, 0);
    } else {
      const int* klab = g.labels == nullptr
                            ? nullptr
                            : reinterpret_cast<const int*>(smem + SM::kKLab + st * kKT * 4);
      softmax_regs<true>(s, m, l, corr, sl2, lim, col, klab, klab ? qlab[r0] : 0,
                         klab ? qlab[r0 + 8] : 0);
    }

    if constexpr (VW == kC) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
      uint32_t a[16];  // P in bf16, the A fragments of the four 16-key steps
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kKT / 16; ++t)
        wgmma_m64n128_rs<1>(o, a[4 * t], a[4 * t + 1], a[4 * t + 2], a[4 * t + 3],
                            desc_mnmajor(base + SM::kVal + st * SM::kV, t), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    } else {
      const float2* v2 = reinterpret_cast<const float2*>(smem + SM::kVal + st * SM::kV);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] *= corr[i >> 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const float2 vv = v2[8 * (i >> 2) + col + (i & 1)];
        o[2 * h] = fmaf(s[i], vv.x, o[2 * h]);
        o[2 * h + 1] = fmaf(s[i], vv.y, o[2 * h + 1]);
      }
    }
    __syncthreads();  // stage st is free for the load of tile kt + 2
  }
  cp_async_wait<0>();

  // row sums (and for the narrow value the row's P v) over the quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if constexpr (VW == kC) {
    // stage the bf16 output rows in the (now free) K/V ring, then store
    // 16-byte row chunks
    constexpr int kLdo = kC + 8;
    static_assert(kRowsWG * kLdo * 2 <= 4 * WgSmem<VW>::kTile, "output staging");
    bf16* so = reinterpret_cast<bf16*>(smem + SM::kK);
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = (i >> 1) & 1;
      *reinterpret_cast<uint32_t*>(so + (r0 + 8 * h) * kLdo + 8 * (i >> 2) + col) =
          pack_bf16(o[i] * inv[h], o[i + 1] * inv[h]);
    }
    __syncthreads();
    bf16* out = static_cast<bf16*>(g.out);
    for (int r = tid >> 4; r < kRowsWG; r += kWgThreadsAll / 16) {
      const int cc = tid & 15;
      if (q0 + r < g.L)
        *reinterpret_cast<uint4*>(out + token(g, win, win.bq, q0 + r) * g.o_stride + cc * 8) =
            *reinterpret_cast<const uint4*>(so + r * kLdo + cc * 8);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], 1);
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], 2);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = q0 + r0 + 8 * h;
        if (i >= g.L) continue;
        const long long t = token(g, win, win.bq, i);
        if (sp.part != nullptr) {
          const long long rows = static_cast<long long>(g.b) * g.h * g.w;
          sp.part[blockIdx.z * rows + t] = make_float4(m[h], l[h], o[2 * h], o[2 * h + 1]);
        } else {
          float* out = static_cast<float*>(g.out) + t * g.o_stride;
          out[0] = o[2 * h] / l[h];
          out[1] = o[2 * h + 1] / l[h];
        }
      }
    }
  }
}

// out[row] = the softmax-weighted 2-wide value from the n key splits'
// partials (m, l, acc0, acc1) of that row
__global__ void flash_combine_kernel(const float4* part, float* out, int rows, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows) return;
  float mx = kNegInit;
  for (int z = 0; z < n; ++z) mx = fmaxf(mx, part[static_cast<long long>(z) * rows + t].x);
  float l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int z = 0; z < n; ++z) {
    const float4 p = part[static_cast<long long>(z) * rows + t];
    const float w = exp2f(p.x - mx);
    l = fmaf(p.y, w, l);
    a0 = fmaf(p.z, w, a0);
    a1 = fmaf(p.w, w, a1);
  }
  out[2 * t] = a0 / l;
  out[2 * t + 1] = a1 / l;
}

// ---------------------------------------------------------------- f32: 3xTF32

// Shared memory of the f32 kernel (offsets in bytes): Q (kRowsWG rows), K[2],
// V[2], key labels[2], query labels; one f32 copy of each tile, split in
// registers (tf32.cuh). Row pitches keep the fragment loads free of bank
// conflicts: Q and K rows are read as float2 at column 8 kk + 2 t of row g
// (pitch 136 floats: banks 8 g + 2 t), V as scalars at rows 2 t and 2 t + 1,
// column 8 nt + g (pitch 132: banks 8 t + g).
constexpr int kLdQK = kC + 8;
constexpr int kLdV = kC + 4;
template <int VW>
struct F32Smem {
  static constexpr int kQ = 0;
  static constexpr int kKBytes = kKT * kLdQK * 4;
  static constexpr int kVBytes = VW == kC ? kKT * kLdV * 4 : kKT * 2 * 4;
  static constexpr int kK = kRowsWG * kLdQK * 4;  // + stage * kKBytes
  static constexpr int kVal = kK + 2 * kKBytes;   // + stage * kVBytes
  static constexpr int kKLab = kVal + 2 * kVBytes;
  static constexpr int kQLab = kKLab + 2 * kKT * 4;
  static constexpr int kBytes = kQLab + kRowsWG * 4;
};

// rows [i0, i0 + rows) of a window (128 f32 channels each) into shared
// memory rows `pitch` bytes apart by cp.async; rows past L are zero
__device__ __forceinline__ void load_rows_f32(uint32_t dst, int pitch, const float* src,
                                              int stride, int rows, const Geom& g,
                                              const Window& win, int bb, int i0) {
  const int cc = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWgThreadsAll / 32) {
    const bool ok = i0 + r < g.L;
    const long long t = ok ? token(g, win, bb, i0 + r) : 0;
    cp_async<16>(dst + r * pitch + cc * 16, src + t * stride + cc * 4, ok);
  }
}

// keys, values and key labels of the tile at key k0 into ring stage st
template <int VW>
__device__ __forceinline__ void load_kv_f32(const Geom& g, const Window& win, uint32_t base,
                                            int st, int k0) {
  using SM = F32Smem<VW>;
  load_rows_f32(base + SM::kK + st * SM::kKBytes, kLdQK * 4, static_cast<const float*>(g.k),
                g.k_stride, kKT, g, win, win.bkv, k0);
  const int t = threadIdx.x;
  const float* v = static_cast<const float*>(g.v);
  if constexpr (VW == kC) {
    load_rows_f32(base + SM::kVal + st * SM::kVBytes, kLdV * 4, v, g.v_stride, kKT, g, win,
                  win.bkv, k0);
  } else if (t < kKT) {
    const bool ok = k0 + t < g.L;
    cp_async<8>(base + SM::kVal + st * SM::kVBytes + t * 8,
                v + (ok ? token(g, win, win.bkv, k0 + t) * g.v_stride : 0), ok);
  }
  if (g.labels != nullptr && t >= kWgThreadsAll - kKT) {
    const int j = t - (kWgThreadsAll - kKT);
    const bool ok = k0 + j < g.L;
    cp_async<4>(base + SM::kKLab + st * kKT * 4 + j * 4, win.lab + (ok ? k0 + j : 0), ok);
  }
}

// One block: eight warps of 16 query rows (warp w: rows [q0 + 16 w, +16)
// of window blockIdx.x, q0 = blockIdx.y * 128) against key tiles [z tiles,
// (z + 1) tiles) of that window, z = blockIdx.z; the K/V ring is shared.
// Lane 4 g + t holds rows 16 w + g and 16 w + g + 8; S, P and O lie in the
// accumulator layout of attn_wgmma_kernel, so softmax_regs serves both.
//  * S = Q K^T: 16 k-steps of 8 channels x 8 key tiles of m16n8k8, each a
//    3xTF32 product; Q's fragment is split once per k-step, K's per use.
//  * O += P V (128-wide value): P's accumulator tile over 8 keys is the A
//    fragment of those keys ({c0, c2, c1, c3}, with k relabelled as in
//    tf32.cuh), and V's B fragment is V[key 8 j + 2 t][col], V[8 j + 2 t
//    + 1][col]: keys stay in their rows, no transposed copy.
//  * The 2-wide value (flash) stays on the FMA pipes, as in bf16.
template <int VW>
__global__ void __launch_bounds__(kWgThreadsAll, 1) attn_tf32_kernel(Geom g, Split sp) {
  using SM = F32Smem<VW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int* qlab = reinterpret_cast<const int*>(smem + SM::kQLab);
  const float* sQ = reinterpret_cast<const float*>(smem + SM::kQ);

  const Window win = window_of(g);
  const int q0 = blockIdx.y * kRowsWG;
  const int nkt = (g.L + kKT - 1) / kKT;
  const int kt0 = blockIdx.z * sp.tiles, kt1 = min(nkt, kt0 + sp.tiles);
  const int tid = threadIdx.x, lane = tid & 31;
  const int g4 = lane >> 2, col = 2 * (lane & 3);
  const int r0 = (tid >> 5) * 16 + g4;

  load_rows_f32(base + SM::kQ, kLdQK * 4, static_cast<const float*>(g.q), g.q_stride, kRowsWG,
                g, win, win.bq, q0);
  if (g.labels != nullptr && tid < kRowsWG) {
    const bool ok = q0 + tid < g.L;
    cp_async<4>(base + SM::kQLab + tid * 4, win.lab + (ok ? q0 + tid : 0), ok);
  }
  if (kt0 < kt1) load_kv_f32<VW>(g, win, base, 0, kt0 * kKT);
  cp_async_commit();

  constexpr int kAcc = VW == kC ? 64 : 4;  // O, or the 2-wide sums of rows r0 and r0 + 8
  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  const float sl2 = g.scale * kLog2e;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) load_kv_f32<VW>(g, win, base, st ^ 1, (kt + 1) * kKT);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) have landed
    __syncthreads();

    const float* sK = reinterpret_cast<const float*>(smem + SM::kK + st * SM::kKBytes);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kC / 8; ++kk) {
      const FragA a(*reinterpret_cast<const float2*>(sQ + r0 * kLdQK + 8 * kk + col),
                    *reinterpret_cast<const float2*>(sQ + (r0 + 8) * kLdQK + 8 * kk + col));
#pragma unroll
      for (int nt = 0; nt < kKT / 8; ++nt) {
        const float2 b =
            *reinterpret_cast<const float2*>(sK + (8 * nt + g4) * kLdQK + 8 * kk + col);
        mma_3xtf32(DRBA_ACC4(s, nt), a, b.x, b.y);
      }
    }

    const int lim = g.L - kt * kKT;
    float corr[2];
    if (g.labels == nullptr && lim >= kKT) {
      softmax_regs<false>(s, m, l, corr, sl2, lim, col, nullptr, 0, 0);
    } else {
      const int* klab = g.labels == nullptr
                            ? nullptr
                            : reinterpret_cast<const int*>(smem + SM::kKLab + st * kKT * 4);
      softmax_regs<true>(s, m, l, corr, sl2, lim, col, klab, klab ? qlab[r0] : 0,
                         klab ? qlab[r0 + 8] : 0);
    }

    if constexpr (VW == kC) {
      const float* sV = reinterpret_cast<const float*>(smem + SM::kVal + st * SM::kVBytes);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll 2
      for (int j = 0; j < kKT / 8; ++j) {
        const FragA a(s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]);
        const float* v0 = sV + (8 * j + col) * kLdV + g4;  // key 8 j + 2 t, column g
#pragma unroll
        for (int nt = 0; nt < kC / 8; ++nt)
          mma_3xtf32(DRBA_ACC4(o, nt), a, v0[8 * nt], v0[kLdV + 8 * nt]);
      }
    } else {
      const float2* v2 = reinterpret_cast<const float2*>(smem + SM::kVal + st * SM::kVBytes);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] *= corr[i >> 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const float2 vv = v2[8 * (i >> 2) + col + (i & 1)];
        o[2 * h] = fmaf(s[i], vv.x, o[2 * h]);
        o[2 * h + 1] = fmaf(s[i], vv.y, o[2 * h + 1]);
      }
    }
    __syncthreads();  // stage st is free for the load of tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if constexpr (VW == kC) {
    float* out = static_cast<float*>(g.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = q0 + r0 + 8 * h;
      if (i >= g.L) continue;
      float* row = out + token(g, win, win.bq, i) * g.o_stride + col;
      const float inv = 1.f / l[h];
#pragma unroll
      for (int nt = 0; nt < kC / 8; ++nt)
        *reinterpret_cast<float2*>(row + 8 * nt) =
            make_float2(o[4 * nt + 2 * h] * inv, o[4 * nt + 2 * h + 1] * inv);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], 1);
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], 2);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = q0 + r0 + 8 * h;
        if (i >= g.L) continue;
        const long long t = token(g, win, win.bq, i);
        if (sp.part != nullptr) {
          const long long rows = static_cast<long long>(g.b) * g.h * g.w;
          sp.part[blockIdx.z * rows + t] = make_float4(m[h], l[h], o[2 * h], o[2 * h + 1]);
        } else {
          float* out = static_cast<float*>(g.out) + t * g.o_stride;
          out[0] = o[2 * h] / l[h];
          out[1] = o[2 * h + 1] / l[h];
        }
      }
    }
  }
}

// Launch over (windows, query tiles of `rows`, key splits); shared memory
// above 48 KB only as opted-in dynamic shared memory.
template <typename K, typename... Args>
int launch(K kernel, int threads, int rows, int bytes, int splits, const Geom& g,
           cudaStream_t s, Args... args) {
  if (g.L >= (1 << 21)) return static_cast<int>(cudaErrorInvalidValue);  // see token()
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(g.b * g.kk * g.kk, drba::cdiv(g.L, rows), splits);
  kernel<<<grid, threads, bytes, s>>>(g, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Window attention over b images of h x w tokens split into kk x kk windows.
// q/k/v/out: tokens q_stride/k_stride/v_stride/o_stride elements apart, 128
// contiguous channels each, all in one dtype (f32|bf16); 16-byte aligned
// (checked by the caller). labels: int32 or NULL, window token t of window
// wi in image bb at labels[wi * lab_win_stride + bb * lab_b_stride + t].
// Keys/values of image bb come from image (bb + half) % b. Returns
// cudaGetLastError().
extern "C" int drba_window_attention(const void* q, const void* k, const void* v, void* out,
                                     const int* labels, int b, int h, int w, int kk,
                                     int q_stride, int k_stride, int v_stride, int o_stride,
                                     int lab_win_stride, int lab_b_stride, int half, int dtype,
                                     void* stream) {
  if (b == 0 || h == 0 || w == 0) return 0;
  const Geom g{q, k, v, out, labels, b, h, w, kk, h / kk, w / kk, (h / kk) * (w / kk),
               q_stride, k_stride, v_stride, o_stride, lab_win_stride, lab_b_stride, half,
               1.f / sqrtf(static_cast<float>(kC)), 1.f / static_cast<float>(w / kk)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == drba::kBF16)
    return launch(attn_wgmma_kernel<kC>, kWgThreadsAll, kRowsWG, WgSmem<kC>::kBytes, 1, g, s,
                  Split{nullptr, static_cast<int>(drba::cdiv(g.L, kKT))});
  if (dtype == drba::kF32)
    return launch(attn_tf32_kernel<kC>, kWgThreadsAll, kRowsWG, F32Smem<kC>::kBytes, 1, g, s,
                  Split{nullptr, static_cast<int>(drba::cdiv(g.L, kKT))});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash attention with a 2-wide f32 value: q/k (b, L, 128) contiguous in one
// dtype (f32|bf16), v (b, L, 2) f32 (8-byte aligned), out (b, L, 2) f32;
// labels (b, L) int32 or NULL. n_split > 1 splits the keys into n_split
// runs of cdiv(cdiv(L, 64), n_split) tiles and writes the partials to part
// (n_split * b * L float4, 16-byte aligned) for drba_flash_combine. Returns
// cudaGetLastError().
extern "C" int drba_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    const int* labels, int b, int L, int dtype, void* part,
                                    int n_split, void* stream) {
  if (b == 0 || L == 0) return 0;
  if (n_split < 1 || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // every split gets at least one key tile
  const int tiles = static_cast<int>(drba::cdiv(drba::cdiv(L, kKT), n_split));
  if (static_cast<int>(drba::cdiv(drba::cdiv(L, kKT), tiles)) != n_split)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{q, k, v, out, labels, b, 1, L, 1, 1, L, L, kC, kC, 2, 2, 0, L, 0,
               1.f / sqrtf(static_cast<float>(kC)), 1.f / static_cast<float>(L)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == drba::kBF16)
    return launch(attn_wgmma_kernel<2>, kWgThreadsAll, kRowsWG, WgSmem<2>::kBytes, n_split, g,
                  s, Split{n_split > 1 ? static_cast<float4*>(part) : nullptr, tiles});
  if (dtype == drba::kF32)
    return launch(attn_tf32_kernel<2>, kWgThreadsAll, kRowsWG, F32Smem<2>::kBytes, n_split, g,
                  s, Split{n_split > 1 ? static_cast<float4*>(part) : nullptr, tiles});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The second launch of a split flash attention: out (rows, 2) f32 from the
// partials part (n_split, rows) float4 that drba_flash_attention wrote.
extern "C" int drba_flash_combine(const void* part, void* out, int rows, int n_split,
                                  void* stream) {
  if (rows == 0) return 0;
  flash_combine_kernel<<<drba::cdiv(rows, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(part), static_cast<float*>(out), rows, n_split);
  return static_cast<int>(cudaGetLastError());
}
