// Window attention and flash attention with a narrow value, head width 128.
//
// Replaces three TPU kernels of drba_tpu/ops/attn_mxu.py:
//  * window_attention_mxu (:63, body _kernel :37) and window_attention_nhwc
//    (:281, body _nhwc_kernel :253): softmax(q k^T / sqrt(c), masked by
//    region id) v per window. The TPU kernels hold a whole (rows, Lpad) f32
//    score chunk in VMEM; a block here has 227 KB of shared memory, so one
//    block takes one (window, 64-query tile) and walks the window's keys in
//    64-key tiles with an online softmax (running max, sum and accumulator
//    in f32). Windows are addressed by token strides, so the same kernel
//    reads an NHWC map in place (no split/merge copies), the (B, L, c)
//    layout, and the q|k|v columns of the transformer layer's projection;
//    keys and values may come from another image of the batch (the
//    cross-attention batch-half swap).
//  * flash_attention_mxu (:150, body _flash_kernel :110): the same key-tile
//    loop with a value of width 2 (pixel coordinates or flow), for GMFlow's
//    global correlation and flow propagation at L = 8160. The (B, L, L)
//    scores never leave shared memory.
//
// A key is dead where it lies past L or, with labels, where its region id
// differs from the query's; dead keys get weight exactly 0 (the TPU
// kernels' -1e9 fill).
//
// bf16 (the main path): q k^T on tensor cores through WMMA (16x16x16 bf16,
// f32 accumulation). For the 128-wide value, P is rounded to bf16 and P v
// runs on tensor cores too; the f32 accumulator lives in shared memory so
// that each tile can rescale its rows (WMMA fragments have no documented
// element layout). For the 2-wide value, P v stays in f32 on the FMA pipes:
// the values are pixel coordinates up to a few hundred, where a bf16 P
// would cost about a pixel. f32: every product on the FMA pipes.
//
// Bound on this card: per key tile a block does 2 x 64 x 64 x 128 MACs on
// tensor cores but also a 64 x 64 softmax with warp shuffles and exp, and
// (bf16, 128-wide value) a round trip of the 64 x 128 f32 accumulator
// through shared memory, so the kernel is bound by shared-memory traffic and
// the softmax, far below the tensor cores' peak. wgmma/TMA, register-held
// accumulators (mma.sync with a known layout) and larger query tiles are
// later steps.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using drba::bf16;

constexpr int kC = 128;       // head width
constexpr int kQT = 64;       // queries per block
constexpr int kKT = 64;       // keys per tile
constexpr int kThreads = 128; // 4 warps, 16 query rows each
constexpr int kLdh = kC + 8;  // bf16 row stride of q/k/v tiles
constexpr int kLdf = kC + 4;  // f32 row stride of q/k/v tiles and the accumulator
constexpr int kLds = kKT + 4; // f32 row stride of the score tile
constexpr int kLdp = kKT + 8; // bf16 row stride of the probability tile
constexpr float kNegInit = -1e30f;

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

// global token index of window token i of image bb
__device__ __forceinline__ long long token(const Geom& g, const Window& win, int bb, int i) {
  const int ly = i / g.ww, lx = i - ly * g.ww;
  return (static_cast<long long>(bb) * g.h + win.wy * g.wh + ly) * g.w + win.wx * g.ww + lx;
}

// rows [i0, i0 + 64) of a window (128 channels of T each) into shared memory
// with row stride ld; rows past L are zero
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int stride,
                                          const Geom& g, const Window& win, int bb, int i0) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kPerRow = kC / kVec;
  for (int e = threadIdx.x; e < 64 * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    const int i = i0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (i < g.L)
      val = *reinterpret_cast<const uint4*>(src + token(g, win, bb, i) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one block, carved from the dynamic allocation. TQ is the
// q/k element type; VW the value width (128 or 2).
template <typename TQ, int VW>
struct Smem {
  static constexpr bool kBF = sizeof(TQ) == 2;
  static constexpr int kLd = kBF ? kLdh : kLdf;
  static constexpr int kTile = 64 * kLd * static_cast<int>(sizeof(TQ));
  static constexpr int kV = VW == kC ? kTile : 64 * 2 * 4;
  static constexpr int kS = kQT * kLds * 4;
  static constexpr int kP = (kBF && VW == kC) ? kQT * kLdp * 2 : 0;
  static constexpr int kO = (kBF && VW == kC) ? kQT * kLdf * 4 : 0;
  static constexpr int kBytes = 2 * kTile + kV + kS + kP + kO + 2 * 64 * 4;
};

// Per-row online-softmax update over one key tile, for the 16 rows of this
// warp. Reads the raw scores of the tile from s (row stride kLds), returns
// the row maxima and sums in m/l (identical in every lane), and
//  * VW == 128: writes P into p (bf16, stride kLdp) or back into s (f32),
//    and the rescale factors into corr;
//  * VW == 2: folds P v into acc (identical in every lane).
template <int VW, typename TP>
__device__ __forceinline__ void softmax_tile(const Geom& g, float* s, TP* p, const int* qlab,
                                             const int* klab, const float* v2, int k0,
                                             float (&m)[16], float (&l)[16], float (&corr)[16],
                                             float (&acc)[16][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    float sv[2];
    bool live[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = lane + 32 * hh;
      live[hh] = k0 + j < g.L && (g.labels == nullptr || klab[j] == qlab[r]);
      sv[hh] = s[r * kLds + j] * g.scale;
    }
    const float mx = warp_max(fmaxf(live[0] ? sv[0] : kNegInit, live[1] ? sv[1] : kNegInit));
    const float m_new = fmaxf(m[rr], mx);
    const float p0 = live[0] ? expf(sv[0] - m_new) : 0.f;
    const float p1 = live[1] ? expf(sv[1] - m_new) : 0.f;
    corr[rr] = expf(m[rr] - m_new);
    m[rr] = m_new;
    l[rr] = l[rr] * corr[rr] + warp_sum(p0 + p1);
    if constexpr (VW == kC) {
      if constexpr (sizeof(TP) == 2) {
        p[r * kLdp + lane] = drba::from_f32<bf16>(p0);
        p[r * kLdp + lane + 32] = drba::from_f32<bf16>(p1);
      } else {
        s[r * kLds + lane] = p0;
        s[r * kLds + lane + 32] = p1;
      }
    } else {
      const float a0 = warp_sum(p0 * v2[2 * lane] + p1 * v2[2 * (lane + 32)]);
      const float a1 = warp_sum(p0 * v2[2 * lane + 1] + p1 * v2[2 * (lane + 32) + 1]);
      acc[rr][0] = acc[rr][0] * corr[rr] + a0;
      acc[rr][1] = acc[rr][1] * corr[rr] + a1;
    }
  }
}

// write the 2-wide result of this warp's 16 rows (lane rr writes row rr)
__device__ __forceinline__ void store_narrow(const Geom& g, const Window& win, int q0,
                                             const float (&l)[16], const float (&acc)[16][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* out = static_cast<float*>(g.out);
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int i = q0 + warp * 16 + rr;
    if (lane == rr && i < g.L) {
      const long long t = token(g, win, win.bq, i) * g.o_stride;
      out[t] = acc[rr][0] / l[rr];
      out[t + 1] = acc[rr][1] / l[rr];
    }
  }
}

// keys, values and key labels of tile k0 into shared memory
template <typename TQ, typename TV, int VW>
__device__ __forceinline__ void load_kv(const Geom& g, const Window& win, TQ* sK, TV* sV,
                                        int* klab, int k0) {
  load_rows<TQ>(sK, Smem<TQ, VW>::kLd, static_cast<const TQ*>(g.k), g.k_stride, g, win,
                win.bkv, k0);
  if constexpr (VW == kC) {
    load_rows<TV>(sV, Smem<TQ, VW>::kLd, static_cast<const TV*>(g.v), g.v_stride, g, win,
                  win.bkv, k0);
  } else {
    const float* v = static_cast<const float*>(g.v);
    for (int e = threadIdx.x; e < 64 * 2; e += kThreads) {
      const int i = k0 + e / 2;
      sV[e] = i < g.L ? v[token(g, win, win.bkv, i) * g.v_stride + e % 2] : 0.f;
    }
  }
  if (g.labels != nullptr && threadIdx.x < kKT)
    klab[threadIdx.x] = k0 + threadIdx.x < g.L ? win.lab[k0 + threadIdx.x] : -1;
}

// ------------------------------------------------------------------- bf16: WMMA

template <int VW>
__global__ void __launch_bounds__(kThreads) attn_wmma_kernel(Geom g) {
  using namespace nvcuda;
  using SM = Smem<bf16, VW>;
  using TV = typename std::conditional<VW == kC, bf16, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + SM::kTile);
  TV* sV = reinterpret_cast<TV*>(smem + 2 * SM::kTile);
  float* sS = reinterpret_cast<float*>(smem + 2 * SM::kTile + SM::kV);
  bf16* sP = reinterpret_cast<bf16*>(smem + 2 * SM::kTile + SM::kV + SM::kS);
  float* sO = reinterpret_cast<float*>(smem + 2 * SM::kTile + SM::kV + SM::kS + SM::kP);
  int* qlab = reinterpret_cast<int*>(smem + 2 * SM::kTile + SM::kV + SM::kS + SM::kP + SM::kO);
  int* klab = qlab + 64;

  const Window win = window_of(g);
  const int q0 = blockIdx.y * kQT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows<bf16>(sQ, kLdh, static_cast<const bf16*>(g.q), g.q_stride, g, win, win.bq, q0);
  if (g.labels != nullptr && threadIdx.x < kQT)
    qlab[threadIdx.x] = q0 + threadIdx.x < g.L ? win.lab[q0 + threadIdx.x] : -2;
  if constexpr (VW == kC)
    for (int e = threadIdx.x; e < kQT * kLdf; e += kThreads) sO[e] = 0.f;

  float m[16], l[16], corr[16], acc[16][2];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    m[rr] = kNegInit;
    l[rr] = 0.f;
    acc[rr][0] = acc[rr][1] = 0.f;
  }

  for (int k0 = 0; k0 < g.L; k0 += kKT) {
    __syncthreads();  // the previous tile's keys and values are no longer read
    load_kv<bf16, TV, VW>(g, win, sK, sV, klab, k0);
    __syncthreads();

    // raw scores of this warp's 16 rows: S = Q K^T (K read as a col-major B)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
      for (int c = 0; c < kC; c += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * kLdh + c, kLdh);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sK + j * 16 * kLdh + c, kLdh);
          wmma::mma_sync(s[j], a, bk, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(sS + warp * 16 * kLds + j * 16, s[j], kLds, wmma::mem_row_major);
    }
    __syncwarp();
    softmax_tile<VW, bf16>(g, sS, sP, qlab, klab, reinterpret_cast<const float*>(sV), k0, m, l,
                           corr, acc);
    if constexpr (VW == kC) {
      // rescale this warp's accumulator rows, then O += P V on tensor cores
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        float4* o = reinterpret_cast<float4*>(sO + (warp * 16 + rr) * kLdf) + lane;
        float4 t = *o;
        t.x *= corr[rr];
        t.y *= corr[rr];
        t.z *= corr[rr];
        t.w *= corr[rr];
        *o = t;
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wmma::load_matrix_sync(a[kk], sP + warp * 16 * kLdp + kk * 16, kLdp);
#pragma unroll
      for (int j = 0; j < kC / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        float* optr = sO + warp * 16 * kLdf + j * 16;
        wmma::load_matrix_sync(o, optr, kLdf, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, reinterpret_cast<const bf16*>(sV) + kk * 16 * kLdh + j * 16,
                                 kLdh);
          wmma::mma_sync(o, a[kk], bv, o);
        }
        wmma::store_matrix_sync(optr, o, kLdf, wmma::mem_row_major);
      }
      __syncwarp();
    }
  }

  if constexpr (VW == kC) {
    bf16* out = static_cast<bf16*>(g.out);
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int i = q0 + warp * 16 + rr;
      if (i >= g.L) continue;
      const float4 t = reinterpret_cast<const float4*>(sO + (warp * 16 + rr) * kLdf)[lane];
      const float inv = 1.f / l[rr];
      bf16* dst = out + token(g, win, win.bq, i) * g.o_stride + 4 * lane;
      dst[0] = drba::from_f32<bf16>(t.x * inv);
      dst[1] = drba::from_f32<bf16>(t.y * inv);
      dst[2] = drba::from_f32<bf16>(t.z * inv);
      dst[3] = drba::from_f32<bf16>(t.w * inv);
    }
  } else {
    store_narrow(g, win, q0, l, acc);
  }
}

// --------------------------------------------------------------------- f32: FMA

template <int VW>
__global__ void __launch_bounds__(kThreads) attn_fma_kernel(Geom g) {
  using SM = Smem<float, VW>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + SM::kTile);
  float* sV = reinterpret_cast<float*>(smem + 2 * SM::kTile);
  float* sS = reinterpret_cast<float*>(smem + 2 * SM::kTile + SM::kV);
  int* qlab = reinterpret_cast<int*>(smem + 2 * SM::kTile + SM::kV + SM::kS);
  int* klab = qlab + 64;

  const Window win = window_of(g);
  const int q0 = blockIdx.y * kQT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rs = lane >> 1, half = lane & 1;  // score phase: row rs, columns half + 2i

  load_rows<float>(sQ, kLdf, static_cast<const float*>(g.q), g.q_stride, g, win, win.bq, q0);
  if (g.labels != nullptr && threadIdx.x < kQT)
    qlab[threadIdx.x] = q0 + threadIdx.x < g.L ? win.lab[q0 + threadIdx.x] : -2;

  float m[16], l[16], corr[16], acc[16][2];
  float4 o[VW == kC ? 16 : 1];  // this lane's 4 columns of the warp's 16 rows
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    m[rr] = kNegInit;
    l[rr] = 0.f;
    acc[rr][0] = acc[rr][1] = 0.f;
  }
#pragma unroll
  for (int rr = 0; rr < (VW == kC ? 16 : 1); ++rr) o[rr] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < g.L; k0 += kKT) {
    __syncthreads();
    load_kv<float, float, VW>(g, win, sK, sV, klab, k0);
    __syncthreads();

    {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      const float* qrow = sQ + (warp * 16 + rs) * kLdf;
      for (int c = 0; c < kC; c += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + c);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + (half + 2 * i) * kLdf + c);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) sS[(warp * 16 + rs) * kLds + half + 2 * i] = s[i];
    }
    __syncwarp();
    softmax_tile<VW, float>(g, sS, sS, qlab, klab, sV, k0, m, l, corr, acc);
    if constexpr (VW == kC) {
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        o[rr].x *= corr[rr];
        o[rr].y *= corr[rr];
        o[rr].z *= corr[rr];
        o[rr].w *= corr[rr];
      }
      for (int j = 0; j < kKT; ++j) {
        const float4 vv = reinterpret_cast<const float4*>(sV + j * kLdf)[lane];
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float p = sS[(warp * 16 + rr) * kLds + j];
          o[rr].x = fmaf(p, vv.x, o[rr].x);
          o[rr].y = fmaf(p, vv.y, o[rr].y);
          o[rr].z = fmaf(p, vv.z, o[rr].z);
          o[rr].w = fmaf(p, vv.w, o[rr].w);
        }
      }
      __syncwarp();
    }
  }

  if constexpr (VW == kC) {
    float* out = static_cast<float*>(g.out);
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int i = q0 + warp * 16 + rr;
      if (i >= g.L) continue;
      const float inv = 1.f / l[rr];
      reinterpret_cast<float4*>(out + token(g, win, win.bq, i) * g.o_stride)[lane] =
          make_float4(o[rr].x * inv, o[rr].y * inv, o[rr].z * inv, o[rr].w * inv);
    }
  } else {
    store_narrow(g, win, q0, l, acc);
  }
}

template <typename K>
int launch(K kernel, int bytes, const Geom& g, cudaStream_t s) {
  // above 48 KB only as opted-in dynamic shared memory; set once per kernel
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(g.b * g.kk * g.kk, drba::cdiv(g.L, kQT));
  kernel<<<grid, kThreads, bytes, s>>>(g);
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
               1.f / sqrtf(static_cast<float>(kC))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == drba::kBF16) return launch(attn_wmma_kernel<kC>, Smem<bf16, kC>::kBytes, g, s);
  if (dtype == drba::kF32) return launch(attn_fma_kernel<kC>, Smem<float, kC>::kBytes, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash attention with a 2-wide f32 value: q/k (b, L, 128) contiguous in one
// dtype (f32|bf16), v (b, L, 2) f32, out (b, L, 2) f32; labels (b, L) int32
// or NULL. Returns cudaGetLastError().
extern "C" int drba_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    const int* labels, int b, int L, int dtype, void* stream) {
  if (b == 0 || L == 0) return 0;
  const Geom g{q, k, v, out, labels, b, 1, L, 1, 1, L, L, kC, kC, 2, 2, 0, L, 0,
               1.f / sqrtf(static_cast<float>(kC))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == drba::kBF16) return launch(attn_wmma_kernel<2>, Smem<bf16, 2>::kBytes, g, s);
  if (dtype == drba::kF32) return launch(attn_fma_kernel<2>, Smem<float, 2>::kBytes, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
