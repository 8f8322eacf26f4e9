// Shared declarations and device helpers of the tensor-parallel kernels K9
// (fused_tp.cu: the decode step's attention and MLP halves per rank) and K10
// (fused_mtp_tp.cu: the sharded MTP chain with its in-kernel exchange).
//
// The pack is the JAX package's FusedTPWeights (ops/fused_tp.py), leaf for
// leaf: per rank, K-major int8 units of NU columns with float32 scales per
// unit column.  An N-split product (qkv, gate|up) has one unit per NU output
// columns over all K = H input rows; a K-split product (wo, down) has
// (K / KC) x (N / NU) units, unit (i, j) holding input rows [i KC, (i+1) KC)
// of output columns [j NU, (j+1) NU), and its output column sums the chunks'
// scaled dot products in chunk order.  Both are one layout: chunk i of
// column c lies in unit i * (N / NU) + c / NU (an N-split product has one
// chunk).
//
// The structs are mirrored by ctypes.Structure classes in ops/_build.py.
#pragma once

#include "qtts_kernels.cuh"

constexpr int QTTS_TP_MAX = 8;        // ranks a chain launch takes
constexpr int QTTS_TP_COLS = 64;      // output columns of one GEMV tile
constexpr int QTTS_TP_SLICES = 16;    // K slices of a tile: 16 column groups of 4 x 16 = 256 threads
constexpr int QTTS_TP_THREADS = 256;
constexpr int QTTS_TP_MAX_T = 32;     // the chain's cache slots (n + 2)

// One rank's shard of one transformer (nq, nk and I per rank).
struct QttsTpWeights {
  const int8_t* qkv_u;  // [L, A / NU, H, NU]      A = (nq + 2 nk) D
  const float* qkv_s;   // [L, A / NU, NU]
  const int8_t* wo_u;   // [L, (nq D / KCo) (H / NU), KCo, NU]
  const float* wo_s;    // [L, (nq D / KCo) (H / NU), NU]
  const int8_t* gu_u;   // [L, 2 I / NU, H, NU]     gate | up
  const float* gu_s;
  const int8_t* wd_u;   // [L, (I / KCd) (H / NU), KCd, NU]
  const float* wd_s;
  const float* attn_norm;  // [L, H]
  const float* mlp_norm;   // [L, H]
  const float* q_norm;     // [L, D]
  const float* k_norm;     // [L, D]
  const float* inv_freq;   // [D / 2]
  int32_t L, H, nq, nk, D, I, NU, KCo, KCd;
  float eps, attn_scale;
};

// Device scratch of one rank's halves (K9).
struct QttsTpScratch {
  float* qkv;   // [A]
  float* attn;  // [nq D]
  float* gu;    // [2 I]
  float* part;  // [nq, max_splits, D + 2]: split-softmax partials
  int32_t max_splits;
};

// The shard's geometry checks every entry makes.
static inline bool qtts_tp_shapes_ok(const QttsTpWeights& w) {
  const int A = (w.nq + 2 * w.nk) * w.D, qd = w.nq * w.D;
  return w.D == QTTS_ATTN_D && w.nk > 0 && w.nq % w.nk == 0 && w.nq / w.nk <= QTTS_ATTN_MAX_G &&
         w.NU % QTTS_TP_COLS == 0 && w.H % w.NU == 0 && A % w.NU == 0 && (2 * w.I) % w.NU == 0 &&
         w.KCo > 0 && qd % w.KCo == 0 && w.KCd > 0 && w.I % w.KCd == 0 && w.H <= 8192 &&
         qd <= 8192 && w.I <= 8192;
}

// Four consecutive unit values as floats.
static __device__ __forceinline__ void qtts_tp_load4(const int8_t* p, float (&w)[4]) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  w[0] = (float)c.x;
  w[1] = (float)c.y;
  w[2] = (float)c.z;
  w[3] = (float)c.w;
}
static __device__ __forceinline__ void qtts_tp_load4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

// The GEMV input: sh[k] = bf16(transform(in))[k0 + k] for k < n, as float32,
// on the whole block.  IN_NORM: RMSNorm over all K values of in, times
// norm_w (the head product keeps the rank's rows k0 .. k0 + n); IN_PLAIN: in;
// IN_SILU: silu(gate) * up of in = gate | up, K values each.  The
// activations come from other blocks of the launch (K10), so they are read
// past L1.
template <int IN_MODE>
static __device__ __forceinline__ void qtts_tp_prologue(const float* in,
                                                        const float* __restrict__ norm_w,
                                                        float eps, int K, int k0, int n,
                                                        float* sh) {
  float r = 0.f;
  if (IN_MODE == QTTS_IN_NORM) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float v = __ldcg(in + k);
      ss += v * v;
    }
    ss = qtts_block_reduce(ss, QttsSumF());
    r = rsqrtf(ss / (float)K + eps);
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int kk = k0 + k;
    float v;
    if (IN_MODE == QTTS_IN_NORM) {
      v = (__ldcg(in + kk) * r) * norm_w[kk];
    } else if (IN_MODE == QTTS_IN_PLAIN) {
      v = __ldcg(in + kk);
    } else {
      const float g = __ldcg(in + kk);
      const float u = __ldcg(in + K + kk);
      v = g * (1.f / (1.f + expf(-g))) * u;
    }
    sh[k] = qtts_bf16_round(v);
  }
  __syncthreads();
}

// Tile `tile` (QTTS_TP_COLS output columns) of the unit product on the
// block's bf16 input sh (n_chunks x KC floats): for each chunk in order, the
// dot product of every column (thread (g, s) takes columns 4 g .. 4 g + 3 over
// rows s, s + 16, ..., fmaf in row order; the 16 slices then summed in slice
// order), times the unit column's scale when S is given, added to the
// previous chunks' sum.  The input is bf16 and the units int8 or bf16, so
// each product is exact in float32 and the fmaf rounds once, as a separate
// product and sum would.  Returns column tile * 64 + t's value on threads
// t < 64.  red: the block's [16][64] floats.
template <typename WT>
static __device__ __forceinline__ float qtts_tp_tile(const float* sh, const WT* __restrict__ W,
                                                     const float* __restrict__ S, int N, int NU,
                                                     int KC, int n_chunks, int tile,
                                                     float (*red)[QTTS_TP_COLS]) {
  const int t = threadIdx.x, cg = t & 15, ks = t >> 4;
  const int c0 = tile * QTTS_TP_COLS, nn = N / NU;
  const int cb = c0 + cg * 4;
  const int un = cb / NU, j = cb % NU;
  float total = 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    const WT* wu = W + (size_t)(i * nn + un) * KC * NU + j;
    const float* hi = sh + i * KC;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = ks; k < KC; k += QTTS_TP_SLICES) {
      float w[4];
      qtts_tp_load4(wu + (size_t)k * NU, w);
      const float h = hi[k];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(h, w[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) red[ks][cg * 4 + e] = acc[e];
    __syncthreads();
    if (t < QTTS_TP_COLS) {
      float d = red[0][t];
#pragma unroll
      for (int s = 1; s < QTTS_TP_SLICES; ++s) d = __fadd_rn(d, red[s][t]);
      const int c = c0 + t;
      const float p =
          S != nullptr ? __fmul_rn(d, S[(size_t)(i * nn + c / NU) * NU + c % NU]) : d;
      total = i == 0 ? p : __fadd_rn(total, p);
    }
    __syncthreads();
  }
  return total;
}
