// Shared declarations and device helpers of the hand-written Hopper kernels.
//
// The structs below are mirrored field for field by ctypes.Structure classes
// in leaxer_qwen3_tts_torch/ops/_build.py; keep the two in the same order.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

// Per-layer-stacked weight units of one transformer (Hopper pack layout:
// every matrix is stored [N, K], one output row per N with its K values
// contiguous): int8 with per-row scales, bf16 with scales of one, or int4
// (rows of K/2 bytes, byte j holding columns 2j in its low nibble and 2j + 1
// in its high one, two's complement, with float32 scales [N, K/128], one per
// 128-column group); unit_type says which.  The persistent K1, K3, K4, K5
// and K6 take bf16, K1, K2 and K3 int4, every other entry int8 only.  The
// int8_t pointers then hold the bf16 values' or the nibbles' bytes, and the
// scale pointers [N, K/128] floats at int4.
enum { QTTS_UNIT_INT8 = 0, QTTS_UNIT_BF16 = 1, QTTS_UNIT_INT4 = 2 };
struct QttsStepWeights {
  const int8_t* wqkv;  // [L, A, H]   A = nq*D + 2*nk*D
  const float* sqkv;   // [L, A]      per-output-column scale
  const int8_t* wo;    // [L, H, nq*D]
  const float* so;     // [L, H]
  const int8_t* wgu;   // [L, 2I, H]
  const float* sgu;    // [L, 2I]
  const int8_t* wd;    // [L, H, I]
  const float* sd;     // [L, H]
  const float* attn_norm;  // [L, H]
  const float* mlp_norm;   // [L, H]
  const float* q_norm;     // [L, D]
  const float* k_norm;     // [L, D]
  const float* inv_freq;   // [D/2] rotary inverse frequencies
  int32_t L, H, nq, nk, D, I;
  float eps;         // RMSNorm epsilon
  float attn_scale;  // 1/sqrt(D), rounded to float32
  int32_t unit_type;  // QTTS_UNIT_INT8, QTTS_UNIT_BF16 or QTTS_UNIT_INT4
};

// Device scratch the wrapper allocates for one decode step.
struct QttsStepScratch {
  float* qkv;   // [A]
  float* attn;  // [nq*D]
  float* gu;    // [2I]
  float* part;  // [nq, max_splits, D + 2]: split-softmax partials (m, l, acc)
  int32_t max_splits;
};

// Arguments of the whole-chain MTP entry (fused_mtp.cu).
struct QttsChainArgs {
  const float* final_norm;   // [H]
  const int8_t* heads;       // [n, V, H]
  const float* head_scales;  // [n, V]
  const __nv_bfloat16* tables;  // [n, Vt, H]
  const float* gumbel;       // [n, V]
  const float* last_hidden;  // [H] prefix token 0
  const float* code0_embed;  // [H] prefix token 1
  int32_t* subcodes;         // [n] out
  float* sub_sum;            // [H] out
  float* x;                  // [H] trunk residual stream
  float* x_in;               // [H] next trunk input (sampled embedding)
  float* logits;             // [V] head logits
  uint32_t* counter;         // [1] zero on entry; the last head block resets it
  void* k_cache;             // [L, nk, n + 2, D] cache dtype
  void* v_cache;
  int32_t cache_bf16, n, V, Vt;
  float temperature;  // max(temperature, 1e-6) as float32 (sampled mode)
  int32_t top_k;
  float top_p;
  int32_t greedy;
  int32_t heads_bf16;  // 1: bf16 heads (scales of one), 0: int8 (any trunk type in K2, K3)
};

// Device scratch of one batched decode step (kernel K4, fused_step_batched.cu).
struct QttsBatchScratch {
  float* qkv;          // [B, A]
  float* gu;           // [B, 2I]
  float* part;         // [B, nq, max_splits, D + 2]: split-softmax partials
  __nv_bfloat16* hb;   // [B, max(H, nq*D, I)]: the bf16 input of the next GEMV
  int32_t max_splits;
  float* attn;         // [B, nq*D]: the merged attention (the persistent K4 and K5)
};

constexpr int QTTS_MAX_BATCH = 32;  // rows K4 and K5 take

// Arguments of the batched chain entry (kernel K5, fused_mtp_batched.cu).
// The per-row knobs travel by value, so a call copies nothing to the device.
struct QttsChainBatchArgs {
  const float* final_norm;      // [H]
  const int8_t* heads;          // [n, V, H]
  const float* head_scales;     // [n, V]
  const __nv_bfloat16* tables;  // [n, Vt, H]
  const float* noise;           // Gumbel noise, step j row b at j*step + b*row
  int64_t noise_step_stride;
  int64_t noise_row_stride;
  const float* last_hidden;     // [B, H] prefix token 0
  const float* code0_embed;     // [B, H] prefix token 1
  int32_t* subcodes;            // [B, n] out
  float* sub_sum;               // [B, H] out
  float* x;                     // [B, H] trunk residual stream
  float* x_in;                  // [B, H] next trunk input (sampled embeddings)
  float* logits;                // [B, V] head logits
  void* k_cache;                // [L, B, nk, n + 2, D] cache dtype
  void* v_cache;
  int32_t cache_bf16, B, n, V, Vt;
  float temperature[QTTS_MAX_BATCH];  // max(temperature, 1e-6) per row
  int32_t top_k[QTTS_MAX_BATCH];
  float top_p[QTTS_MAX_BATCH];
  int32_t greedy[QTTS_MAX_BATCH];
  int32_t heads_bf16;  // 1: bf16 heads (scales of one), 0: int8; the trunk's unit type
};

// Arguments of the whole-frame entries (kernel K7, fused_frame.cu).  The
// wrapper builds the pointer fields once per (packs, cache bucket, cache
// dtype) and sets the inputs, outputs and per-frame scalars before each
// launch; the struct travels by value in the kernel's one parameter.
struct QttsFrameArgs {
  QttsStepWeights tw;           // talker
  QttsStepScratch ts;           // talker step scratch (max_splits for T)
  QttsStepWeights mw;           // MTP trunk
  QttsStepScratch ms;           // chain step scratch (T = n + 2)
  // the chain: MTP final norm, heads, tables, noise [n, V] (unread when
  // greedy), the knobs (also code0's), last_hidden = lh, code0_embed = c0e,
  // subcodes = codes + 1, sub_sum, trunk residual x, next trunk input x_in,
  // head logits [V], the [Lm, nk, n + 2, D] caches in the talker cache dtype
  QttsChainArgs mc;
  const float* talker_norm;     // [H] talker final norm
  const int8_t* lm;             // [Vc, H] lm_head rows
  const float* lm_scale;        // [Vc]
  const __nv_bfloat16* codec;   // [codec vocab, H] codec_embed table
  const float* last_logits;     // [Vc]
  const float* suppress;        // [Vc]
  const float* g0;              // [Vc] code0 Gumbel noise (unread when greedy)
  const void* last_hidden;      // [H] float32 or bf16 (lh_bf16)
  const void* drip;             // [H] float32 or bf16 (drip_bf16)
  void* k_cache;                // talker [L, nk, T, D] cache dtype, updated in place
  void* v_cache;
  float* x;                     // [H] talker residual: the next input, then pre-final-norm
  float* c0e;                   // [H] codec_embed(code0) as float32 (mc.code0_embed)
  float* lh;                    // [H] last_hidden as float32 (mc.last_hidden)
  int32_t* codes;               // [1 + n] out: code0, then the sub-codes
  float* logits;                // [Vc] out
  float* hidden;                // [H] out: final-normed, float32
  float* k_scale;               // [L, nk, T] talker int8-cache scales, in place (null: a
  float* v_scale;               //   bf16 or float32 talker cache in the chain's dtype)
  int32_t cache_bf16, lh_bf16, drip_bf16;
  int32_t T, pos, Vc, eos, forbid_eos;
};

constexpr int QTTS_ATTN_D = 128;      // head_dim the attention kernel takes
constexpr int QTTS_ATTN_CHUNK = 64;   // cache slots per attention split
constexpr int QTTS_ATTN_MAX_G = 8;    // max q heads per kv head
constexpr float QTTS_NEG_INF = -1e30f;

// Returns the CUDA error code of expr from the enclosing function if it failed.
#define QTTS_TRY(expr)                     \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// One decode step through all L layers (fused_step.cu).  x_in is copied to
// x first; x then carries the float32 residual stream and ends pre-final-norm.
int qtts_launch_decode_step(const QttsStepWeights& w, const QttsStepScratch& s,
                            const float* x_in, float* x, void* k_cache,
                            void* v_cache, int cache_bf16, int T, int pos,
                            cudaStream_t stream);

// One decode step of B rows (fused_step_batched.cu), the cache [L, B, nk, T, D].
// Row b sits at position min(pos_dev[b], T - 1) when pos_dev is given (a device
// array), else every row at pos_host.  Row b's arithmetic is K1's, op for op.
int qtts_launch_decode_step_batched(const QttsStepWeights& w, const QttsBatchScratch& s,
                                    const float* x_in, float* x, void* k_cache,
                                    void* v_cache, int cache_bf16, int B, int T,
                                    const int64_t* pos_dev, int pos_host,
                                    cudaStream_t stream);

// out[b, :K] = bf16(transform(in[b])) for b < B (fused_step_batched.cu); the
// transform IN_MODE as in qtts_gemv_prologue, in rows of ld_in floats.
int qtts_launch_prep_rows(int in_mode, const float* in, int ld_in, const float* norm_w,
                          float eps, int K, __nv_bfloat16* out, int B, cudaStream_t stream);

// out[b, n] (+)= scale[n] * sum_k in[b, k] * W[n, k] for b < B, n < N: the
// batched GEMV (fused_step_batched.cu); in [B, K] bf16, out rows ldo apart.
int qtts_launch_gemv_rows(const __nv_bfloat16* in, const int8_t* W, const float* scale,
                          float* out, int ldo, int B, int N, int K, int accum,
                          cudaStream_t stream);

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------

static __device__ __forceinline__ float qtts_bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The barriers a layer body waits on.  Every body below takes one of these,
// so the same code runs as a whole block of its own launch (K1-K6: the
// block barrier) or as one 128-thread half of a persistent block (K7: a
// named barrier per half, ids 1 and 2; id 0 is __syncthreads's).
struct QttsBlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct QttsNamedSync {
  int id;  // 1 or 2
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
  }
};

// Grid-wide barrier of a persistent kernel launched with
// cudaLaunchCooperativeKernel (K1, K2, K7, P1, P2): every block waits until every
// block has arrived, and the writes before it are visible to the reads after.
static __device__ __forceinline__ void qtts_grid_sync() {
  cooperative_groups::this_grid().sync();
}

struct QttsSumF {
  __device__ float operator()(float a, float b) const { return a + b; }
  static __device__ float identity() { return 0.f; }
};
struct QttsMaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
  static __device__ float identity() { return -CUDART_INF_F; }
};
struct QttsMinF {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
  static __device__ float identity() { return CUDART_INF_F; }
};
struct QttsSumI {
  __device__ int operator()(int a, int b) const { return a + b; }
  static __device__ int identity() { return 0; }
};

template <typename T, typename Op>
static __device__ __forceinline__ T qtts_warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduction over the whole block (blockDim.x a multiple of 32); every thread
// must call it and every thread gets the result.
template <typename T, typename Op>
static __device__ __forceinline__ T qtts_block_reduce(T v, Op op) {
  __shared__ T red[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = qtts_warp_reduce(v, op);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T r = lane < nw ? red[lane] : Op::identity();
    r = qtts_warp_reduce(r, op);
    if (lane == 0) red[32] = r;
  }
  __syncthreads();
  const T out = red[32];
  __syncthreads();
  return out;
}

// First index of the maximum of x[0..n) (jnp.argmax tie-break); block-wide.
static __device__ __forceinline__ int qtts_block_argmax_first(const float* x, int n) {
  __shared__ float rv[32];
  __shared__ int ri[32];
  __shared__ int result;
  float bv = -CUDART_INF_F;
  int bi = n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = x[i];
    if (v > bv) { bv = v; bi = i; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) { rv[warp] = bv; ri[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    bv = lane < nw ? rv[lane] : -CUDART_INF_F;
    bi = lane < nw ? ri[lane] : n;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) result = bi;
  }
  __syncthreads();
  const int out = result;
  __syncthreads();
  return out;
}

enum { QTTS_IN_NORM = 0, QTTS_IN_PLAIN = 1, QTTS_IN_SILU = 2 };

// The GEMV input transform, in two parts so that K1's in-block prologue and
// K4's row kernel compute the same values op for op:
//   IN_NORM:  RMSNorm(in) * norm_w          (in: [K])
//   IN_PLAIN: in                            (in: [K])
//   IN_SILU:  silu(in[:K]) * in[K:2K]       (in: [2K], gate | up)
// qtts_prep_scale is block-wide (every thread calls it): the RMS factor.
template <int IN_MODE>
static __device__ __forceinline__ float qtts_prep_scale(const float* in,
                                                        float eps, int K) {
  if (IN_MODE != QTTS_IN_NORM) return 0.f;
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = in[k];
    ss += v * v;
  }
  ss = qtts_block_reduce(ss, QttsSumF());
  return rsqrtf(ss / (float)K + eps);
}

template <int IN_MODE>
static __device__ __forceinline__ float qtts_prep_value(const float* in,
                                                        const float* __restrict__ norm_w,
                                                        float r, int K, int k) {
  if (IN_MODE == QTTS_IN_NORM) return (in[k] * r) * norm_w[k];
  if (IN_MODE == QTTS_IN_PLAIN) return in[k];
  const float g = in[k];
  const float u = in[K + k];
  return g * (1.f / (1.f + expf(-g))) * u;
}

// Loads a GEMV input vector into shared memory as bf16-rounded float32 (the
// lhs rounding of the reference's bf16 x bf16 -> f32 unit product); raw, if
// given, gets the float32 values before the rounding.  The activation
// pointers of this and the bodies below carry no __restrict__: K7 rewrites
// them inside its one launch, where a read-only-cache load would be stale.
template <int IN_MODE>
static __device__ __forceinline__ void qtts_gemv_prologue(
    const float* in, const float* __restrict__ norm_w, float eps, int K, float* sh,
    float* raw = nullptr) {
  const float r = qtts_prep_scale<IN_MODE>(in, eps, K);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = qtts_prep_value<IN_MODE>(in, norm_w, r, K, k);
    if (raw != nullptr) raw[k] = v;
    sh[k] = qtts_bf16_round(v);
  }
  __syncthreads();
}

// The GEMV epilogue: out (+)= acc * scale, rounded as the plain version's
// separate product and sum (no fused multiply-add).
template <bool ACCUM>
static __device__ __forceinline__ void qtts_gemv_store(float* out, float acc, float scale) {
  const float v = __fmul_rn(acc, scale);
  *out = ACCUM ? __fadd_rn(*out, v) : v;
}

constexpr int QTTS_GEMV_THREADS = 256;
constexpr int QTTS_GEMV_RPW = 2;  // output rows per warp
constexpr int QTTS_GEMV_ROWS = (QTTS_GEMV_THREADS / 32) * QTTS_GEMV_RPW;

// Dot products of QTTS_GEMV_RPW rows [n0, n0 + RPW) of W [N, K] int8 with the
// shared input; each lane streams 16-byte chunks.  Returns the float32 dots
// (before the column scale) valid on every lane.
// WT: int8 rows, or bf16 rows (a lane's 16 columns as two 16-byte loads, in
// the same FMA order: both convert exactly to float).
template <typename WT = int8_t>
static __device__ __forceinline__ void qtts_gemv_rows(
    const WT* __restrict__ W, const float* sh, int N, int K, int n0,
    float (&acc)[QTTS_GEMV_RPW]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < QTTS_GEMV_RPW; ++r) acc[r] = 0.f;
  for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
    float hv[16];
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(sh + k0 + i);
      hv[i] = t4.x;
      hv[i + 1] = t4.y;
      hv[i + 2] = t4.z;
      hv[i + 3] = t4.w;
    }
#pragma unroll
    for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
      const int n = n0 + r;
      if (n >= N) continue;
      if constexpr (sizeof(WT) == 2) {
        const int4* wp = reinterpret_cast<const int4*>(W + (size_t)n * K + k0);
        const int4 lo = __ldg(wp), hi = __ldg(wp + 1);
        const uint32_t words[8] = {(uint32_t)lo.x, (uint32_t)lo.y, (uint32_t)lo.z, (uint32_t)lo.w,
                                   (uint32_t)hi.x, (uint32_t)hi.y, (uint32_t)hi.z, (uint32_t)hi.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const uint32_t w = words[e >> 1];
          const float wf = __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
          acc[r] = fmaf(hv[e], wf, acc[r]);
        }
      } else {
        const int4 wv = __ldg(reinterpret_cast<const int4*>(W + (size_t)n * K + k0));
        const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z,
                                   (uint32_t)wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float wf = (float)(int8_t)(uint8_t)(words[q] >> (8 * b));
            acc[r] = fmaf(hv[q * 4 + b], wf, acc[r]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < QTTS_GEMV_RPW; ++r) acc[r] = qtts_warp_reduce(acc[r], QttsSumF());
}

// Row group `group` (QTTS_GEMV_ROWS output rows) of the B=1 GEMV, run by a
// whole block of QTTS_GEMV_THREADS threads:
//   out[n] (+)= scale[n] * sum_k bf16(in'[k]) * W[n, k]
// for the input transform IN_MODE (see qtts_gemv_prologue); ACCUM adds into
// out (the residual).  sh: K floats of shared memory; raw: see
// qtts_gemv_prologue (written by group 0).  K1's GEMV kernel is this body at
// group = blockIdx.x; K7 walks the groups in a persistent block.  WT: int8
// rows, or bf16 rows (the composition's bf16 lm_head, chip_smoke.py).
template <int IN_MODE, bool ACCUM, typename WT = int8_t>
static __device__ __forceinline__ void qtts_gemv_i8_body(
    const float* in, const float* __restrict__ norm_w, float eps,
    const WT* __restrict__ W, const float* __restrict__ scale, float* out, int N, int K,
    int group, float* sh, float* raw = nullptr) {
  qtts_gemv_prologue<IN_MODE>(in, norm_w, eps, K, sh, group == 0 ? raw : nullptr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = group * QTTS_GEMV_ROWS + warp * QTTS_GEMV_RPW;
  float acc[QTTS_GEMV_RPW];
  qtts_gemv_rows(W, sh, N, K, n0, acc);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
      const int n = n0 + r;
      if (n < N) qtts_gemv_store<ACCUM>(out + n, acc[r], scale[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// Split attention of one decode step, shared by K1 (one row, host position)
// and K4 (B rows, per-row device positions).  Internal linkage: each
// translation unit that launches them keeps its own copy.
// ---------------------------------------------------------------------------

namespace {

template <typename CT>
__device__ __forceinline__ CT qtts_to_cache(float x);
template <>
__device__ __forceinline__ float qtts_to_cache<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 qtts_to_cache<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float qtts_from_cache(float x) { return x; }
__device__ __forceinline__ float qtts_from_cache(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void qtts_load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void qtts_load4(const __nv_bfloat16* p, float (&o)[4]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  o[0] = fa.x; o[1] = fa.y; o[2] = fb.x; o[3] = fb.y;
}
__device__ __forceinline__ void qtts_load4(const int8_t* p, float (&o)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = (float)c.x; o[1] = (float)c.y; o[2] = (float)c.z; o[3] = (float)c.w;
}

// The int8 KV cache (the JAX kernels' kvq mode): int8 values with one float32
// scale per (slot, kv head) in [L, B, nk, T] arrays beside the cache, on
// models/layers.py::quantize_kv's grid: scale = max(amax / 127, 1e-8), q =
// clip(rint(x / scale), -127, 127), the division an IEEE one (the build has no
// fast math) and rint rounding half to even, as jnp.round and torch.round do.
// The attention multiplies a slot's score by its k scale after the 1/sqrt(D)
// factor and its softmax weight by its v scale before the weighted sum; the
// normaliser sums the weights without it.
template <typename CT>
constexpr bool qtts_int8_cache = std::is_same<CT, int8_t>::value;

__device__ __forceinline__ float qtts_quant8(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
}

// The int8 scales of the head vectors k and v of the item's QTTS_ATTN_D
// threads (element t each): max |x| by the warp butterfly, then warp 0's over
// the four warp maxima (qtts_group_sum's tree; a max is exact in any order).
// red: 10 floats, free until the caller's next barrier.
template <typename Sync>
__device__ __forceinline__ float2 qtts_kv_scales(float k, float v, float* red, Sync sync, int t) {
  constexpr int nw = QTTS_ATTN_D / 32;
  const int lane = t & 31, warp = t >> 5;
  const float ka = qtts_warp_reduce(fabsf(k), QttsMaxF());
  const float va = qtts_warp_reduce(fabsf(v), QttsMaxF());
  if (lane == 0) {
    red[warp] = ka;
    red[nw + warp] = va;
  }
  sync();
  if (warp == 0) {
    const float rk = qtts_warp_reduce(lane < nw ? red[lane] : 0.f, QttsMaxF());
    const float rv = qtts_warp_reduce(lane < nw ? red[nw + lane] : 0.f, QttsMaxF());
    if (lane == 0) {
      red[2 * nw] = fmaxf(rk / 127.f, 1e-8f);
      red[2 * nw + 1] = fmaxf(rv / 127.f, 1e-8f);
    }
  }
  sync();
  return make_float2(red[2 * nw], red[2 * nw + 1]);
}

// Position of launch row r.  S rows share one cache row (K1 and K4: S = 1;
// K6's verify: row r is candidate s = r % S of cache row b = r / S): the
// cache row's start from the device array, clamped into [0, T - S] (an idle
// pool slot keeps stepping past the end; the JAX wrappers clamp likewise),
// else the host start, plus s.
__device__ __forceinline__ int qtts_row_pos(const int64_t* pos_dev, int pos_host, int r, int T,
                                            int S) {
  const int s = r % S;
  if (pos_dev == nullptr) return pos_host + s;
  const int64_t p = pos_dev[r / S];
  const int hi = T - S;
  return (p < 0 ? 0 : (p >= hi ? hi : (int)p)) + s;
}

// Shared memory of one attention work item (one block of K1-K6's attention
// launches, one half of a K7 block).
struct QttsAttnSmem {
  float q_s[QTTS_ATTN_MAX_G][QTTS_ATTN_D];
  float k_s[QTTS_ATTN_D];
  float v_s[QTTS_ATTN_D];
  float wm[4][QTTS_ATTN_MAX_G];
  float wl[4][QTTS_ATTN_MAX_G];
  float wacc[4][QTTS_ATTN_MAX_G][QTTS_ATTN_D];
  float red[33];
};

// Sum over the item's QTTS_ATTN_D threads (t: the thread's index among
// them), in qtts_block_reduce's order for a 128-thread block.
template <typename Sync>
__device__ __forceinline__ float qtts_group_sum(float v, float* red, Sync sync, int t) {
  constexpr int nw = QTTS_ATTN_D / 32;
  const int lane = t & 31, warp = t >> 5;
  v = qtts_warp_reduce(v, QttsSumF());
  if (lane == 0) red[warp] = v;
  sync();
  if (warp == 0) {
    float r = lane < nw ? red[lane] : QttsSumF::identity();
    r = qtts_warp_reduce(r, QttsSumF());
    if (lane == 0) red[32] = r;
  }
  sync();
  const float out = red[32];
  sync();
  return out;
}

// RMSNorm of one head vector, element t of the item's D threads: (v * r) * w.
template <typename Sync>
__device__ __forceinline__ float qtts_head_norm(float v, float w, float eps, float* red, Sync sync,
                                                int t) {
  const float ss = qtts_group_sum(v * v, red, sync, t);
  const float r = rsqrtf(ss / (float)QTTS_ATTN_D + eps);
  return (v * r) * w;
}

// Rotate-half RoPE of the pair (x1, x2) by the angle with cosine c and sine
// s, each product and sum rounded on its own (no fused multiply-add), so that
// every kernel that rotates a head does it with the same bits.
__device__ __forceinline__ void qtts_rope_pair(float& x1, float& x2, float c, float s) {
  const float a = x1, b = x2;
  x1 = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
  x2 = __fadd_rn(__fmul_rn(b, c), __fmul_rn(a, s));
}

// Work item (h, split, r) of the split attention, on QTTS_ATTN_D threads (t:
// the thread's index among them, sync: their barrier, sm: their shared
// memory): normalises and rotates kv head h's q heads of launch row r (cache
// row r / S, position pos = qtts_row_pos), takes slots
// [split*CHUNK, min((split+1)*CHUNK, pos+1)) and writes the split's softmax
// partials.  A split past the row's position returns at once (the combine
// never reads it).  qtts_attn_split_kernel runs item (blockIdx.x,
// blockIdx.y, blockIdx.z) on a block of its own.
//
// TAIL_IN_CACHE = false (K1, K4; S = 1): the block also normalises and
// rotates k, and the new slot's k/v come from registers, rounded to the cache
// dtype so they equal what the cache holds; split 0 alone writes them, and no
// block reads slot pos from memory, so the write never races a read.
// TAIL_IN_CACHE = true (K6): row r reads slots pos - s .. pos, which rows of
// other blocks write, so qtts_kv_write_kernel stores every new slot in an
// earlier launch and every slot comes from memory here.
template <typename CT, bool TAIL_IN_CACHE, typename Sync>
__device__ __forceinline__ void qtts_attn_split_body(
    QttsAttnSmem& sm, Sync sync, int t, int h, int split, int r,
    const float* qkv, int qkv_ld, const float* __restrict__ q_norm,
    const float* __restrict__ k_norm, const float* __restrict__ inv_freq, CT* __restrict__ kc,
    CT* __restrict__ vc, size_t cache_row, float* __restrict__ part, int nq, int nk, int T,
    const int64_t* __restrict__ pos_dev, int pos_host, int S, int max_splits, float eps,
    float scale) {
  constexpr int D = QTTS_ATTN_D;
  constexpr int G = QTTS_ATTN_MAX_G;
  auto& q_s = sm.q_s;
  auto& k_s = sm.k_s;
  auto& v_s = sm.v_s;
  auto& wm = sm.wm;
  auto& wl = sm.wl;
  auto& wacc = sm.wacc;

  const int pos = qtts_row_pos(pos_dev, pos_host, r, T, S);
  if (split * QTTS_ATTN_CHUNK > pos) return;
  qkv += (size_t)r * qkv_ld;
  kc += (size_t)(r / S) * cache_row;
  vc += (size_t)(r / S) * cache_row;
  part += (size_t)r * nq * max_splits * (D + 2);
  const int g = nq / nk;
  const int qd = nq * D, kvd = nk * D;

  for (int gi = 0; gi < g; ++gi) {
    q_s[gi][t] = qtts_head_norm(qkv[(h * g + gi) * D + t], q_norm[t], eps, sm.red, sync, t);
  }
  if (!TAIL_IN_CACHE) {
    k_s[t] = qtts_head_norm(qkv[qd + h * D + t], k_norm[t], eps, sm.red, sync, t);
    v_s[t] = qkv[qd + kvd + h * D + t];
  }
  sync();
  if (t < D / 2) {
    const float ang = (float)pos * inv_freq[t];
    const float c = cosf(ang), s = sinf(ang);
    for (int gi = 0; gi < g; ++gi) qtts_rope_pair(q_s[gi][t], q_s[gi][t + D / 2], c, s);
    if (!TAIL_IN_CACHE) qtts_rope_pair(k_s[t], k_s[t + D / 2], c, s);
  }
  sync();
  if (!TAIL_IN_CACHE) {
    const CT kq = qtts_to_cache<CT>(k_s[t]);
    const CT vq = qtts_to_cache<CT>(v_s[t]);
    k_s[t] = qtts_from_cache(kq);
    v_s[t] = qtts_from_cache(vq);
    if (split == 0) {
      kc[((size_t)h * T + pos) * D + t] = kq;
      vc[((size_t)h * T + pos) * D + t] = vq;
    }
    sync();
  }

  const int warp = t >> 5, lane = t & 31;
  float qr[G][4];
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = QTTS_NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[gi][e] = 0.f;
      qr[gi][e] = gi < g ? q_s[gi][lane * 4 + e] : 0.f;
    }
  }
  const int start = split * QTTS_ATTN_CHUNK;
  const int end = min(start + QTTS_ATTN_CHUNK, pos + 1);
  for (int j = start + warp; j < end; j += 4) {
    float kf[4], vf[4];
    if (!TAIL_IN_CACHE && j == pos) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kf[e] = k_s[lane * 4 + e];
        vf[e] = v_s[lane * 4 + e];
      }
    } else {
      qtts_load4(kc + ((size_t)h * T + j) * D + lane * 4, kf);
      qtts_load4(vc + ((size_t)h * T + j) * D + lane * 4, vf);
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < g) {
        float d = qr[gi][0] * kf[0] + qr[gi][1] * kf[1] + qr[gi][2] * kf[2] + qr[gi][3] * kf[3];
        d = qtts_warp_reduce(d, QttsSumF());
        const float sc = d * scale;
        const float mn = fmaxf(m[gi], sc);
        const float alpha = expf(m[gi] - mn);
        const float p = expf(sc - mn);
        l[gi] = l[gi] * alpha + p;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][e] = acc[gi][e] * alpha + p * vf[e];
        m[gi] = mn;
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      if (lane == 0) {
        wm[warp][gi] = m[gi];
        wl[warp][gi] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) wacc[warp][gi][lane * 4 + e] = acc[gi][e];
    }
  }
  sync();
  for (int gi = 0; gi < g; ++gi) {
    float M = wm[0][gi];
    for (int w = 1; w < 4; ++w) M = fmaxf(M, wm[w][gi]);
    float L = 0.f, o = 0.f;
    for (int w = 0; w < 4; ++w) {
      const float f = expf(wm[w][gi] - M);
      L += wl[w][gi] * f;
      o += wacc[w][gi][t] * f;
    }
    float* dst = part + ((size_t)(h * g + gi) * max_splits + split) * (D + 2);
    if (t == 0) {
      dst[0] = M;
      dst[1] = L;
    }
    dst[2 + t] = o;
  }
}

template <typename CT, bool TAIL_IN_CACHE>
__global__ void __launch_bounds__(QTTS_ATTN_D)
qtts_attn_split_kernel(const float* __restrict__ qkv, int qkv_ld,
                       const float* __restrict__ q_norm, const float* __restrict__ k_norm,
                       const float* __restrict__ inv_freq, CT* __restrict__ kc,
                       CT* __restrict__ vc, size_t cache_row, float* __restrict__ part,
                       int nq, int nk, int T, const int64_t* __restrict__ pos_dev,
                       int pos_host, int S, int max_splits, float eps, float scale) {
  __shared__ QttsAttnSmem sm;
  qtts_attn_split_body<CT, TAIL_IN_CACHE>(sm, QttsBlockSync(), threadIdx.x, blockIdx.x,
                                          blockIdx.y, blockIdx.z, qkv, qkv_ld, q_norm, k_norm,
                                          inv_freq, kc, vc, cache_row, part, nq, nk, T, pos_dev,
                                          pos_host, S, max_splits, eps, scale);
}

// Work item (h, r) of the K6 slot write, on QTTS_ATTN_D threads: normalises
// and rotates kv head h's k of launch row r at its position, with the split
// body's helpers and so its bits, and stores k and v there, rounded to the
// cache dtype, or on an int8 cache quantized with their scales (the
// attention item's arithmetic: K1's values) into ks / vs [B / S, nk, T].
// qtts_kv_write_kernel: grid (nk, R), one item per block.
template <typename CT, typename Sync>
__device__ __forceinline__ void qtts_kv_write_body(
    QttsAttnSmem& sm, Sync sync, int t, int h, int r, const float* qkv, int qkv_ld,
    const float* __restrict__ k_norm, const float* __restrict__ inv_freq, CT* __restrict__ kc,
    CT* __restrict__ vc, size_t cache_row, int nq, int nk, int T,
    const int64_t* __restrict__ pos_dev, int pos_host, int S, float eps,
    float* __restrict__ ks = nullptr, float* __restrict__ vs = nullptr) {
  constexpr int D = QTTS_ATTN_D;
  float* k_s = sm.k_s;
  const int pos = qtts_row_pos(pos_dev, pos_host, r, T, S);
  qkv += (size_t)r * qkv_ld;
  const int qd = nq * D, kvd = nk * D;
  k_s[t] = qtts_head_norm(qkv[qd + h * D + t], k_norm[t], eps, sm.red, sync, t);
  const float v = qkv[qd + kvd + h * D + t];
  sync();
  if (t < D / 2) {
    const float ang = (float)pos * inv_freq[t];
    qtts_rope_pair(k_s[t], k_s[t + D / 2], cosf(ang), sinf(ang));
  }
  sync();
  const size_t at = (size_t)(r / S) * cache_row + ((size_t)h * T + pos) * D + t;
  if constexpr (qtts_int8_cache<CT>) {
    const float k = k_s[t];
    const float2 sc = qtts_kv_scales(k, v, sm.red, sync, t);
    kc[at] = (int8_t)qtts_quant8(k, sc.x);
    vc[at] = (int8_t)qtts_quant8(v, sc.y);
    if (t == 0) {
      const size_t si = ((size_t)(r / S) * nk + h) * T + pos;
      ks[si] = sc.x;
      vs[si] = sc.y;
    }
  } else {
    kc[at] = qtts_to_cache<CT>(k_s[t]);
    vc[at] = qtts_to_cache<CT>(v);
  }
}

template <typename CT>
__global__ void __launch_bounds__(QTTS_ATTN_D)
qtts_kv_write_kernel(const float* __restrict__ qkv, int qkv_ld,
                     const float* __restrict__ k_norm, const float* __restrict__ inv_freq,
                     CT* __restrict__ kc, CT* __restrict__ vc, size_t cache_row, int nq, int nk,
                     int T, const int64_t* __restrict__ pos_dev, int pos_host, int S,
                     float eps) {
  __shared__ QttsAttnSmem sm;
  qtts_kv_write_body<CT>(sm, QttsBlockSync(), threadIdx.x, blockIdx.x, blockIdx.y, qkv, qkv_ld,
                         k_norm, inv_freq, kc, vc, cache_row, nq, nk, T, pos_dev, pos_host, S,
                         eps);
}

__device__ __forceinline__ void qtts_store_attn(float* p, float v) { *p = v; }
__device__ __forceinline__ void qtts_store_attn(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Work item (hq, r) of the combine, thread t of QTTS_ATTN_D (no barrier):
// merges launch row r's partials of q head hq into attn[r, hq*D:(hq+1)*D]
// (float32 for K1's prologue, bf16 for the batched GEMV).
// qtts_attn_combine_kernel: grid (nq, R), one item per block.
template <typename OT>
__device__ __forceinline__ void qtts_attn_combine_body(
    int t, int hq, int r, const float* part, OT* __restrict__ attn, int nq,
    int max_splits, int T, const int64_t* __restrict__ pos_dev, int pos_host, int S) {
  constexpr int D = QTTS_ATTN_D;
  const int n_splits = qtts_row_pos(pos_dev, pos_host, r, T, S) / QTTS_ATTN_CHUNK + 1;
  const float* base = part + ((size_t)r * nq + hq) * max_splits * (D + 2);
  float M = QTTS_NEG_INF;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, base[s * (D + 2)]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float f = expf(base[s * (D + 2)] - M);
    L += base[s * (D + 2) + 1] * f;
    o += base[s * (D + 2) + 2 + t] * f;
  }
  qtts_store_attn(attn + ((size_t)r * nq + hq) * D + t, o / L);
}

template <typename OT>
__global__ void __launch_bounds__(QTTS_ATTN_D)
qtts_attn_combine_kernel(const float* __restrict__ part, OT* __restrict__ attn, int nq,
                         int max_splits, int T, const int64_t* __restrict__ pos_dev,
                         int pos_host, int S) {
  qtts_attn_combine_body<OT>(threadIdx.x, blockIdx.x, blockIdx.y, part, attn, nq, max_splits, T,
                             pos_dev, pos_host, S);
}

// Launches the attention of layer l for R launch rows, S of them per cache
// row: for S = 1 the split attention (new slot from registers) and the
// combine; for S > 1 first the write of every row's new slot, then the split
// attention reading them from the cache, then the combine.
template <typename CT, typename OT>
cudaError_t qtts_launch_attention(const QttsStepWeights& w, int l, const float* qkv,
                                  float* part, int max_splits, OT* attn, CT* kc, CT* vc,
                                  int R, int S, int T, const int64_t* pos_dev, int pos_host,
                                  int n_splits, cudaStream_t st) {
  const size_t row = (size_t)w.nk * T * w.D;
  const int A = (w.nq + 2 * w.nk) * w.D;
  const float* q_norm = w.q_norm + (size_t)l * w.D;
  const float* k_norm = w.k_norm + (size_t)l * w.D;
  const size_t layer = (size_t)l * (R / S) * row;
  if (S == 1) {
    qtts_attn_split_kernel<CT, false><<<dim3(w.nk, n_splits, R), QTTS_ATTN_D, 0, st>>>(
        qkv, A, q_norm, k_norm, w.inv_freq, kc + layer, vc + layer, row, part, w.nq, w.nk, T,
        pos_dev, pos_host, 1, max_splits, w.eps, w.attn_scale);
  } else {
    qtts_kv_write_kernel<CT><<<dim3(w.nk, R), QTTS_ATTN_D, 0, st>>>(
        qkv, A, k_norm, w.inv_freq, kc + layer, vc + layer, row, w.nq, w.nk, T, pos_dev,
        pos_host, S, w.eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    qtts_attn_split_kernel<CT, true><<<dim3(w.nk, n_splits, R), QTTS_ATTN_D, 0, st>>>(
        qkv, A, q_norm, k_norm, w.inv_freq, kc + layer, vc + layer, row, part, w.nq, w.nk, T,
        pos_dev, pos_host, S, max_splits, w.eps, w.attn_scale);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  qtts_attn_combine_kernel<OT><<<dim3(w.nq, R), QTTS_ATTN_D, 0, st>>>(
      part, attn, w.nq, max_splits, T, pos_dev, pos_host, S);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The in-chain sampler (K2 and K5): one block draws one index from its row.
// ---------------------------------------------------------------------------

// Samples one index from logits lg[0..V) (in shared memory, overwritten), the
// float32 op sequence of gumbel_topk_topp_sample.  pr: [V] shared scratch;
// gumbel: the row's [V] noise (unread when greedy).  Block-wide.
static __device__ int qtts_sample_index(float* lg, float* pr, int V, const float* gumbel,
                                        float temperature, int top_k, float top_p,
                                        int greedy) {
  const int tid = threadIdx.x;
  if (greedy) return qtts_block_argmax_first(lg, V);
  for (int v = tid; v < V; v += blockDim.x) lg[v] = lg[v] / temperature;
  __syncthreads();
  // top-k: threshold = the top_k-th largest, by bisection (ties kept)
  float lmin = QttsMinF::identity(), lmax = QttsMaxF::identity();
  for (int v = tid; v < V; v += blockDim.x) {
    lmin = fminf(lmin, lg[v]);
    lmax = fmaxf(lmax, lg[v]);
  }
  float lo = qtts_block_reduce(lmin, QttsMinF());
  float hi = qtts_block_reduce(lmax, QttsMaxF());
  for (int it = 0; it < 40; ++it) {
    const float mid = 0.5f * (lo + hi);
    int cnt = 0;
    for (int v = tid; v < V; v += blockDim.x) cnt += lg[v] >= mid ? 1 : 0;
    cnt = qtts_block_reduce(cnt, QttsSumI());
    if (cnt >= top_k) lo = mid; else hi = mid;
  }
  const bool k_active = top_k > 0 && top_k < V;
  for (int v = tid; v < V; v += blockDim.x) {
    const float s = lg[v];
    lg[v] = (s >= lo || !k_active) ? s : QTTS_NEG_INF;
  }
  __syncthreads();
  // softmax of the masked logits
  float mloc = QttsMaxF::identity();
  for (int v = tid; v < V; v += blockDim.x) mloc = fmaxf(mloc, lg[v]);
  const float mm = qtts_block_reduce(mloc, QttsMaxF());
  float sloc = 0.f;
  for (int v = tid; v < V; v += blockDim.x) {
    const float e = expf(lg[v] - mm);
    pr[v] = e;
    sloc += e;
  }
  const float se = qtts_block_reduce(sloc, QttsSumF());
  for (int v = tid; v < V; v += blockDim.x) pr[v] = pr[v] / se;
  __syncthreads();
  // top-p: keep i iff the mass of strictly larger probs is < top_p
  float plo = 0.f, phi = 1.f;
  for (int it = 0; it < 40; ++it) {
    const float mid = 0.5f * (plo + phi);
    float s = 0.f;
    for (int v = tid; v < V; v += blockDim.x) s += pr[v] > mid ? pr[v] : 0.f;
    s = qtts_block_reduce(s, QttsSumF());
    if (s < top_p) phi = mid; else plo = mid;
  }
  const bool p_off = top_p >= 1.f;
  for (int v = tid; v < V; v += blockDim.x) {
    const float fin = (pr[v] > plo || p_off) ? lg[v] : QTTS_NEG_INF;
    lg[v] = fin + gumbel[v];
  }
  __syncthreads();
  return qtts_block_argmax_first(lg, V);
}

// ---------------------------------------------------------------------------
// The B=1 chain (K2, fused_mtp.cu; K3, fused_mtp_stream.cu): one head kernel
// per step between the trunk passes.  Each translation unit launches its own
// head kernel, built from the two halves below.
// ---------------------------------------------------------------------------

namespace {

struct QttsHeadStep {
  const float* x;              // [H] trunk output, pre-final-norm
  const float* final_norm;     // [H]
  float eps;
  const int8_t* W;             // [V, H] this step's head
  const float* scale;          // [V]
  const float* gumbel;         // [V]
  const __nv_bfloat16* table;  // [Vt, H] this step's embedding table
  float* logits;               // [V]
  uint32_t* counter;
  int32_t* subcodes;
  float* sub_sum;              // [H]
  float* x_next;               // [H]
  int j, V, H;
  float temperature;
  int top_k;
  float top_p;
  int greedy;
};

// First half, every block: QTTS_GEMV_ROWS head rows of
// bf16(RMSNorm(x) * final_norm) @ bf16(W) * scale into p.logits, then an
// atomic ticket.  Returns the block's ticket (gridDim.x - 1 for the last
// block to finish).  sh: max(H, 2V) floats of dynamic shared memory.
__device__ __forceinline__ unsigned qtts_head_rows(const QttsHeadStep& p, float* sh) {
  __shared__ unsigned ticket;
  qtts_gemv_i8_body<QTTS_IN_NORM, false>(p.x, p.final_norm, p.eps, p.W, p.scale, p.logits, p.V,
                                         p.H, blockIdx.x, sh);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(p.counter, 1u);
  __syncthreads();
  return ticket;
}

// The sampler on the whole logits row (read from L2), the sub-code written,
// and the embedding row gathered into sub_sum and the next trunk input; one
// block (K7 runs it after a grid barrier).
__device__ __forceinline__ void qtts_head_pick(const QttsHeadStep& p, float* sh) {
  float* lg = sh;
  float* pr = sh + p.V;
  for (int v = threadIdx.x; v < p.V; v += blockDim.x) lg[v] = __ldcg(p.logits + v);
  __syncthreads();
  const int sub = qtts_sample_index(lg, pr, p.V, p.gumbel, p.temperature, p.top_k,
                                    p.top_p, p.greedy);
  if (threadIdx.x == 0) p.subcodes[p.j] = sub;
  const size_t row = (size_t)sub * p.H;
  for (int k = threadIdx.x; k < p.H; k += blockDim.x) {
    const float e = __bfloat162float(p.table[row + k]);
    p.sub_sum[k] = p.j == 0 ? e : p.sub_sum[k] + e;
    p.x_next[k] = e;
  }
}

// Second half, the last block only: qtts_head_pick and the ticket counter
// reset.
__device__ __forceinline__ void qtts_head_sample(const QttsHeadStep& p, float* sh) {
  __threadfence();
  qtts_head_pick(p, sh);
  if (threadIdx.x == 0) *p.counter = 0u;
}

// The whole chain: two prefix trunk passes at positions 0 and 1 (talker
// hidden, then codec_embed(code0)) into the 17-slot cache, then per step j a
// head kernel, launched by launch_head(step, next_pass, grid, smem, stream)
// (next_pass: a trunk pass follows this step), and a trunk pass on the
// sampled embedding at position 2 + j (not after the last step).
template <typename LaunchHead>
int qtts_run_mtp_chain(const QttsStepWeights& w, const QttsStepScratch& s,
                       const QttsChainArgs& a, cudaStream_t st, LaunchHead launch_head) {
  const int T = a.n + 2, H = w.H, V = a.V;
  if (H % 16 != 0 || V > a.Vt) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(H > 2 * V ? H : 2 * V) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (V + QTTS_GEMV_ROWS - 1) / QTTS_GEMV_ROWS;

  int err = qtts_launch_decode_step(w, s, a.last_hidden, a.x, a.k_cache, a.v_cache,
                                    a.cache_bf16, T, 0, st);
  if (err) return err;
  err = qtts_launch_decode_step(w, s, a.code0_embed, a.x, a.k_cache, a.v_cache,
                                a.cache_bf16, T, 1, st);
  if (err) return err;
  for (int j = 0; j < a.n; ++j) {
    QttsHeadStep p;
    p.x = a.x;
    p.final_norm = a.final_norm;
    p.eps = w.eps;
    p.W = a.heads + (size_t)j * V * H;
    p.scale = a.head_scales + (size_t)j * V;
    p.gumbel = a.gumbel + (size_t)j * V;
    p.table = a.tables + (size_t)j * a.Vt * H;
    p.logits = a.logits;
    p.counter = a.counter;
    p.subcodes = a.subcodes;
    p.sub_sum = a.sub_sum;
    p.x_next = a.x_in;
    p.j = j;
    p.V = V;
    p.H = H;
    p.temperature = a.temperature;
    p.top_k = a.top_k;
    p.top_p = a.top_p;
    p.greedy = a.greedy;
    launch_head(p, j + 1 < a.n, grid, smem, st);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (j + 1 < a.n) {
      err = qtts_launch_decode_step(w, s, a.x_in, a.x, a.k_cache, a.v_cache,
                                    a.cache_bf16, T, 2 + j, st);
      if (err) return err;
    }
  }
  return (int)cudaSuccess;
}

}  // namespace
