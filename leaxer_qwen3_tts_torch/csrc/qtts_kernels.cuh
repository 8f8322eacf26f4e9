// Shared declarations and device helpers of the hand-written Hopper kernels.
//
// The structs below are mirrored field for field by ctypes.Structure classes
// in leaxer_qwen3_tts_torch/ops/_build.py; keep the two in the same order.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

// Per-layer-stacked int8 weights of one transformer (Hopper pack layout: every
// matrix is stored [N, K], one output row per N with its K bytes contiguous).
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
};

constexpr int QTTS_ATTN_D = 128;      // head_dim the attention kernel takes
constexpr int QTTS_ATTN_CHUNK = 64;   // cache slots per attention split
constexpr int QTTS_ATTN_MAX_G = 8;    // max q heads per kv head
constexpr float QTTS_NEG_INF = -1e30f;

// One decode step through all L layers (fused_step.cu).  x_in is copied to
// x first; x then carries the float32 residual stream and ends pre-final-norm.
int qtts_launch_decode_step(const QttsStepWeights& w, const QttsStepScratch& s,
                            const float* x_in, float* x, void* k_cache,
                            void* v_cache, int cache_bf16, int T, int pos,
                            cudaStream_t stream);

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------

static __device__ __forceinline__ float qtts_bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// Loads a GEMV input vector into shared memory as bf16-rounded float32 (the
// lhs rounding of the reference's bf16 x bf16 -> f32 unit product):
//   IN_NORM:  RMSNorm(in) * norm_w          (in: [K])
//   IN_PLAIN: in                            (in: [K])
//   IN_SILU:  silu(in[:K]) * in[K:2K]       (in: [2K], gate | up)
template <int IN_MODE>
static __device__ __forceinline__ void qtts_gemv_prologue(
    const float* __restrict__ in, const float* __restrict__ norm_w, float eps,
    int K, float* sh) {
  const int tid = threadIdx.x;
  if (IN_MODE == QTTS_IN_NORM) {
    float ss = 0.f;
    for (int k = tid; k < K; k += blockDim.x) {
      const float v = in[k];
      ss += v * v;
    }
    ss = qtts_block_reduce(ss, QttsSumF());
    const float r = rsqrtf(ss / (float)K + eps);
    for (int k = tid; k < K; k += blockDim.x) sh[k] = qtts_bf16_round((in[k] * r) * norm_w[k]);
  } else if (IN_MODE == QTTS_IN_PLAIN) {
    for (int k = tid; k < K; k += blockDim.x) sh[k] = qtts_bf16_round(in[k]);
  } else {
    for (int k = tid; k < K; k += blockDim.x) {
      const float g = in[k];
      const float u = in[K + k];
      sh[k] = qtts_bf16_round(g * (1.f / (1.f + expf(-g))) * u);
    }
  }
  __syncthreads();
}

constexpr int QTTS_GEMV_THREADS = 256;
constexpr int QTTS_GEMV_RPW = 2;  // output rows per warp
constexpr int QTTS_GEMV_ROWS = (QTTS_GEMV_THREADS / 32) * QTTS_GEMV_RPW;

// Dot products of QTTS_GEMV_RPW rows [n0, n0 + RPW) of W [N, K] int8 with the
// shared input; each lane streams 16-byte chunks.  Returns the float32 dots
// (before the column scale) valid on every lane.
static __device__ __forceinline__ void qtts_gemv_rows(
    const int8_t* __restrict__ W, const float* sh, int N, int K, int n0,
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
      if (n < N) {
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
