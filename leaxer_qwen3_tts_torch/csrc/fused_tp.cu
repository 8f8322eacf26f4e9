// Kernel K9: one rank's two halves of the tensor-parallel decode step.
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_tp.py::fused_decode_step_tp, whose
// shard_map runs two Pallas kernels per layer on each chip's Megatron shard
// (_make_attn_half, _make_mlp_half) with a psum after each.  Same function,
// per (layer, rank), on the rank's shard and device:
//   K9a, the attention half (qtts_tp_attn_half): RMSNorm of x [H]; the qkv
//     units (bf16 x, int8 rows as bf16, float32 sums, times the unit
//     column's scale); q/k RMSNorm and RoPE at pos; the new K/V slot written
//     in the cache dtype; GQA attention over slots 0..pos reading the slot as
//     written; the K-split wo partial dx [H], chunk sums in chunk order.
//   K9b, the MLP half (qtts_tp_mlp_half): RMSNorm; the gate|up units;
//     silu(gate) * up in float32; the K-split down partial dm [H].
// The ranks' partials are summed outside the kernels (ops/fused_tp.py), the
// counterpart of the JAX package's psum, an XLA collective.
//
// Design: a short sequence of launches per half.  K9a: one GEMV launch for
// qkv, the split attention and its combine (K1's launch-per-op kernels from
// qtts_kernels.cuh, on the rank's nq / nk heads and its [nk, T, D] cache
// layer), one GEMV launch for wo; K9b: gate|up, then down with the silu in
// its prologue.  A GEMV block takes 64 output columns of the K-major units
// (qtts_tp_tile: 16 K slices of 16 threads x 4 columns, each thread's four
// columns one 4-byte load per row), recomputes the RMSNorm of its input
// itself, and walks a K-split product's chunks in order.  What bounds it on
// the H100: the shard's int8 weight bytes per layer (the 0.6B talker at
// tp=2: 7.9 MB per layer and rank, 2.4 us at 3.35 TB/s; the ranks share one
// card's HBM when the mesh repeats it); at one token it is latency-bound,
// five launches per layer and rank with 8 to 48 blocks each, plus the host's
// partial sums between halves.  Not done yet: one persistent launch per step
// with the exchange in the kernel (ROADMAP K-speed).

#include "qtts_tp.cuh"

namespace {

template <int IN_MODE>
__global__ void __launch_bounds__(QTTS_TP_THREADS)
tp_gemv_kernel(const float* in, const float* __restrict__ norm_w, float eps, int K,
               const int8_t* __restrict__ W, const float* __restrict__ S, float* out, int N,
               int NU, int KC) {
  extern __shared__ float sh[];
  __shared__ float red[QTTS_TP_SLICES][QTTS_TP_COLS];
  qtts_tp_prologue<IN_MODE>(in, norm_w, eps, K, 0, K, sh);
  const float v = qtts_tp_tile<int8_t>(sh, W, S, N, NU, KC, K / KC, blockIdx.x, red);
  if (threadIdx.x < QTTS_TP_COLS) out[blockIdx.x * QTTS_TP_COLS + threadIdx.x] = v;
}

template <int IN_MODE>
cudaError_t launch_gemv(const float* in, const float* norm_w, float eps, int K,
                        const int8_t* W, const float* S, float* out, int N, int NU, int KC,
                        cudaStream_t st) {
  tp_gemv_kernel<IN_MODE><<<N / QTTS_TP_COLS, QTTS_TP_THREADS, (size_t)K * sizeof(float), st>>>(
      in, norm_w, eps, K, W, S, out, N, NU, KC);
  return cudaGetLastError();
}

// K1's step weights struct over the rank's heads: what qtts_launch_attention reads.
QttsStepWeights attn_view(const QttsTpWeights& w) {
  QttsStepWeights v{};
  v.q_norm = w.q_norm;
  v.k_norm = w.k_norm;
  v.inv_freq = w.inv_freq;
  v.L = w.L;
  v.H = w.H;
  v.nq = w.nq;
  v.nk = w.nk;
  v.D = w.D;
  v.I = w.I;
  v.eps = w.eps;
  v.attn_scale = w.attn_scale;
  return v;
}

}  // namespace

extern "C" {

// Kernel K9a: dx [H] = the rank's attention half of layer l on x [H]; the
// rank's cache [L, 1, nk, T, D] (bf16 or float32) gets the new slot at pos.
int qtts_tp_attn_half(const QttsTpWeights* w, const QttsTpScratch* s, int l, const float* x,
                      float* dx, void* k_cache, void* v_cache, int cache_bf16, int T, int pos,
                      void* stream) {
  const int A = (w->nq + 2 * w->nk) * w->D, qd = w->nq * w->D;
  if (!qtts_tp_shapes_ok(*w) || l < 0 || l >= w->L || pos < 0 || pos >= T ||
      (T - 1) / QTTS_ATTN_CHUNK + 1 > s->max_splits) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Uq = A / w->NU, Uo = (qd / w->KCo) * (w->H / w->NU);
  QTTS_TRY(launch_gemv<QTTS_IN_NORM>(x, w->attn_norm + (size_t)l * w->H, w->eps, w->H,
                                     w->qkv_u + (size_t)l * Uq * w->H * w->NU,
                                     w->qkv_s + (size_t)l * Uq * w->NU, s->qkv, A, w->NU, w->H,
                                     st));
  const QttsStepWeights v = attn_view(*w);
  const int n_splits = pos / QTTS_ATTN_CHUNK + 1;
  cudaError_t e;
  if (cache_bf16) {
    e = qtts_launch_attention<__nv_bfloat16, float>(
        v, l, s->qkv, s->part, s->max_splits, s->attn, static_cast<__nv_bfloat16*>(k_cache),
        static_cast<__nv_bfloat16*>(v_cache), 1, 1, T, nullptr, pos, n_splits, st);
  } else {
    e = qtts_launch_attention<float, float>(
        v, l, s->qkv, s->part, s->max_splits, s->attn, static_cast<float*>(k_cache),
        static_cast<float*>(v_cache), 1, 1, T, nullptr, pos, n_splits, st);
  }
  QTTS_TRY(e);
  QTTS_TRY(launch_gemv<QTTS_IN_PLAIN>(s->attn, nullptr, w->eps, qd,
                                      w->wo_u + (size_t)l * Uo * w->KCo * w->NU,
                                      w->wo_s + (size_t)l * Uo * w->NU, dx, w->H, w->NU, w->KCo,
                                      st));
  return (int)cudaSuccess;
}

// Kernel K9b: dm [H] = the rank's MLP half of layer l on x [H].
int qtts_tp_mlp_half(const QttsTpWeights* w, const QttsTpScratch* s, int l, const float* x,
                     float* dm, void* stream) {
  if (!qtts_tp_shapes_ok(*w) || l < 0 || l >= w->L) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Ug = 2 * w->I / w->NU, Ud = (w->I / w->KCd) * (w->H / w->NU);
  QTTS_TRY(launch_gemv<QTTS_IN_NORM>(x, w->mlp_norm + (size_t)l * w->H, w->eps, w->H,
                                     w->gu_u + (size_t)l * Ug * w->H * w->NU,
                                     w->gu_s + (size_t)l * Ug * w->NU, s->gu, 2 * w->I, w->NU,
                                     w->H, st));
  QTTS_TRY(launch_gemv<QTTS_IN_SILU>(s->gu, nullptr, w->eps, w->I,
                                     w->wd_u + (size_t)l * Ud * w->KCd * w->NU,
                                     w->wd_s + (size_t)l * Ud * w->NU, dm, w->H, w->NU, w->KCd,
                                     st));
  return (int)cudaSuccess;
}

}  // extern "C"
