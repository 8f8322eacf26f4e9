// Kernel K1: one B=1 decode step through every layer of a GQA transformer
// (the 28-layer talker; kernel K2 runs the same phases on the 6-layer MTP
// trunk), as ONE persistent cooperative launch.
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_step.py::fused_decode_step
// (_make_kernel_manual / _manual_layer_core for T <= 512, _make_kernel's
// "hbm" and "win" modes beyond).  Per layer, the same math as
// _manual_layer_core:
//   h = RMSNorm(x) * attn_norm;  qkv = (bf16(h) @ bf16(W)) * scale  (f32)
//   per-head QK-norm, rotate-half RoPE at pos, K/V written at slot pos in the
//   cache dtype, GQA attention over slots 0..pos (q head h reads kv head
//   h / (nq/nk)), x += bf16(attn) @ Wo * scale;
//   h = RMSNorm(x) * mlp_norm; x += bf16(silu(gate) * up) @ Wd * scale.
// The residual x stays float32 across all layers; the cache is updated in
// place.  The three Pallas cache modes collapse into one split attention
// (online softmax over QTTS_ATTN_CHUNK-slot splits, then a combine), which
// takes every bucket of the KV ladder with no shared-memory bound.
//
// What bounds it on the H100: the int8 weight bytes of one step, about
// 440 MB for the 0.6B talker (28 x 15.7 MB) and 1.41 GB at 1.7B, against
// 3.35 TB/s device-memory bandwidth on an H100 SXM (NVIDIA data sheet) --
// 0.13 ms (0.42 ms) per step at that roofline; the card measured and its
// power limit are in PERF.md.  At one token the step is latency-bound, not
// bytes-bound: the launch-per-op sequence below (qtts_decode_step_multi, six
// launches per layer, each a launch, a per-16-row prologue and a cold DRAM
// round trip in series) ran at 8% of the bound.  The persistent kernel
// (step_kernel, on qtts_stream.cuh's transport) runs the layer as five grid
// phases on SM-count blocks, each block owning fixed row ranges whose int8
// rows stream through a TMA ring ahead of the barriers their inputs wait on;
// its values equal the launch sequence's bit for bit (chip_smoke.py checks).
// bf16 units (the unquantized config, the JAX pack's bits=16: scales of one)
// run the same phases with each lane's 16 columns read as two 16-byte loads
// and converted exactly, in the int8 path's FMA order: twice the bytes
// (~880 MB at 0.6B, 0.26 ms at the roofline), and on int8-valued bf16
// weights with unit scales the int8 kernel's values bit for bit.
// What it leaves: the grid barriers themselves (five per layer), the
// attention's items on two 128-thread halves per block, and no CUDA graph
// around the host's per-frame work.
// An int8 KV cache (the JAX kernel's kvq mode, both unit types) runs the
// same phases with CT = int8_t: the attention item quantizes the new slot
// on quantize_kv's grid (amax over the head on the head-norm tree, an IEEE
// division, rintf: half to even), writes it with its float32 scales, and
// weights each slot's score by its k scale and its value term by its v
// scale.  Its bound adds the int8 slots and their scales to the weights:
// 0.136 ms at T=256 pos 200 against the bf16 cache's 0.139; the item stays
// latency-bound, one pair of barriers longer for the amax.
// int4 units (--quantize int4) run the same phases; their instances are
// fused_int4.cu's (qtts_launch_step_int4), to which this entry dispatches.

#include "qtts_stream.cuh"

namespace {

// out[n] (+)= scale[n] * sum_k bf16(in'[k]) * W[n, k] for the input transform
// IN_MODE (see qtts_gemv_prologue); ACCUM adds into out (the residual).
template <int IN_MODE, bool ACCUM>
__global__ void __launch_bounds__(QTTS_GEMV_THREADS)
gemv_i8_kernel(const float* __restrict__ in, const float* __restrict__ norm_w, float eps,
               const int8_t* __restrict__ W, const float* __restrict__ scale,
               float* __restrict__ out, int N, int K) {
  extern __shared__ float sh[];
  qtts_gemv_i8_body<IN_MODE, ACCUM>(in, norm_w, eps, W, scale, out, N, K, blockIdx.x, sh);
}

// The normed GEMV with the float32 normed input written out (raw, by block 0);
// WT: int8 or bf16 rows.
template <typename WT>
__global__ void __launch_bounds__(QTTS_GEMV_THREADS)
gemv_norm_raw_kernel(const float* __restrict__ in, const float* __restrict__ norm_w, float eps,
                     const WT* __restrict__ W, const float* __restrict__ scale,
                     float* __restrict__ out, int N, int K, float* __restrict__ raw) {
  extern __shared__ float sh[];
  qtts_gemv_i8_body<QTTS_IN_NORM, false>(in, norm_w, eps, W, scale, out, N, K, blockIdx.x, sh,
                                         raw);
}

template <int IN_MODE, bool ACCUM>
cudaError_t launch_gemv(const float* in, const float* norm_w, float eps, const int8_t* W,
                        const float* scale, float* out, int N, int K, cudaStream_t st) {
  const int in_len = K;  // floats staged in shared memory
  const size_t smem = (size_t)in_len * sizeof(float);
  if (K % 16 != 0 || smem > 48 * 1024) return cudaErrorInvalidValue;
  const int grid = (N + QTTS_GEMV_ROWS - 1) / QTTS_GEMV_ROWS;
  gemv_i8_kernel<IN_MODE, ACCUM><<<grid, QTTS_GEMV_THREADS, smem, st>>>(in, norm_w, eps, W,
                                                                       scale, out, N, K);
  return cudaGetLastError();
}

bool step_args_ok(const QttsStepWeights& w, const QttsStepScratch& s, int T, int pos) {
  const int qd = w.nq * w.D;
  return w.D == QTTS_ATTN_D && w.nq % w.nk == 0 && w.nq / w.nk <= QTTS_ATTN_MAX_G &&
         w.H % 16 == 0 && qd % 16 == 0 && w.I % 16 == 0 && pos >= 0 && pos < T &&
         pos / QTTS_ATTN_CHUNK + 1 <= s.max_splits;
}

}  // namespace

int qtts_launch_decode_step(const QttsStepWeights& w, const QttsStepScratch& s,
                            const float* x_in, float* x, void* k_cache, void* v_cache,
                            int cache_bf16, int T, int pos, cudaStream_t st) {
  if (w.unit_type != QTTS_UNIT_INT8 || w.D != QTTS_ATTN_D || w.nq % w.nk != 0 ||
      w.nq / w.nk > QTTS_ATTN_MAX_G) {
    return (int)cudaErrorInvalidValue;
  }
  if (pos < 0 || pos >= T) return (int)cudaErrorInvalidValue;
  const int n_splits = pos / QTTS_ATTN_CHUNK + 1;
  if (n_splits > s.max_splits) return (int)cudaErrorInvalidValue;
  const int H = w.H, I = w.I, qd = w.nq * w.D, A = qd + 2 * w.nk * w.D;
  if (x_in != x) {
    QTTS_TRY(cudaMemcpyAsync(x, x_in, (size_t)H * sizeof(float), cudaMemcpyDeviceToDevice, st));
  }
  for (int l = 0; l < w.L; ++l) {
    QTTS_TRY((launch_gemv<QTTS_IN_NORM, false>(x, w.attn_norm + (size_t)l * H, w.eps,
                                               w.wqkv + (size_t)l * A * H,
                                               w.sqkv + (size_t)l * A, s.qkv, A, H, st)));
    if (cache_bf16) {
      QTTS_TRY(qtts_launch_attention(w, l, s.qkv, s.part, s.max_splits, s.attn,
                                     static_cast<__nv_bfloat16*>(k_cache),
                                     static_cast<__nv_bfloat16*>(v_cache), 1, 1, T, nullptr,
                                     pos, n_splits, st));
    } else {
      QTTS_TRY(qtts_launch_attention(w, l, s.qkv, s.part, s.max_splits, s.attn,
                                     static_cast<float*>(k_cache), static_cast<float*>(v_cache),
                                     1, 1, T, nullptr, pos, n_splits, st));
    }
    QTTS_TRY((launch_gemv<QTTS_IN_PLAIN, true>(s.attn, nullptr, 0.f,
                                               w.wo + (size_t)l * H * qd,
                                               w.so + (size_t)l * H, x, H, qd, st)));
    QTTS_TRY((launch_gemv<QTTS_IN_NORM, false>(x, w.mlp_norm + (size_t)l * H, w.eps,
                                               w.wgu + (size_t)l * 2 * I * H,
                                               w.sgu + (size_t)l * 2 * I, s.gu, 2 * I, H,
                                               st)));
    QTTS_TRY((launch_gemv<QTTS_IN_SILU, true>(s.gu, nullptr, 0.f, w.wd + (size_t)l * H * I,
                                              w.sd + (size_t)l * H, x, H, I, st)));
  }
  return (int)cudaSuccess;
}

extern "C" {

int qtts_attn_chunk() { return QTTS_ATTN_CHUNK; }

const char* qtts_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Kernel K1 entry: x_out = decode_step(x_in) with the caches updated in
// place, in one cooperative launch on the plan's grid; int8, bf16 or int4
// units (w->unit_type), each with a bf16 or float32 cache, or an int8 cache with
// its scales k_scale / v_scale [L, nk, T] (null for the other caches; the
// bucket 128-aligned, as the JAX kernel's scale windows need).
int qtts_decode_step(const QttsStepWeights* w, const QttsStepScratch* s, const QttsPlan* p,
                     const float* x_in, float* x_out, void* k_cache, void* v_cache,
                     float* k_scale, float* v_scale, int cache_bf16, int T, int pos,
                     void* stream) {
  const bool i8 = k_scale != nullptr;
  if (!step_args_ok(*w, *s, T, pos) || !qtts_plan_ok(*p, *w, 0) || x_in == x_out ||
      i8 != (v_scale != nullptr) || (i8 && (cache_bf16 || T % 128 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const QttsStepLaunch a{*w, *s, *p, x_in, x_out, k_cache, v_cache, k_scale, v_scale, T, pos};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w->unit_type == QTTS_UNIT_INT4) return qtts_launch_step_int4(a, i8 ? 2 : cache_bf16, st);
  if (i8) {
    return w->unit_type ? qtts_launch_persistent(step_kernel<int8_t, __nv_bfloat16>, a, *p, st)
                        : qtts_launch_persistent(step_kernel<int8_t, int8_t>, a, *p, st);
  }
  if (w->unit_type) {
    return cache_bf16 ? qtts_launch_persistent(step_kernel<__nv_bfloat16, __nv_bfloat16>, a, *p, st)
                      : qtts_launch_persistent(step_kernel<float, __nv_bfloat16>, a, *p, st);
  }
  return cache_bf16 ? qtts_launch_persistent(step_kernel<__nv_bfloat16, int8_t>, a, *p, st)
                    : qtts_launch_persistent(step_kernel<float, int8_t>, a, *p, st);
}

// The launch-per-op sequence K1 ran before it was persistent (six launches
// per layer, int8 units only): the reference chip_smoke.py holds the
// persistent step to, bit for bit.  No wrapper calls it; the launch-per-op chains (K2's and K3's
// references) run the same layer kernels through qtts_launch_decode_step.
int qtts_decode_step_multi(const QttsStepWeights* w, const QttsStepScratch* s, const float* x_in,
                           float* x_out, void* k_cache, void* v_cache, int cache_bf16, int T,
                           int pos, void* stream) {
  if (cache_bf16 != 0 && cache_bf16 != 1) return (int)cudaErrorInvalidValue;
  return qtts_launch_decode_step(*w, *s, x_in, x_out, k_cache, v_cache, cache_bf16, T, pos,
                                 static_cast<cudaStream_t>(stream));
}

// The sizes and limits ops/persistent.py plans with: sizeof(QttsAttnSmem),
// sizeof(QttsSampleSmem), the most rows a stage may hold, the threads of a
// block, the widest GEMV input, the kv heads a plan takes, the attention
// tickets of a batched launch, the rows a batched launch takes, the weight
// sets a plan takes, sizeof(QttsPlan).
void qtts_persistent_sizes(int* out) {
  out[0] = (int)sizeof(QttsAttnSmem);
  out[1] = (int)sizeof(QttsSampleSmem);
  out[2] = QTTS_P_MAX_STAGE_ROWS;
  out[3] = QTTS_P_THREADS;
  out[4] = QTTS_P_MAX_K;
  out[5] = QTTS_P_MAX_KV_HEADS;
  out[6] = QTTS_P_MAX_TICKETS;
  out[7] = QTTS_MAX_BATCH;
  out[8] = QTTS_SETS;
  out[9] = (int)sizeof(QttsPlan);
}

// The final norm and an int8 or bf16 (w_bf16) head on K1's GEMV: hidden =
// RMSNorm(x) * norm_w (float32) and out[n] = scale[n] * bf16(hidden) . W[n]
// for n < N.  Kernel K7's epilogue runs the same body; chip_smoke.py
// composes K2, K1 and this launch to hold K7 to them bit for bit.
int qtts_norm_head(const float* x, const float* norm_w, float eps, const void* W,
                   const float* scale, float* hidden, float* out, int N, int K, int w_bf16,
                   void* stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (K % 16 != 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (N + QTTS_GEMV_ROWS - 1) / QTTS_GEMV_ROWS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    gemv_norm_raw_kernel<__nv_bfloat16><<<grid, QTTS_GEMV_THREADS, smem, st>>>(
        x, norm_w, eps, static_cast<const __nv_bfloat16*>(W), scale, out, N, K, hidden);
  } else {
    gemv_norm_raw_kernel<int8_t><<<grid, QTTS_GEMV_THREADS, smem, st>>>(
        x, norm_w, eps, static_cast<const int8_t*>(W), scale, out, N, K, hidden);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
