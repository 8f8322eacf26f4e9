// Kernel K1: one B=1 decode step through every layer of a GQA transformer
// (the 28-layer talker, and the 6-layer MTP trunk that fused_mtp.cu reuses).
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
// kernel (online softmax over QTTS_ATTN_CHUNK-slot splits, then a combine),
// which takes every bucket of the KV ladder with no shared-memory bound.
//
// What bounds it on the H100: the int8 weight bytes of one step, about
// 440 MB for the 0.6B talker (28 x 15.7 MB) and 82 MB per MTP trunk pass,
// against 3.35 TB/s device-memory bandwidth on an H100 SXM (NVIDIA data
// sheet) -- 0.13 ms per talker step at that roofline; the card measured and
// its power limit are in PERF.md.  What this simple design leaves on the
// table: a GEMV with one block per 16 output rows (64 blocks for a 1024-row
// output, under half the SMs), every block recomputing the input prologue,
// and 16-byte loads per lane with no TMA or cp.async pipeline; six launches
// per layer with the activation round-tripping through global memory and
// the card idle between them; no persistent kernel or CUDA graph.

#include "qtts_kernels.cuh"

namespace {

// out[n] (+)= scale[n] * sum_k bf16(in'[k]) * W[n, k] for the input transform
// IN_MODE (see qtts_gemv_prologue); ACCUM adds into out (the residual).
template <int IN_MODE, bool ACCUM>
__global__ void __launch_bounds__(QTTS_GEMV_THREADS)
gemv_i8_kernel(const float* __restrict__ in, const float* __restrict__ norm_w, float eps,
               const int8_t* __restrict__ W, const float* __restrict__ scale,
               float* __restrict__ out, int N, int K) {
  extern __shared__ float sh[];
  qtts_gemv_prologue<IN_MODE>(in, norm_w, eps, K, sh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * QTTS_GEMV_ROWS + warp * QTTS_GEMV_RPW;
  float acc[QTTS_GEMV_RPW];
  qtts_gemv_rows(W, sh, N, K, n0, acc);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
      const int n = n0 + r;
      if (n < N) {
        const float v = acc[r] * scale[n];
        out[n] = ACCUM ? out[n] + v : v;
      }
    }
  }
}

template <typename CT>
__device__ __forceinline__ CT to_cache(float x);
template <>
__device__ __forceinline__ float to_cache<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_cache<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float from_cache(float x) { return x; }
__device__ __forceinline__ float from_cache(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  o[0] = fa.x; o[1] = fa.y; o[2] = fb.x; o[3] = fb.y;
}

// Grid (nk, n_splits), QTTS_ATTN_D threads.  Block (h, s) normalises and
// rotates kv head h's q heads and k, takes slots
// [s*CHUNK, min((s+1)*CHUNK, pos+1)) and writes the split's softmax partials.
// The new slot's k/v come from registers (rounded to the cache dtype, so they
// equal what the cache holds); split 0 alone writes them to the cache, and no
// block reads slot pos from memory, so the write never races a read.
template <typename CT>
__global__ void __launch_bounds__(QTTS_ATTN_D)
attn_split_kernel(const float* __restrict__ qkv, const float* __restrict__ q_norm,
                  const float* __restrict__ k_norm, const float* __restrict__ inv_freq,
                  CT* __restrict__ kc, CT* __restrict__ vc, float* __restrict__ part,
                  int nq, int nk, int T, int pos, int max_splits, float eps, float scale) {
  constexpr int D = QTTS_ATTN_D;
  constexpr int G = QTTS_ATTN_MAX_G;
  __shared__ float q_s[G][D];
  __shared__ float k_s[D];
  __shared__ float v_s[D];
  __shared__ float wm[4][G];
  __shared__ float wl[4][G];
  __shared__ float wacc[4][G][D];

  const int h = blockIdx.x, split = blockIdx.y, t = threadIdx.x;
  const int g = nq / nk;
  const int qd = nq * D, kvd = nk * D;

  for (int gi = 0; gi < g; ++gi) {
    const float v = qkv[(h * g + gi) * D + t];
    const float ss = qtts_block_reduce(v * v, QttsSumF());
    const float r = rsqrtf(ss / (float)D + eps);
    q_s[gi][t] = (v * r) * q_norm[t];
  }
  {
    const float kv = qkv[qd + h * D + t];
    const float ss = qtts_block_reduce(kv * kv, QttsSumF());
    const float r = rsqrtf(ss / (float)D + eps);
    k_s[t] = (kv * r) * k_norm[t];
    v_s[t] = qkv[qd + kvd + h * D + t];
  }
  __syncthreads();
  if (t < D / 2) {
    const float ang = (float)pos * inv_freq[t];
    const float c = cosf(ang), s = sinf(ang);
    for (int gi = 0; gi < g; ++gi) {
      const float x1 = q_s[gi][t], x2 = q_s[gi][t + D / 2];
      q_s[gi][t] = x1 * c - x2 * s;
      q_s[gi][t + D / 2] = x2 * c + x1 * s;
    }
    const float x1 = k_s[t], x2 = k_s[t + D / 2];
    k_s[t] = x1 * c - x2 * s;
    k_s[t + D / 2] = x2 * c + x1 * s;
  }
  __syncthreads();
  {
    const CT kq = to_cache<CT>(k_s[t]);
    const CT vq = to_cache<CT>(v_s[t]);
    k_s[t] = from_cache(kq);
    v_s[t] = from_cache(vq);
    if (split == 0) {
      kc[((size_t)h * T + pos) * D + t] = kq;
      vc[((size_t)h * T + pos) * D + t] = vq;
    }
  }
  __syncthreads();

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
    if (j == pos) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kf[e] = k_s[lane * 4 + e];
        vf[e] = v_s[lane * 4 + e];
      }
    } else {
      load4(kc + ((size_t)h * T + j) * D + lane * 4, kf);
      load4(vc + ((size_t)h * T + j) * D + lane * 4, vf);
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
  __syncthreads();
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

// Grid nq, QTTS_ATTN_D threads: merges the n_splits partials of q head hq.
__global__ void __launch_bounds__(QTTS_ATTN_D)
attn_combine_kernel(const float* __restrict__ part, float* __restrict__ attn,
                    int max_splits, int n_splits) {
  constexpr int D = QTTS_ATTN_D;
  const int hq = blockIdx.x, t = threadIdx.x;
  const float* base = part + (size_t)hq * max_splits * (D + 2);
  float M = QTTS_NEG_INF;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, base[s * (D + 2)]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float f = expf(base[s * (D + 2)] - M);
    L += base[s * (D + 2) + 1] * f;
    o += base[s * (D + 2) + 2 + t] * f;
  }
  attn[hq * D + t] = o / L;
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

template <typename CT>
cudaError_t launch_attention(const QttsStepWeights& w, const QttsStepScratch& s, int l,
                             CT* kc, CT* vc, int T, int pos, int n_splits, cudaStream_t st) {
  const size_t layer = (size_t)w.nk * T * w.D;
  attn_split_kernel<CT><<<dim3(w.nk, n_splits), QTTS_ATTN_D, 0, st>>>(
      s.qkv, w.q_norm + (size_t)l * w.D, w.k_norm + (size_t)l * w.D, w.inv_freq,
      kc + l * layer, vc + l * layer, s.part, w.nq, w.nk, T, pos, s.max_splits, w.eps,
      w.attn_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_combine_kernel<<<w.nq, QTTS_ATTN_D, 0, st>>>(s.part, s.attn, s.max_splits, n_splits);
  return cudaGetLastError();
}

}  // namespace

#define QTTS_TRY(expr)                 \
  do {                                 \
    const cudaError_t e_ = (expr);     \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

int qtts_launch_decode_step(const QttsStepWeights& w, const QttsStepScratch& s,
                            const float* x_in, float* x, void* k_cache, void* v_cache,
                            int cache_bf16, int T, int pos, cudaStream_t st) {
  if (w.D != QTTS_ATTN_D || w.nq % w.nk != 0 || w.nq / w.nk > QTTS_ATTN_MAX_G) {
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
      QTTS_TRY(launch_attention(w, s, l, static_cast<__nv_bfloat16*>(k_cache),
                                static_cast<__nv_bfloat16*>(v_cache), T, pos, n_splits, st));
    } else {
      QTTS_TRY(launch_attention(w, s, l, static_cast<float*>(k_cache),
                                static_cast<float*>(v_cache), T, pos, n_splits, st));
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

// Kernel K1 entry: x_out = decode_step(x_in) with the caches updated in place.
int qtts_decode_step(const QttsStepWeights* w, const QttsStepScratch* s, const float* x_in,
                     float* x_out, void* k_cache, void* v_cache, int cache_bf16, int T,
                     int pos, void* stream) {
  return qtts_launch_decode_step(*w, *s, x_in, x_out, k_cache, v_cache, cache_bf16, T, pos,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
