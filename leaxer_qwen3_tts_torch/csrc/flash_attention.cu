// Kernel K8: GQA flash attention with a float32 online softmax and a mask.
//
// Replaces leaxer_qwen3_tts_tpu/ops/flash_attention.py::flash_attend
// (_flash_kernel), the attention of the prefill under attn_impl="pallas".
// Same function: out[b, s, h] = sum_t p_t v[b, h / g, t] / sum_t p_t over the
// keys t the mask allows, with
//   * q scaled by 1/sqrt(D) in float32 before the score product, scores and
//     P.V in float32, the weights never rounded to bf16;
//   * the key axis padded to Tp (the JAX kernel's tile multiple, computed by
//     the wrapper): keys in [T, Tp) are masked with zero values, and every
//     query row visits all Tp of them;
//   * a masked score of -1e30 (finite), so a row masked everywhere ends with
//     l = Tp and the sum of V, and its output is that sum over Tp, as the
//     JAX kernel's is;
//   * out = acc / max(l, 1e-30), cast to the dtype of q.
// The online softmax runs per 32-key tile instead of the JAX kernel's 128:
// the same function up to float32 rounding.
//
// Design (a first, simple kernel): one block of 4 warps per (16 queries,
// q head, batch row); q rows staged in shared memory, scaled, as float32;
// each 32-key tile of K and V staged in shared memory as float32 (K rows
// padded to 129 floats, so lane t reading key t is free of bank conflicts);
// each warp owns 4 query rows, lane t scores key t, and a warp's max and sum
// are shuffles.  No tensor cores.
//
// What bounds it on the H100 (NVIDIA data sheet, SXM): at the 1.7B prefill
// (B=1, S ~ 40, nq=16, nk=8, T=256, D=128, bf16) the bytes of q, k, v, the
// mask and the output are ~1.2 MB, 0.35 us at 3.35 TB/s, against ~0.1 us
// of bf16 tensor-core operations; this kernel takes far longer (it is one
// wave of 48 blocks and reads K/V once per 16 queries); the card measured
// and its power limit are in PERF.md.

#include "qtts_kernels.cuh"

namespace {

constexpr int FA_D = 128;
constexpr int FA_THREADS = 128;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_RPW = 4;                   // query rows per warp
constexpr int FA_BQ = FA_WARPS * FA_RPW;    // query rows per block
constexpr int FA_BT = 32;                   // keys per tile: one per lane

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void fa_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename DT>
__global__ void __launch_bounds__(FA_THREADS)
flash_attend_kernel(const DT* __restrict__ q, const DT* __restrict__ k,
                    const DT* __restrict__ v, const uint8_t* __restrict__ mask,
                    DT* __restrict__ out, int S, int nq, int nk, int T, int Tp,
                    float sm_scale) {
  __shared__ float q_s[FA_BQ][FA_D];
  __shared__ float k_s[FA_BT][FA_D + 1];
  __shared__ float v_s[FA_BT][FA_D];
  const int s0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nq / nk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < FA_BQ * FA_D; i += FA_THREADS) {
    const int r = i / FA_D, c = i % FA_D, s = s0 + r;
    q_s[r][c] = s < S ? fa_load(q + (((size_t)b * S + s) * nq + h) * FA_D + c) * sm_scale : 0.f;
  }
  const DT* kb = k + ((size_t)b * nk + kvh) * T * FA_D;
  const DT* vb = v + ((size_t)b * nk + kvh) * T * FA_D;
  const uint8_t* mb = mask + (size_t)b * S * T;

  float m[FA_RPW], l[FA_RPW], acc[FA_RPW][FA_D / 32];
#pragma unroll
  for (int rr = 0; rr < FA_RPW; ++rr) {
    m[rr] = QTTS_NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < FA_D / 32; ++e) acc[rr][e] = 0.f;
  }

  for (int t0 = 0; t0 < Tp; t0 += FA_BT) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int i = tid; i < FA_BT * FA_D; i += FA_THREADS) {
      const int j = i / FA_D, c = i % FA_D, t = t0 + j;
      k_s[j][c] = t < T ? fa_load(kb + (size_t)t * FA_D + c) : 0.f;
      v_s[j][c] = t < T ? fa_load(vb + (size_t)t * FA_D + c) : 0.f;
    }
    __syncthreads();
    const int t = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < FA_RPW; ++rr) {
      const int r = warp * FA_RPW + rr, s = s0 + r;
      float sc = -CUDART_INF_F;  // past the padded keys: no weight at all
      if (t < Tp) {
        float dot = 0.f;
#pragma unroll 16
        for (int c = 0; c < FA_D; ++c) dot = fmaf(q_s[r][c], k_s[lane][c], dot);
        const bool keep = t < T && s < S && mb[(size_t)s * T + t] != 0;
        sc = keep ? dot : QTTS_NEG_INF;
      }
      const float mn = fmaxf(m[rr], qtts_warp_reduce(sc, QttsMaxF()));
      const float p = expf(sc - mn);
      const float alpha = expf(m[rr] - mn);
      l[rr] = l[rr] * alpha + qtts_warp_reduce(p, QttsSumF());
      float pv[FA_D / 32];
#pragma unroll
      for (int e = 0; e < FA_D / 32; ++e) pv[e] = 0.f;
      for (int j = 0; j < FA_BT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < FA_D / 32; ++e) pv[e] = fmaf(pj, v_s[j][lane + 32 * e], pv[e]);
      }
#pragma unroll
      for (int e = 0; e < FA_D / 32; ++e) acc[rr][e] = acc[rr][e] * alpha + pv[e];
      m[rr] = mn;
    }
  }
#pragma unroll
  for (int rr = 0; rr < FA_RPW; ++rr) {
    const int s = s0 + warp * FA_RPW + rr;
    if (s >= S) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    DT* o = out + (((size_t)b * S + s) * nq + h) * FA_D;
#pragma unroll
    for (int e = 0; e < FA_D / 32; ++e) fa_store(o + lane + 32 * e, acc[rr][e] / denom);
  }
}

}  // namespace

extern "C" {

// Kernel K8 entry: out [B, S, nq, 128] = flash attention of q [B, S, nq, 128]
// over k, v [B, nk, T, 128] (head-major) under mask [B, S, T] (bytes, 0 or
// 1), every tensor bf16 (bf16 = 1) or float32; Tp >= T is the padded key count.
int qtts_flash_attend(const void* q, const void* k, const void* v, const uint8_t* mask,
                      void* out, int B, int S, int nq, int nk, int T, int Tp, int bf16,
                      void* stream) {
  if (B < 1 || S < 1 || T < 1 || Tp < T || nk < 1 || nq % nk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, nq, B);
  const float sm_scale = (float)(1.0 / sqrt((double)FA_D));
  if (bf16) {
    flash_attend_kernel<__nv_bfloat16><<<grid, FA_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), S, nq, nk,
        T, Tp, sm_scale);
  } else {
    flash_attend_kernel<float><<<grid, FA_THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        mask, static_cast<float*>(out), S, nq, nk, T, Tp, sm_scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
