// Kernel K5: the MTP sub-code chain of one 12 Hz frame for B = 1..32 streams.
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_mtp.py::fused_mtp_chain_batched
// (_make_chain_kernel_batched, sampler gumbel_topk_topp_sample with per-row
// knobs).  Same function: two prefix trunk passes at positions 0 and 1 (talker
// hidden, then codec_embed(code0)) into a 17-slot cache per row, then for
// j = 0..n-1, every row b:
//   logits_j[b] = bf16(RMSNorm(x[b]) * final_norm) @ bf16(head_j) * scale_j;
//   sub_j[b]    = gumbel_topk_topp_sample(logits_j[b], noise_j[b], knobs[b]);
//   emb = pred_embed[j][sub_j[b]] (f32); sub_sum[b] += emb;
//   one trunk pass on emb at position 2 + j (not after the last step).
// The whole chain is ONE persistent cooperative launch (bchain_kernel), as
// K2 is for one row: the two prefix passes and the 14 trunk passes run the
// persistent K4's phases (csrc/qtts_stream.cuh) at T = n + 2 with every row
// at the same slot, the 15 heads run as B-row GEMV phases on the same TMA
// weight ring in chain order (each head row read once for all B rows), and
// block b samples row b with K2's register sampler (qtts_sample_fast) and
// that row's knobs and noise, then gathers the row's embedding into
// sub_sum[b] in K2's order, while the next pass's first weights load.  Row
// b's operations are K2's on that row, so a row of K5 equals K2 on the row's
// inputs and noise bit for bit, and the launch-per-op chain below
// (qtts_mtp_chain_batched_multi) bit for bit.  The sampled indices stay on
// the device, and the knobs travel by value in the launch arguments: the
// chain syncs nothing and copies nothing to the device.
//
// The trunk's units are int8, bf16 or int4 (fused_int4.cu instantiates the
// int4 trunks) and the heads int8 or bf16, a template argument of their own
// (HT), as in K2: mixed heads beside an unquantized talker, and the int4
// alt trunk JAX's resident_pack takes past the int8 trunk's residency.
//
// What bounds it on the H100: 16 trunk passes x 82 MB of int8 plus 15 x 2 MB
// of heads per frame, about 1.34 GB, shared by B rows (0.40 ms at the 3.35
// TB/s of an H100 SXM, NVIDIA data sheet); at B = 32 the 16 x 81.8 M x 32
// multiply-adds on CUDA cores (41.9 G FMA, ~1.25 ms at 67 TFLOPS float32).
// What the design leaves: ~510 grid barriers per chain, the trunk streamed
// from device memory every pass, and the sampler on one block per row.

// The build compiles this source as two objects (ops/_build.py PARTS): part
// 1 the batched chain with bf16 heads (beside an int8 trunk, and the bf16
// trunk's), part 0 everything else.  Unset, both.
#ifndef QTTS_PART
#define QTTS_PART -1
#endif
#define QTTS_HAS_PART(part) (QTTS_PART < 0 || QTTS_PART == (part))

#include "qtts_stream.cuh"

#if QTTS_HAS_PART(1)
int qtts_launch_bchain_bf16_heads(const QttsBChainLaunch& l, cudaStream_t st) {
  if (!l.c.heads_bf16) return (int)cudaErrorInvalidValue;
  switch (l.w.unit_type) {
    case QTTS_UNIT_BF16:
      return qtts_launch_persistent(bchain_kernel<float, __nv_bfloat16, __nv_bfloat16>, l, l.p,
                                    st);
    case QTTS_UNIT_INT8: return qtts_launch_bchain_cache<int8_t, __nv_bfloat16>(l, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if QTTS_HAS_PART(0)

namespace {

struct RowSample {
  const float* logits;         // [B, V]
  const float* noise;          // step j's noise; row b at b * noise_row_stride
  int64_t noise_row_stride;
  const __nv_bfloat16* table;  // [Vt, H] step j's embedding table
  int32_t* subcodes;           // [B, n]
  float* sub_sum;              // [B, H]
  float* x_next;               // [B, H]
  int j, n, V, H;
  float temperature[QTTS_MAX_BATCH];
  int32_t top_k[QTTS_MAX_BATCH];
  float top_p[QTTS_MAX_BATCH];
  int32_t greedy[QTTS_MAX_BATCH];
};

// Grid B, QTTS_GEMV_THREADS threads (K2's sampler block size): block b samples
// row b's sub-code and gathers its embedding row.
__global__ void __launch_bounds__(QTTS_GEMV_THREADS) sample_rows_kernel(RowSample p) {
  extern __shared__ float sh[];  // 2V floats
  const int b = blockIdx.x;
  float* lg = sh;
  float* pr = sh + p.V;
  for (int v = threadIdx.x; v < p.V; v += blockDim.x) lg[v] = p.logits[(size_t)b * p.V + v];
  __syncthreads();
  const int sub = qtts_sample_index(lg, pr, p.V, p.noise + b * p.noise_row_stride,
                                    p.temperature[b], p.top_k[b], p.top_p[b], p.greedy[b]);
  if (threadIdx.x == 0) p.subcodes[b * p.n + p.j] = sub;
  const size_t row = (size_t)sub * p.H;
  float* sum = p.sub_sum + (size_t)b * p.H;
  float* x_next = p.x_next + (size_t)b * p.H;
  for (int k = threadIdx.x; k < p.H; k += blockDim.x) {
    const float e = __bfloat162float(p.table[row + k]);
    sum[k] = p.j == 0 ? e : sum[k] + e;
    x_next[k] = e;
  }
}

}  // namespace

extern "C" {

// Kernel K5 entry: subcodes [B, n] and sub_sum [B, H] of one frame's chain,
// in one cooperative launch on the plan's grid.  int8 and int4 trunks with
// int8 or bf16 heads (a->heads_bf16), on either cache; a bf16 trunk with
// bf16 heads on a float32 cache only, as K3 runs it, so that each row
// equals K3 on it.
int qtts_mtp_chain_batched(const QttsStepWeights* w, const QttsBatchScratch* s,
                           const QttsPlan* p, const QttsChainBatchArgs* a, void* stream) {
  const int T = a->n + 2, qd = w->nq * w->D, B = a->B;
  const bool bf16_trunk = w->unit_type == QTTS_UNIT_BF16;
  if (w->D != QTTS_ATTN_D || w->nq % w->nk != 0 || w->nq / w->nk > QTTS_ATTN_MAX_G ||
      w->H % 16 != 0 || qd % 16 != 0 || w->I % 16 != 0 || a->n < 1 || a->V > a->Vt ||
      a->V > QTTS_P_THREADS * QTTS_SAMPLE_VPT || B < 1 || B > QTTS_MAX_BATCH || B > p->grid ||
      (T - 1) / QTTS_ATTN_CHUNK + 1 > s->max_splits || w->unit_type < QTTS_UNIT_INT8 ||
      w->unit_type > QTTS_UNIT_INT4 || (a->heads_bf16 != 0 && a->heads_bf16 != 1) ||
      (bf16_trunk && (!a->heads_bf16 || a->cache_bf16)) ||
      !qtts_plan_ok(*p, *w, a->V, B, nullptr, 0, a->heads_bf16 ? 2 : 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const QttsBChainLaunch launch{*w, *s, *p, *a};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w->unit_type == QTTS_UNIT_INT4) return qtts_launch_bchain_int4(launch, st);
  if (a->heads_bf16) return qtts_launch_bchain_bf16_heads(launch, st);  // a bf16 trunk's too
  return qtts_launch_bchain_cache<int8_t, int8_t>(launch, st);
}

// The launch-per-op chain K5 ran before it was persistent: K4's layer
// launches for each trunk pass, the batched head GEMV and one sampler block
// per row for each step.  The reference chip_smoke.py holds the persistent
// chain to, bit for bit; no wrapper calls it.
int qtts_mtp_chain_batched_multi(const QttsStepWeights* w, const QttsBatchScratch* s,
                                 const QttsChainBatchArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = a->n + 2, H = w->H, V = a->V, B = a->B;
  if (w->unit_type != QTTS_UNIT_INT8 || a->heads_bf16 || H % 16 != 0 || V > a->Vt || B < 1 ||
      B > QTTS_MAX_BATCH) {
    return (int)cudaErrorInvalidValue;  // int8 only
  }
  const size_t smem = (size_t)2 * V * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;

  int err = qtts_launch_decode_step_batched(*w, *s, a->last_hidden, a->x, a->k_cache, a->v_cache,
                                            a->cache_bf16, B, T, nullptr, 0, st);
  if (err) return err;
  err = qtts_launch_decode_step_batched(*w, *s, a->code0_embed, a->x, a->k_cache, a->v_cache,
                                        a->cache_bf16, B, T, nullptr, 1, st);
  if (err) return err;
  RowSample p;
  p.logits = a->logits;
  p.noise_row_stride = a->noise_row_stride;
  p.subcodes = a->subcodes;
  p.sub_sum = a->sub_sum;
  p.x_next = a->x_in;
  p.n = a->n;
  p.V = V;
  p.H = H;
  for (int b = 0; b < QTTS_MAX_BATCH; ++b) {
    p.temperature[b] = a->temperature[b];
    p.top_k[b] = a->top_k[b];
    p.top_p[b] = a->top_p[b];
    p.greedy[b] = a->greedy[b];
  }
  for (int j = 0; j < a->n; ++j) {
    err = qtts_launch_prep_rows(QTTS_IN_NORM, a->x, H, a->final_norm, w->eps, H, s->hb, B, st);
    if (err) return err;
    err = qtts_launch_gemv_rows(s->hb, a->heads + (size_t)j * V * H, a->head_scales + (size_t)j * V,
                                a->logits, V, B, V, H, 0, st);
    if (err) return err;
    p.noise = a->noise + j * a->noise_step_stride;
    p.table = a->tables + (size_t)j * a->Vt * H;
    p.j = j;
    sample_rows_kernel<<<B, QTTS_GEMV_THREADS, smem, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (j + 1 < a->n) {
      err = qtts_launch_decode_step_batched(*w, *s, a->x_in, a->x, a->k_cache, a->v_cache,
                                            a->cache_bf16, B, T, nullptr, 2 + j, st);
      if (err) return err;
    }
  }
  return (int)cudaSuccess;
}

}  // extern "C"

#endif  // QTTS_HAS_PART(0)
