// Kernel K2: the whole B=1 MTP sub-code chain of one 12 Hz frame, as ONE
// persistent cooperative launch.
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_mtp.py::fused_mtp_chain
// (_make_chain_kernel / _chain_core, sampler gumbel_topk_topp_sample).  Same
// function: two prefix trunk passes at positions 0 and 1 (talker hidden, then
// codec_embed(code0)) into a 17-slot cache in the cache dtype (every slot is
// written before it is read), then for j = 0..n-1:
//   logits_j = bf16(RMSNorm(x) * final_norm) @ bf16(head_j) * scale_j;
//   sub_j    = gumbel_topk_topp_sample(logits_j, noise_j, ...);
//   emb      = pred_embed[j][sub_j] (f32); sub_sum += emb;
//   one trunk pass on emb at position 2 + j (not after the last step).
// The sampler: temperature, the 40-round float32 bisections for the top-k
// and top-p thresholds, the first-index argmax of masked + noise.  The
// sampled index stays on the device: no host sync inside the chain.
//
// What bounds it on the H100: weight bytes per frame, 16 trunk passes x 82 MB
// of int8 (the TPU kept this trunk resident in 128 MB of VMEM; an SM has
// 228 KB of shared memory, so Hopper streams it every pass) plus 15 x 2 MB of
// int8 heads, about 1.34 GB per frame, 0.40 ms at the 3.35 TB/s of an H100 SXM
// (NVIDIA data sheet); the card measured and its power limit are in PERF.md.
// At one token the chain is latency-bound: the launch-per-op chain below
// (qtts_mtp_chain_multi: K1's six launches per layer for each of the 16
// passes, one head + sampler kernel per step, ~590 dependent launches) ran at
// 0.6% of the bound.  The persistent chain (chain_kernel: qtts_chain_phases
// on qtts_stream.cuh, the body K3 and K7 run too) runs every pass as K1's
// five grid phases per layer and every head as one more GEMV phase, all fed
// by one TMA weight ring whose stages run ahead of the data dependency (the
// next pass's first weights load while one block samples), and samples with
// the register sampler (qtts_sample_fast).  Its sub-codes and sub_sum equal
// the launch-per-op chain's bit for bit (chip_smoke.py checks).  What it
// leaves: ~510 grid barriers per chain, the 15 draws on one block, and the
// trunk streamed from device memory 16 times (no cluster-resident split).
// The heads' unit type is a template argument of its own (HT): int8 heads
// beside an int4 trunk (JAX's int4 mode), bf16 heads with scales of one
// beside an int8 or int4 trunk (an unquantized talker with --mtp-quantize;
// JAX casts raw heads so); the int4 trunks' instances are fused_int4.cu's.

#include "qtts_stream.cuh"

namespace {

__global__ void __launch_bounds__(QTTS_GEMV_THREADS) head_sample_kernel(QttsHeadStep p) {
  extern __shared__ float sh[];  // max(H, 2V) floats
  if (qtts_head_rows(p, sh) != gridDim.x - 1) return;
  qtts_head_sample(p, sh);
}

}  // namespace

extern "C" {

// Kernel K2 entry: subcodes [n] and sub_sum [H] of one frame's chain, in one
// cooperative launch on the plan's grid.  int8 or int4 units with int8 or
// bf16 heads (a->heads_bf16), each with either cache; bf16 units with bf16
// heads on a float32 cache only: K3's chain, which K3's entry runs through
// this one.  (JAX's int4 mode keeps the heads int8; the unquantized talker
// beside a quantized MTP trunk gives bf16 heads, JAX's cast of raw heads.)
int qtts_mtp_chain(const QttsStepWeights* w, const QttsStepScratch* s, const QttsPlan* p,
                   const QttsChainArgs* a, void* stream) {
  const int T = a->n + 2, qd = w->nq * w->D;
  const bool bf16_trunk = w->unit_type == QTTS_UNIT_BF16;
  if (w->D != QTTS_ATTN_D || w->nq % w->nk != 0 || w->nq / w->nk > QTTS_ATTN_MAX_G ||
      w->H % 16 != 0 || qd % 16 != 0 || w->I % 16 != 0 || a->n < 1 || a->V > a->Vt ||
      a->V > QTTS_P_THREADS * QTTS_SAMPLE_VPT || (T - 1) / QTTS_ATTN_CHUNK + 1 > s->max_splits ||
      (a->heads_bf16 != 0 && a->heads_bf16 != 1) || (bf16_trunk && !a->heads_bf16) ||
      (bf16_trunk && a->cache_bf16) || !qtts_plan_ok(*p, *w, a->V, 0, nullptr, 0,
                                                     a->heads_bf16 ? 2 : 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const QttsChainLaunch launch{*w, *s, *p, *a};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w->unit_type == QTTS_UNIT_INT4) return qtts_launch_chain_int4(launch, st);
  if (bf16_trunk) {
    return qtts_launch_persistent(chain_kernel<float, __nv_bfloat16, __nv_bfloat16>, launch, *p,
                                  st);
  }
  return qtts_launch_chain_heads<int8_t>(launch, st);
}

// The launch-per-op chain K2 ran before it was persistent: K1's layer
// launches for each trunk pass and one head kernel per step, in which every
// block computes 16 head rows and the last block to finish (atomic ticket)
// runs the sampler and the gather.  The reference chip_smoke.py holds the
// persistent chain to, bit for bit; no wrapper calls it.
int qtts_mtp_chain_multi(const QttsStepWeights* w, const QttsStepScratch* s,
                         const QttsChainArgs* a, void* stream) {
  if (w->unit_type != QTTS_UNIT_INT8 || a->heads_bf16) {
    return (int)cudaErrorInvalidValue;  // int8 only
  }
  return qtts_run_mtp_chain(
      *w, *s, *a, static_cast<cudaStream_t>(stream),
      [](const QttsHeadStep& p, bool, int grid, size_t smem, cudaStream_t st) {
        head_sample_kernel<<<grid, QTTS_GEMV_THREADS, smem, st>>>(p);
      });
}

}  // extern "C"
