// Kernel K2: the whole B=1 MTP sub-code chain of one 12 Hz frame.
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
// The trunk passes reuse kernel K1's layer kernels (fused_step.cu); the loop
// is qtts_run_mtp_chain (qtts_kernels.cuh), shared with K3.  Each step runs
// ONE head kernel here: every block computes 16 head rows, and the last
// block to finish (atomic ticket) runs the sampler -- temperature, the
// 40-iteration float32 bisections for the top-k and top-p thresholds, the
// first-index argmax of masked + noise -- then gathers the embedding row.  The
// sampled index stays on the device: no host sync inside the chain.
//
// What bounds it on the H100: weight bytes per frame, 16 trunk passes x 82 MB
// of int8 (the TPU kept this trunk resident in 128 MB of VMEM; an SM has
// 228 KB of shared memory, so Hopper streams it every pass) plus 15 x 2 MB of
// int8 heads, about 1.34 GB per frame, 0.40 ms at the 3.35 TB/s of an H100 SXM
// (NVIDIA data sheet); the card measured and its power limit are in PERF.md.
// What this simple design leaves on the table: the trunk stays in device
// memory (no L2-persistence window or cluster-resident split of it), K1's
// GEMVs run far below the bandwidth bound (see fused_step.cu), ~600 launches
// per frame leave the card idle between kernels, and the sampler's 80
// bisection rounds run on one block while the rest of the card idles.

#include "qtts_kernels.cuh"

namespace {

__global__ void __launch_bounds__(QTTS_GEMV_THREADS) head_sample_kernel(QttsHeadStep p) {
  extern __shared__ float sh[];  // max(H, 2V) floats
  if (qtts_head_rows(p, sh) != gridDim.x - 1) return;
  qtts_head_sample(p, sh);
}

}  // namespace

extern "C" {

// Kernel K2 entry: subcodes [n] and sub_sum [H] of one frame's chain.
int qtts_mtp_chain(const QttsStepWeights* w, const QttsStepScratch* s, const QttsChainArgs* a,
                   void* stream) {
  return qtts_run_mtp_chain(
      *w, *s, *a, static_cast<cudaStream_t>(stream),
      [](const QttsHeadStep& p, bool, int grid, size_t smem, cudaStream_t st) {
        head_sample_kernel<<<grid, QTTS_GEMV_THREADS, smem, st>>>(p);
      });
}

}  // extern "C"
