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
// The trunk passes reuse kernel K1's layer kernels (fused_step.cu).  Each step
// runs ONE head kernel here: every block computes 16 head rows, and the last
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

struct HeadStep {
  const float* x;           // [H] trunk output, pre-final-norm
  const float* final_norm;  // [H]
  float eps;
  const int8_t* W;          // [V, H] this step's head
  const float* scale;       // [V]
  const float* gumbel;      // [V]
  const __nv_bfloat16* table;  // [Vt, H] this step's embedding table
  float* logits;            // [V]
  uint32_t* counter;
  int32_t* subcodes;
  float* sub_sum;           // [H]
  float* x_next;            // [H]
  int j, V, H;
  float temperature;
  int top_k;
  float top_p;
  int greedy;
};

__global__ void __launch_bounds__(QTTS_GEMV_THREADS) head_sample_kernel(HeadStep p) {
  extern __shared__ float sh[];  // max(H, 2V) floats
  __shared__ int is_last;
  qtts_gemv_prologue<QTTS_IN_NORM>(p.x, p.final_norm, p.eps, p.H, sh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * QTTS_GEMV_ROWS + warp * QTTS_GEMV_RPW;
  float acc[QTTS_GEMV_RPW];
  qtts_gemv_rows(p.W, sh, p.V, p.H, n0, acc);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
      const int n = n0 + r;
      if (n < p.V) qtts_gemv_store<false>(p.logits + n, acc[r], p.scale[n]);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(p.counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  float* lg = sh;
  float* pr = sh + p.V;
  for (int v = threadIdx.x; v < p.V; v += blockDim.x) lg[v] = __ldcg(p.logits + v);
  __syncthreads();
  const int sub = qtts_sample_index(lg, pr, p.V, p.gumbel, p.temperature, p.top_k,
                                    p.top_p, p.greedy);
  if (threadIdx.x == 0) {
    p.subcodes[p.j] = sub;
    *p.counter = 0u;
  }
  const size_t row = (size_t)sub * p.H;
  for (int k = threadIdx.x; k < p.H; k += blockDim.x) {
    const float e = __bfloat162float(p.table[row + k]);
    p.sub_sum[k] = p.j == 0 ? e : p.sub_sum[k] + e;
    p.x_next[k] = e;
  }
}

}  // namespace

extern "C" {

// Kernel K2 entry: subcodes [n] and sub_sum [H] of one frame's chain.
int qtts_mtp_chain(const QttsStepWeights* w, const QttsStepScratch* s, const QttsChainArgs* a,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = a->n + 2, H = w->H, V = a->V;
  if (H % 16 != 0 || V > a->Vt) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(H > 2 * V ? H : 2 * V) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (V + QTTS_GEMV_ROWS - 1) / QTTS_GEMV_ROWS;

  int err = qtts_launch_decode_step(*w, *s, a->last_hidden, a->x, a->k_cache, a->v_cache,
                                    a->cache_bf16, T, 0, st);
  if (err) return err;
  err = qtts_launch_decode_step(*w, *s, a->code0_embed, a->x, a->k_cache, a->v_cache,
                                a->cache_bf16, T, 1, st);
  if (err) return err;
  for (int j = 0; j < a->n; ++j) {
    HeadStep p;
    p.x = a->x;
    p.final_norm = a->final_norm;
    p.eps = w->eps;
    p.W = a->heads + (size_t)j * V * H;
    p.scale = a->head_scales + (size_t)j * V;
    p.gumbel = a->gumbel + (size_t)j * V;
    p.table = a->tables + (size_t)j * a->Vt * H;
    p.logits = a->logits;
    p.counter = a->counter;
    p.subcodes = a->subcodes;
    p.sub_sum = a->sub_sum;
    p.x_next = a->x_in;
    p.j = j;
    p.V = V;
    p.H = H;
    p.temperature = a->temperature;
    p.top_k = a->top_k;
    p.top_p = a->top_p;
    p.greedy = a->greedy;
    head_sample_kernel<<<grid, QTTS_GEMV_THREADS, smem, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (j + 1 < a->n) {
      err = qtts_launch_decode_step(*w, *s, a->x_in, a->x, a->k_cache, a->v_cache,
                                    a->cache_bf16, T, 2 + j, st);
      if (err) return err;
    }
  }
  return (int)cudaSuccess;
}

}  // extern "C"
