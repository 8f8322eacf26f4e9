// Kernel K3: the B=1 MTP sub-code chain with a streamed trunk and a float32
// KV scratch (the 1.7B chain, whose int8 trunk is past the residency gate).
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_mtp_stream.py::fused_mtp_chain_streamed
// (_make_stream_chain_kernel).  It computes what K2 computes, with the JAX
// kernel's two differences carried over:
//   * the 17-slot KV scratch is float32 whatever the model dtype (the JAX
//     kernel's kc_s / vc_s), so at a bf16 model K3 is K2 with a float32
//     cache, not K2 at the config dtype; this entry ignores the args' cache
//     dtype and always runs the float32 cache;
//   * the trunk is streamed with the next chain position's weight reads
//     started behind the current position's work.  On the TPU that is a DMA
//     ring that runs across positions.  On Hopper every pass streams the trunk
//     from device memory anyway (302 MB at 1.7B, six times the 50 MB L2), so
//     the form it takes here is an L2 prefetch: in the head kernel of step j,
//     every block but the last (the one that samples) prefetches its share of
//     the next trunk pass's layer-0 wqkv and wo rows into L2 with
//     prefetch.global.L2 (12.6 MB at 1.7B), while the last block runs the
//     sampler's 80 bisection rounds.
// The outputs equal K2's with a float32 cache on the same inputs, bit for
// bit: the same trunk passes (K1's layer kernels), head rows, sampler and
// gather (qtts_run_mtp_chain, qtts_head_rows, qtts_head_sample in
// qtts_kernels.cuh); a prefetch moves no values.
//
// What bounds it on the H100 (NVIDIA data sheet, SXM, 3.35 TB/s): each input
// read once -- the 302 MB trunk, 63 MB of heads, the table rows -- is ~0.11 ms;
// the trunk does not fit the L2, so each of the 16 passes streams it again,
// ~4.8 GB and ~1.44 ms per chain.  This simple design runs K1's GEMVs, which
// reach far below that rate (see fused_step.cu); the card measured and its
// power limit are in PERF.md.

#include "qtts_kernels.cuh"

namespace {

// Byte ranges the head kernel prefetches into L2: the next trunk pass's
// first two products (layer 0's wqkv, then wo).  Empty after the last step.
struct StreamPrefetch {
  const int8_t* a;
  size_t a_bytes;
  const int8_t* b;
  size_t b_bytes;
};

constexpr int kLine = 128;  // bytes per prefetch (an L2 line)

__global__ void __launch_bounds__(QTTS_GEMV_THREADS)
head_sample_prefetch_kernel(QttsHeadStep p, StreamPrefetch pf) {
  extern __shared__ float sh[];  // max(H, 2V) floats
  const unsigned ticket = qtts_head_rows(p, sh);
  const unsigned helpers = gridDim.x - 1;
  if (ticket == helpers) {
    qtts_head_sample(p, sh);
    return;
  }
  // block `ticket` of the `helpers` that finished first takes its slice of
  // the lines of a then b
  const size_t la = (pf.a_bytes + kLine - 1) / kLine;
  const size_t lines = la + (pf.b_bytes + kLine - 1) / kLine;
  const size_t per = (lines + helpers - 1) / helpers;
  const size_t hi = (size_t)(ticket + 1) * per;
  const size_t end = hi < lines ? hi : lines;
  for (size_t i = (size_t)ticket * per + threadIdx.x; i < end; i += blockDim.x) {
    const int8_t* line = i < la ? pf.a + i * kLine : pf.b + (i - la) * kLine;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(line));
  }
}

}  // namespace

extern "C" {

// Kernel K3 entry: subcodes [n] and sub_sum [H] of one frame's chain, with a
// float32 17-slot cache [L, nk, n + 2, D] in a->k_cache / a->v_cache.
int qtts_mtp_chain_streamed(const QttsStepWeights* w, const QttsStepScratch* s,
                            const QttsChainArgs* a, void* stream) {
  QttsChainArgs f32 = *a;
  f32.cache_bf16 = 0;
  const int A = (w->nq + 2 * w->nk) * w->D;
  const StreamPrefetch next{w->wqkv, (size_t)A * w->H, w->wo, (size_t)w->H * w->nq * w->D};
  return qtts_run_mtp_chain(
      *w, *s, f32, static_cast<cudaStream_t>(stream),
      [&](const QttsHeadStep& p, bool next_pass, int grid, size_t smem, cudaStream_t st) {
        head_sample_prefetch_kernel<<<grid, QTTS_GEMV_THREADS, smem, st>>>(
            p, next_pass ? next : StreamPrefetch{nullptr, 0, nullptr, 0});
      });
}

}  // extern "C"
