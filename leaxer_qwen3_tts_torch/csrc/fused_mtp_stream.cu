// Kernel K3: the B=1 MTP sub-code chain with a streamed trunk and a float32
// KV scratch (the 1.7B chain, whose int8 trunk is past the residency gate,
// and every bf16 trunk: the unquantized config's B=1 chain at 0.6B and
// 1.7B, bf16 units and bf16 heads with scales of one).
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_mtp_stream.py::fused_mtp_chain_streamed
// (_make_stream_chain_kernel).  It computes what K2 computes, with the JAX
// kernel's two differences carried over:
//   * the 17-slot KV scratch is float32 whatever the model dtype (the JAX
//     kernel's kc_s / vc_s), so at a bf16 model K3 is K2 with a float32
//     cache, not K2 at the config dtype; these entries ignore the args'
//     cache dtype and always run the float32 cache;
//   * the trunk is streamed with the next chain position's weight reads
//     started behind the current position's work: on the TPU a DMA ring
//     that runs across positions.  Here that ring is K2's TMA weight ring
//     (qtts_stream.cuh), whose one stage sequence runs through every trunk
//     pass and head of the chain, so the next pass's first stages load while
//     block 0 samples.  K3 is one cooperative launch of K2's persistent
//     chain (chain_kernel, qtts_chain_phases) on a float32 cache, with the
//     plan ops/persistent.py builds for the 1.7B widths.
// So its sub-codes and sub_sum equal K2's with a float32 cache on the same
// inputs, bit for bit, and those of the launch-per-op chain it replaced
// (qtts_mtp_chain_streamed_multi: K1's layer launches per trunk pass and one
// head kernel per step); chip_smoke.py checks both.
//
// What bounds it on the H100 (NVIDIA data sheet, SXM, 3.35 TB/s): each input
// read once -- the 302 MB trunk, 63 MB of heads, the table rows -- is ~0.11 ms;
// the trunk does not fit the 50 MB L2, so each of the 16 passes streams it
// again, ~4.8 GB and ~1.44 ms per chain.  At one token the chain is bound by
// latency instead: grid barriers (~510 per chain), the 15 draws on one
// block, and each block's stages of a phase; the card measured, its power
// limit and the per-phase trace are in PERF.md.  bf16 units double the
// trunk's and the heads' bytes, and so each bound above.

#include "qtts_stream.cuh"

extern "C" {

// Kernel K3 entry: subcodes [n] and sub_sum [H] of one frame's chain, with a
// float32 17-slot cache [L, nk, n + 2, D] in a->k_cache / a->v_cache, in one
// cooperative launch on the plan's grid.
int qtts_mtp_chain_streamed(const QttsStepWeights* w, const QttsStepScratch* s, const QttsPlan* p,
                            const QttsChainArgs* a, void* stream) {
  QttsChainArgs f32 = *a;
  f32.cache_bf16 = 0;
  return qtts_mtp_chain(w, s, p, &f32, stream);
}

// The launch-per-op K3 (K2's launch-per-op chain on a float32 cache): the
// reference chip_smoke.py holds the persistent K3 to, bit for bit; no
// wrapper calls it.
int qtts_mtp_chain_streamed_multi(const QttsStepWeights* w, const QttsStepScratch* s,
                                  const QttsChainArgs* a, void* stream) {
  QttsChainArgs f32 = *a;
  f32.cache_bf16 = 0;
  return qtts_mtp_chain_multi(w, s, &f32, stream);
}

}  // extern "C"
