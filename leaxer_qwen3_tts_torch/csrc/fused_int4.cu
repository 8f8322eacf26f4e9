// Kernels K1, K2 and K3 at int4 weight units (the CLI's --quantize int4 and
// --mtp-quantize int4 / auto): the instances of qtts_stream.cuh's step and
// chain kernels whose units are int4, in a translation unit of their own so
// that they build beside the int8 and bf16 ones (fused_step.cu,
// fused_mtp.cu), whose entries dispatch here.
//
// Replaces the w4 path of leaxer_qwen3_tts_tpu/ops/fused_step.py
// (_make_matmul at n_groups > 1: the nibbles unpacked, one bf16 dot per
// 128-row group with its float32 scale applied after the dot) in
// fused_decode_step, fused_mtp_chain and fused_mtp_chain_streamed.  The
// port's int4 rows hold the same integers and scales as the JAX unit pack
// (ops/fused_step.py::pack_fused_weights at bits=4); a row is K / 2 bytes,
// byte j holding columns 2j (low nibble) and 2j + 1 (high), two's
// complement, beside K / 128 float32 scales.  Everything but the GEMV stage
// is the int8 kernel's: the ring copies a stage's rows and their group
// scales (qtts_ring_issue: row bytes and scale floats by unit type), and
// qtts_stage_rows4 unpacks each lane's 16 columns from one 8-byte load
// (qtts_i4_to_float: a bias into a float's mantissa, no integer
// conversion), sums them apart per group and adds the partial times the
// group's scale.  The heads stay int8 (JAX's int4 mode keeps lm_head and
// the MTP heads int8) or are bf16 (raw heads beside the unquantized
// talker): a template argument of their own.
//
// What bounds it on the H100 (NVIDIA data sheet, SXM, 3.35 TB/s): the
// weight bytes, 0.5 per weight plus 4 bytes of scale per 128: ~248 MB per
// 0.6B talker step (0.074 ms), ~0.79 GB at 1.7B (0.24 ms); the chain's
// trunk 16 times per frame.  At one token the kernels stay latency-bound,
// as at int8 (grid barriers, the attention items, the draws); the unpack
// adds two integer operations and a float add per weight to the dot
// products, which at int8 already run far below the bytes' bound.  The card
// measured, its power limit and the times against the bound are in PERF.md.

#include "qtts_stream.cuh"

// Nibble e (0..7) of `word` as a signed int4, as float: the nibble biased by
// 8 forms the low mantissa bits of 2^23 (the float 8388608 + u, exact),
// minus 8388616 -- exactly the two's-complement value, with no integer
// conversion.
static __device__ __forceinline__ float qtts_i4_to_float(uint32_t word, int e) {
  const uint32_t biased = ((word ^ 0x88888888u) >> (4 * e)) & 0xFu;
  return __fadd_rn(__uint_as_float(0x4B000000u | biased), -8388616.f);
}

// qtts_stage_rows at int4 units (rows of K / 2 bytes, ss: K / 128 scales per
// row): lane l's 16 columns of a pass (l * 16 + t * 512 ..) lie in one
// 128-column group g, so the lane sums their 16 products in element order
// from zero (one 8-byte load of 16 nibbles) and adds that partial times the
// group's scale to the row's accumulator; the xor butterfly then sums the
// lanes, and no row scale follows.  Each group's products are summed apart
// and scaled after their sum, as the JAX kernel's _make_matmul does per
// group (the sum's order is the kernel's own).
template <bool ACCUM, int M>
static __device__ __forceinline__ void qtts_stage_rows4(const unsigned char* ws, const float* ss,
                                                        const float* sh, float* out, int n0,
                                                        int K, int warp, int lane) {
  const int G = K / 128;
  float res[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    res[j] = 0.f;
    if (ACCUM && lane == 0) res[j] = out[n0 + warp + j * QTTS_P_WARPS];
  }
  float acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = 0.f;
  for (int k0 = lane * 16, t0 = 0; k0 < K; k0 += 32 * 16, t0 += 32 * 16) {
    float hv[16];  // columns k0 .. k0 + 15
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 t4 = *reinterpret_cast<const float4*>(sh + t0 + q * 128 + lane * 4);
      hv[4 * q] = t4.x;
      hv[4 * q + 1] = t4.y;
      hv[4 * q + 2] = t4.z;
      hv[4 * q + 3] = t4.w;
    }
    const int g = k0 >> 7;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int row = warp + j * QTTS_P_WARPS;
      const uint2 v = *reinterpret_cast<const uint2*>(ws + (size_t)row * (K / 2) + (k0 >> 1));
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) part = fmaf(hv[e], qtts_i4_to_float(v.x, e), part);
#pragma unroll
      for (int e = 0; e < 8; ++e) part = fmaf(hv[8 + e], qtts_i4_to_float(v.y, e), part);
      acc[j] = fmaf(part, ss[row * G + g], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = qtts_warp_reduce(acc[j], QttsSumF());
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      out[n0 + warp + j * QTTS_P_WARPS] = ACCUM ? __fadd_rn(res[j], acc[j]) : acc[j];
    }
  }
}


int qtts_launch_step_int4(const QttsStepLaunch& a, int cache, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_INT4) return (int)cudaErrorInvalidValue;
  switch (cache) {
    case 0: return qtts_launch_persistent(step_kernel<float, QttsInt4>, a, a.p, st);
    case 1: return qtts_launch_persistent(step_kernel<__nv_bfloat16, QttsInt4>, a, a.p, st);
    case 2: return qtts_launch_persistent(step_kernel<int8_t, QttsInt4>, a, a.p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int qtts_launch_chain_int4(const QttsChainLaunch& a, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_INT4) return (int)cudaErrorInvalidValue;
  return qtts_launch_chain_heads<QttsInt4>(a, st);
}
