// Kernels K1-K6 at int4 weight units (the CLI's --quantize int4 and
// --mtp-quantize int4 / auto): the instances of qtts_stream.cuh's step,
// chain, batched step, batched chain and verify kernels whose units are
// int4, in a translation unit of their own so that they build beside the
// int8 and bf16 ones (fused_step.cu, fused_mtp.cu, fused_step_batched.cu,
// fused_mtp_batched.cu, fused_verify.cu), whose entries dispatch here.
//
// Replaces the w4 path of leaxer_qwen3_tts_tpu/ops/fused_step.py
// (_make_matmul at n_groups > 1: the nibbles unpacked, one bf16 dot per
// 128-row group with its float32 scale applied after the dot) in
// fused_decode_step, fused_mtp_chain and fused_mtp_chain_streamed, and its
// batched modes (KU == H // 2) in fused_decode_step_batched,
// fused_mtp_chain_batched and fused_verify_step.  The port's int4 rows
// hold the same integers and scales as the JAX unit pack
// (ops/fused_step.py::pack_fused_weights at bits=4); a row is K / 2 bytes,
// byte j holding columns 2j (low nibble) and 2j + 1 (high), two's
// complement, beside K / 128 float32 scales.  Everything but the GEMV stage
// is the int8 kernel's: the ring copies a stage's rows and their group
// scales (qtts_ring_issue: row bytes and scale floats by unit type), and
// qtts_stage_rows4 unpacks each lane's 16 columns from one 8-byte load
// (qtts_i4_to_float: a bias into a float's mantissa, no integer
// conversion), sums them apart per group and adds the partial times the
// group's scale; the batched units (qtts_bstage_unit4) keep that order per
// (row, batch row), so a K4 / K5 / K6 row equals K1 / K2 at int4 bit for
// bit.  The heads stay int8 (JAX's int4 mode keeps lm_head and
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

#include "qtts_frame.cuh"

// The build compiles this source as nine objects, part QTTS_PART
// instantiating its share of the kernels (ops/_build.py PARTS): 0 the B=1
// step, 1 the B=1 chains, 2 the batched step, 3 the verify pass, 4 the
// batched chain, 5-8 the frame K7 at its four unit mixes with int4 units
// (talker / trunk: int4 / int4, int8 / int4, int4 / int8, bf16 / int4).
// Unset, every part.
#ifndef QTTS_PART
#define QTTS_PART -1
#endif
#define QTTS_INT4_HAS(part) (QTTS_PART < 0 || QTTS_PART == (part))

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


// qtts_bstage_unit at int4 units: R weight rows x BT batch rows, each
// (row, batch row) summed in qtts_stage_rows4's order.  Lane l's 16 columns
// of pass t (l * 16 + t * 512 ..) lie in one 128-column group g; for each
// pair the lane sums their 16 products from zero in element order (the
// row's one 8-byte load of 16 nibbles, the batch row's two 16-byte bf16
// halves of act), then adds that partial times the group's scale to the
// pair's accumulator (fmaf); the xor butterfly sums the lanes and no row
// scale follows.  So row b of a batched product equals the B=1 int4 product
// on row b bit for bit.  The slot's scale area holds K / 128 floats a row.
template <bool ACCUM, int R, int BT>
static __device__ __forceinline__ void qtts_bstage_unit4(const unsigned char* ws, const float* ss,
                                                         const __nv_bfloat16* act, int K,
                                                         float* out, int ldo, int n0, int r0,
                                                         int b0, int nb, int lane) {
  // lane l stores pair l = (stage row r0 + l / BT, batch row b0 + l % BT)
  const int pr = lane / BT, pb = lane % BT;
  const bool stores = lane < R * BT && b0 + pb < nb;
  float* dst = out + (size_t)(b0 + pb) * ldo + n0 + r0 + pr;
  float res = 0.f;
  if (ACCUM && stores) res = *dst;
  const int kp = (K + 511) & ~511, G = K / 128;
  const unsigned char* wrow = ws + (size_t)r0 * (K / 2) + lane * 8;
  const float* srow = ss + (size_t)r0 * G;
  const __nv_bfloat16* arow = act + lane * 8;
  float acc[R][BT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[r][b] = 0.f;
  }
  for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
    const int t0 = k0 - lane * 16;  // the pass's first column
    const int g = k0 >> 7;
    uint2 wv[R];  // the rows' 16 nibbles of this pass
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wv[r] = *reinterpret_cast<const uint2*>(wrow + (size_t)r * (K / 2) + t0 / 2);
    }
    float part[R][BT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int b = 0; b < BT; ++b) part[r][b] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t av[BT][4];  // the batch rows' 8 bf16 of this half
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const int row = min(b0 + b, nb - 1);
        const int4 v =
            *reinterpret_cast<const int4*>(arow + (size_t)row * kp + t0 + 256 * h);
        av[b][0] = (uint32_t)v.x;
        av[b][1] = (uint32_t)v.y;
        av[b][2] = (uint32_t)v.z;
        av[b][3] = (uint32_t)v.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float wf[R];
#pragma unroll
        for (int r = 0; r < R; ++r) wf[r] = qtts_i4_to_float(h ? wv[r].y : wv[r].x, e);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const uint32_t word = av[b][e >> 1];
          const float hv = __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
#pragma unroll
          for (int r = 0; r < R; ++r) part[r][b] = fmaf(hv, wf[r], part[r][b]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sc = srow[r * G + g];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[r][b] = fmaf(part[r][b], sc, acc[r][b]);
    }
  }
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float s = qtts_warp_reduce(acc[r][b], QttsSumF());
      if (lane == r * BT + b) v = s;  // the butterfly leaves the sum on every lane
    }
  }
  if (stores) *dst = ACCUM ? __fadd_rn(res, v) : v;
}


#if QTTS_INT4_HAS(0)
int qtts_launch_step_int4(const QttsStepLaunch& a, int cache, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_INT4) return (int)cudaErrorInvalidValue;
  switch (cache) {
    case 0: return qtts_launch_persistent(step_kernel<float, QttsInt4>, a, a.p, st);
    case 1: return qtts_launch_persistent(step_kernel<__nv_bfloat16, QttsInt4>, a, a.p, st);
    case 2: return qtts_launch_persistent(step_kernel<int8_t, QttsInt4>, a, a.p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if QTTS_INT4_HAS(1)
int qtts_launch_chain_int4(const QttsChainLaunch& a, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_INT4) return (int)cudaErrorInvalidValue;
  return qtts_launch_chain_heads<QttsInt4>(a, st);
}
#endif

#if QTTS_INT4_HAS(2)
int qtts_launch_bstep_int4(const QttsBStepLaunch& a, int cache, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_INT4) return (int)cudaErrorInvalidValue;
  return qtts_launch_bstep_cache<QttsInt4>(a, cache, st);
}
#endif

#if QTTS_INT4_HAS(3)
int qtts_launch_vstep_int4(const QttsVStepLaunch& a, int cache, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_INT4) return (int)cudaErrorInvalidValue;
  return qtts_launch_vstep_cache<QttsInt4>(a, cache, st);
}
#endif

#if QTTS_INT4_HAS(4)
int qtts_launch_bchain_int4(const QttsBChainLaunch& a, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_INT4) return (int)cudaErrorInvalidValue;
  return a.c.heads_bf16 ? qtts_launch_bchain_cache<QttsInt4, __nv_bfloat16>(a, st)
                        : qtts_launch_bchain_cache<QttsInt4, int8_t>(a, st);
}
#endif

// K7 at the mixes with int4 units (qtts_frame.cuh): each phase on the stage
// unit of its weight set's type, the heads and lm_head int8 beside an int8 or
// int4 talker and bf16 beside a bf16 one, each on a float32, bf16 or int8
// talker cache.
#if QTTS_INT4_HAS(5)
int qtts_launch_frame_i4_i4(const QttsFrameLaunch& f, cudaStream_t st) {
  if (f.a.tw.unit_type != QTTS_UNIT_INT4 || f.a.mw.unit_type != QTTS_UNIT_INT4) {
    return (int)cudaErrorInvalidValue;
  }
  return qtts_launch_frame_caches<QttsInt4, QttsInt4>(f, st);
}
#endif

#if QTTS_INT4_HAS(6)
int qtts_launch_frame_i8_i4(const QttsFrameLaunch& f, cudaStream_t st) {
  if (f.a.tw.unit_type != QTTS_UNIT_INT8 || f.a.mw.unit_type != QTTS_UNIT_INT4) {
    return (int)cudaErrorInvalidValue;
  }
  return qtts_launch_frame_caches<QttsInt4, int8_t>(f, st);
}
#endif

#if QTTS_INT4_HAS(7)
int qtts_launch_frame_i4_i8(const QttsFrameLaunch& f, cudaStream_t st) {
  if (f.a.tw.unit_type != QTTS_UNIT_INT4 || f.a.mw.unit_type != QTTS_UNIT_INT8) {
    return (int)cudaErrorInvalidValue;
  }
  return qtts_launch_frame_caches<int8_t, QttsInt4>(f, st);
}
#endif

#if QTTS_INT4_HAS(8)
int qtts_launch_frame_bf16_i4(const QttsFrameLaunch& f, cudaStream_t st) {
  if (f.a.tw.unit_type != QTTS_UNIT_BF16 || f.a.mw.unit_type != QTTS_UNIT_INT4) {
    return (int)cudaErrorInvalidValue;
  }
  return qtts_launch_frame_caches<QttsInt4, __nv_bfloat16>(f, st);
}
#endif
