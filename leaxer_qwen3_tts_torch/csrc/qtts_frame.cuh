// The persistent frame kernel K7 (fused_frame.cu), as a template over the
// caches' and the two weight sets' unit types, so that fused_frame.cu (the
// int8 talker beside the int8 trunk, and in a part of its own the bf16
// talker beside it) and fused_int4.cu (every mix with int4 units, where the
// int4 stage unit is defined) instantiate it in parts of the parallel build.
//
// Unit mixes (the JAX frame kernel's tw4 / mw4 and bits=16 talker; its gate
// admits int8 and int4 trunks, never bf16 ones): the talker's units TWT are
// int8, int4 or bf16, the trunk's MWT int8 or int4.  The chain heads and the
// lm_head are bf16 rows (scales of one) beside a bf16 talker, as the engine
// packs the raw heads of an unquantized model, else int8 rows: HT.  Each
// phase runs the stage unit of the kernel it equals -- the chain K2's at
// MWT with heads HT, the talker step K1's at TWT, the lm_head K1's GEMV at
// HT -- so K7 equals the composition K2 -> float32 x -> K1 -> norm + head
// bit for bit at every mix.

#pragma once

#include "qtts_stream.cuh"

#include <type_traits>

// The frame's one argument (travels by value; outside the anonymous
// namespace, so that both sources' entries take the one type).
struct QttsFrameLaunch {
  QttsFrameArgs a;
  QttsPlan p;
};

namespace {

constexpr int kCode0Vpt = 12;  // code0's logits per thread: Vc <= 3072

__device__ __forceinline__ float load_in(const void* p, int bf16, int k) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[k])
              : static_cast<const float*>(p)[k];
}

// The heads' and lm_head's unit type beside a talker of units TWT.
template <typename TWT>
using QttsFrameHeads =
    typename std::conditional<std::is_same<TWT, __nv_bfloat16>::value, __nv_bfloat16,
                              int8_t>::type;

// CT: the chain's cache type; TCT: the talker's (int8_t: an int8 talker
// cache with its scales, beside a bf16 chain cache).  MWT, TWT: the trunk's
// and the talker's unit types.
template <typename CT, typename TCT, typename MWT, typename TWT>
__global__ void __launch_bounds__(QTTS_P_THREADS, 1)
frame_kernel(const __grid_constant__ QttsFrameLaunch f) {
  using HT = QttsFrameHeads<TWT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ QttsSeq seq;
  QttsRing ring;
  const QttsFrameArgs& a = f.a;
  const QttsChainArgs& c = a.mc;
  const int H = a.tw.H, tid = threadIdx.x;
  // set 0: the MTP trunk and its n heads in chain order; set 1: the talker
  // step and its lm_head; both head products of HT
  const QttsSetSpec sets[QTTS_SETS] = {
      {&a.mw, c.heads, c.head_scales, c.n, c.V, 1, 0, (int)sizeof(HT)},
      {&a.tw, a.lm, a.lm_scale, 1, a.Vc, 0, 0, (int)sizeof(HT)}};
  qtts_ring_start(ring, seq, smem, f.p, sets);
  int stage = 0;
  // code0 on block 0 while the chain's first stages load: the gated logits
  // drawn by the register sampler on the whole Vc row, then its codec row;
  // every block copies its share of last_hidden into the chain's float32
  // first input
  if (blockIdx.x == 0) {
    const int c0 = qtts_sample_regs<kCode0Vpt>(
        [&](int v) {
          const float add = (v == a.eos && a.forbid_eos) ? QTTS_NEG_INF : 0.f;
          return __fadd_rn(__fadd_rn(a.last_logits[v], a.suppress[v]), add);
        },
        a.Vc, a.g0, c.temperature, c.top_k, c.top_p, c.greedy,
        *reinterpret_cast<QttsSampleSmem*>(smem), &f.p);
    if (tid == 0) a.codes[0] = c0;
    for (int k = tid; k < H; k += blockDim.x) {
      a.c0e[k] = __bfloat162float(a.codec[(size_t)c0 * H + k]);
    }
  }
  for (int k = blockIdx.x * blockDim.x + tid; k < H; k += gridDim.x * blockDim.x) {
    a.lh[k] = load_in(a.last_hidden, a.lh_bf16, k);
  }
  qtts_phase_barrier(f.p);
  // the chain; after its last gather block 0 forms the next talker input
  // c0e + sub_sum + drip in float32 (each thread wrote its c0e[k] above and
  // its sub_sum[k] just before); a grid barrier (the talker's first layer
  // reads x), then the talker step on set 1 as the chain's tail
  const QttsStepTail<TCT> talker{&a.tw, &a.ts, 1, a.x, static_cast<TCT*>(a.k_cache),
                                 static_cast<TCT*>(a.v_cache), a.k_scale, a.v_scale, a.T, a.pos};
  qtts_chain_phases<CT, MWT, TCT, HT, TWT>(a.mw, a.ms, f.p, ring, seq, 0, stage, c, smem, [&] {
    for (int k = tid; k < H; k += blockDim.x) {
      a.x[k] = __fadd_rn(__fadd_rn(a.c0e[k], c.sub_sum[k]), load_in(a.drip, a.drip_bf16, k));
    }
  }, &talker);
  // final norm + lm_head: one more ring GEMV, block 0 writing the float32
  // normed values (before the bf16 rounding) as hidden
  qtts_prologue<QTTS_IN_NORM>(a.x, a.talker_norm, a.tw.eps, H, reinterpret_cast<float*>(smem),
                              blockIdx.x == 0 ? a.hidden : nullptr);
  qtts_ring_gemv<false, HT>(f.p, ring, seq, QTTS_KINDS + QTTS_KIND_HEAD, stage,
                            reinterpret_cast<float*>(smem), a.logits);
  qtts_trace_end(f.p);
}

// The frame of unit types MWT / TWT on its caches: a float32 or bf16 cache
// shared by the chain and the talker, or an int8 talker cache (its scales
// set) beside a bf16 chain cache.
template <typename MWT, typename TWT>
int qtts_launch_frame_caches(const QttsFrameLaunch& f, cudaStream_t st) {
  if (f.a.k_scale != nullptr) {
    return qtts_launch_persistent(frame_kernel<__nv_bfloat16, int8_t, MWT, TWT>, f, f.p, st);
  }
  return f.a.cache_bf16
             ? qtts_launch_persistent(frame_kernel<__nv_bfloat16, __nv_bfloat16, MWT, TWT>, f,
                                      f.p, st)
             : qtts_launch_persistent(frame_kernel<float, float, MWT, TWT>, f, f.p, st);
}

}  // namespace

// K7 at the unit mixes other than an int8 talker beside an int8 trunk, one
// function a mix (each a part of the parallel build), named talker units then
// trunk units: fused_int4.cu the four with int4 units, fused_frame.cu the bf16
// talker beside the int8 trunk.  Each refuses another mix.
int qtts_launch_frame_i4_i4(const QttsFrameLaunch& f, cudaStream_t st);
int qtts_launch_frame_i8_i4(const QttsFrameLaunch& f, cudaStream_t st);
int qtts_launch_frame_i4_i8(const QttsFrameLaunch& f, cudaStream_t st);
int qtts_launch_frame_bf16_i8(const QttsFrameLaunch& f, cudaStream_t st);
int qtts_launch_frame_bf16_i4(const QttsFrameLaunch& f, cudaStream_t st);
