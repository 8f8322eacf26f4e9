// Kernel K6: the speculative verify step.  S = 2..8 candidate inputs of each
// of B streams (R = B * S <= 32 rows) run through every layer of a GQA
// transformer in one pass, candidate s of stream b at position pos[b] + s,
// with each weight row read once for all R rows, as ONE persistent
// cooperative launch (vstep_kernel).
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_verify.py::fused_verify_step
// (_make_verify_kernel, modes "vmem" and "win"; B = 1 there, and the JAX
// package's B > 1 verify runs plain XLA layers, which this kernel's R rows
// take over on the card).  Per layer, for every row (b, s), the same math as
// one K4 step of stream b at position pos[b] + s, op for op:
//   h = RMSNorm(x) * attn_norm;  qkv = (bf16(h) @ bf16(W)) * scale  (f32)
//   per-head QK-norm, RoPE at pos[b] + s, K/V written at that slot of cache
//   row b, attention over slots 0..pos[b] + s (an intra-block causal tail:
//   candidate s sees the new slots of candidates 0..s);
//   x += bf16(attn) @ Wo * scale; h = RMSNorm(x) * mlp_norm;
//   x += bf16(silu(gate) * up) @ Wd * scale.
// So row (b, s) equals what K1 / K4 give after stepping candidates 0..s-1 one
// at a time, bit for bit, which keeps greedy speculative output equal to
// greedy sequential output on the card.
//
// The race the Pallas kernel does not have: its S new slots sat in VMEM
// registers for the whole block.  Here candidate s reads slots pos..pos+s-1,
// which blocks of other rows write, in any order.  So every new slot is
// written to the cache first (qtts_kv_write_body) and the split attention
// then reads every slot, the new ones included, from memory, rounded to the
// cache dtype (the JAX "win" mode's tail used the unrounded register values;
// one rounding rule for every bucket here).  The starts come from a device
// array (the pool) or a host int (the engine) and are clamped into [0, T - S]
// in the kernel, as the JAX wrapper clamps them.
//
// The persistent pass is K4's (csrc/qtts_stream.cuh, qtts_bstep_phases in
// its VERIFY mode) on a plan of R rows: the TMA weight ring, the batch rows'
// bf16 GEMV inputs in shared memory (batch groups where R rows' inputs leave
// fewer than 3 ring slots: the 0.6B plan at R = 24 and 32), attention items
// per (row, kv head, split) up to each row's own position with a ticket per
// (row, kv head).  It adds one phase per layer after the qkv product: the
// slot write of every row's k and v, then a grid barrier, so seven grid
// barriers per layer.  The launch-per-op pass it replaced
// (qtts_verify_step_multi: ten launches per layer) stays for the checks.
//
// What bounds it on the H100: the int8 weight bytes, 440 MB per pass of the
// 0.6B talker whatever R is (0.13 ms at the 3.35 TB/s of an H100 SXM, NVIDIA
// data sheet), plus the cache each row reads; at R = 32 the R x 440 M
// multiply-adds on CUDA cores (~0.42 ms at 67 TFLOPS float32), since tensor
// cores would sum in another order than K1.

// bf16 units (the unquantized config, the JAX pack's bits=16: scales of one)
// run K4's bf16 stage units (WT), so a row equals K1 / K4 bf16 steps bit for
// bit; the bytes and the bound double (~880 MB per pass at 0.6B).  int4
// units (fused_int4.cu instantiates them) run K4's int4 units, so a row
// equals K1 / K4 int4 steps bit for bit; the weight bytes halve (~230 MB).
//
// An int8 KV cache (the JAX kernel's kvq mode; int8 and bf16 units): the slot-write
// phase quantizes every row's new k and v as K1's item would and writes the
// int8 values and their scales before its grid barrier, and the items read
// every slot's values and scales from the cache, so a row still equals the
// K1 / K4 steps it stands for bit for bit.  The launch-per-op pass takes no
// int8 cache.

// The build compiles this source as two objects (ops/_build.py PARTS): part
// 1 the verify pass at bf16 units, part 0 everything else.  Unset, both.
#ifndef QTTS_PART
#define QTTS_PART -1
#endif
#define QTTS_HAS_PART(part) (QTTS_PART < 0 || QTTS_PART == (part))

#include "qtts_stream.cuh"

#if QTTS_HAS_PART(1)
int qtts_launch_vstep_bf16(const QttsVStepLaunch& a, int cache, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_BF16) return (int)cudaErrorInvalidValue;
  return qtts_launch_vstep_cache<__nv_bfloat16>(a, cache, st);
}
#endif

#if QTTS_HAS_PART(0)
namespace {

int launch_verify_step(const QttsStepWeights& w, const QttsBatchScratch& s, const float* x_in,
                       float* x, void* k_cache, void* v_cache, int cache_bf16, int B, int S, int T,
                       const int64_t* pos_dev, int pos_host, cudaStream_t st) {
  if (w.unit_type != QTTS_UNIT_INT8 || w.D != QTTS_ATTN_D || w.nq % w.nk != 0 ||
      w.nq / w.nk > QTTS_ATTN_MAX_G) {
    return (int)cudaErrorInvalidValue;
  }
  const int R = B * S;
  if (S < 2 || S > 8 || B < 1 || R > QTTS_MAX_BATCH || T < S) return (int)cudaErrorInvalidValue;
  if (pos_dev == nullptr && (pos_host < 0 || pos_host > T - S)) return (int)cudaErrorInvalidValue;
  // device starts: every split of the bucket; a host start: its last row's
  const int n_splits = pos_dev ? (T + QTTS_ATTN_CHUNK - 1) / QTTS_ATTN_CHUNK
                               : (pos_host + S - 1) / QTTS_ATTN_CHUNK + 1;
  if (n_splits > s.max_splits) return (int)cudaErrorInvalidValue;
  const int H = w.H, I = w.I, qd = w.nq * w.D, A = qd + 2 * w.nk * w.D;
  if (x_in != x) {
    QTTS_TRY(cudaMemcpyAsync(x, x_in, (size_t)R * H * sizeof(float), cudaMemcpyDeviceToDevice,
                             st));
  }
  for (int l = 0; l < w.L; ++l) {
    QTTS_TRY((cudaError_t)qtts_launch_prep_rows(QTTS_IN_NORM, x, H, w.attn_norm + (size_t)l * H,
                                                w.eps, H, s.hb, R, st));
    QTTS_TRY((cudaError_t)qtts_launch_gemv_rows(s.hb, w.wqkv + (size_t)l * A * H,
                                                w.sqkv + (size_t)l * A, s.qkv, A, R, A, H, 0,
                                                st));
    if (cache_bf16) {
      QTTS_TRY(qtts_launch_attention(w, l, s.qkv, s.part, s.max_splits, s.hb,
                                     static_cast<__nv_bfloat16*>(k_cache),
                                     static_cast<__nv_bfloat16*>(v_cache), R, S, T, pos_dev,
                                     pos_host, n_splits, st));
    } else {
      QTTS_TRY(qtts_launch_attention(w, l, s.qkv, s.part, s.max_splits, s.hb,
                                     static_cast<float*>(k_cache), static_cast<float*>(v_cache),
                                     R, S, T, pos_dev, pos_host, n_splits, st));
    }
    QTTS_TRY((cudaError_t)qtts_launch_gemv_rows(s.hb, w.wo + (size_t)l * H * qd,
                                                w.so + (size_t)l * H, x, H, R, H, qd, 1, st));
    QTTS_TRY((cudaError_t)qtts_launch_prep_rows(QTTS_IN_NORM, x, H, w.mlp_norm + (size_t)l * H,
                                                w.eps, H, s.hb, R, st));
    QTTS_TRY((cudaError_t)qtts_launch_gemv_rows(s.hb, w.wgu + (size_t)l * 2 * I * H,
                                                w.sgu + (size_t)l * 2 * I, s.gu, 2 * I, R,
                                                2 * I, H, 0, st));
    QTTS_TRY((cudaError_t)qtts_launch_prep_rows(QTTS_IN_SILU, s.gu, 2 * I, nullptr, 0.f, I,
                                                s.hb, R, st));
    QTTS_TRY((cudaError_t)qtts_launch_gemv_rows(s.hb, w.wd + (size_t)l * H * I,
                                                w.sd + (size_t)l * H, x, H, R, H, I, 1, st));
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Kernel K6 entry: x_out [B * S, H] (row b * S + s) = the verify pass of
// x_in with the caches updated in place; pos_dev [B] int64 starts on the
// device, or null for every stream at pos_host.  One cooperative launch on
// the plan's grid (a plan of B * S rows).  The caches (and an int8 cache's
// scales) are [L, cache_rows, nk, T, D], of which the launch takes streams
// row0 .. row0 + B - 1: a call past QTTS_MAX_BATCH rows is split into
// launches of whole streams (ops/fused_verify.py), stream b's candidates on
// cache row row0 + b.
int qtts_verify_step(const QttsStepWeights* w, const QttsBatchScratch* s, const QttsPlan* p,
                     const float* x_in, float* x_out, void* k_cache, void* v_cache,
                     float* k_scale, float* v_scale, int cache_bf16, int B, int S, int T,
                     const int64_t* pos_dev, int pos_host, int cache_rows, int row0,
                     void* stream) {
  const int R = B * S, qd = w->nq * w->D;
  const bool i8 = k_scale != nullptr;
  const int n_splits = pos_dev ? (T + QTTS_ATTN_CHUNK - 1) / QTTS_ATTN_CHUNK
                               : (pos_host + S - 1) / QTTS_ATTN_CHUNK + 1;
  if (w->unit_type < QTTS_UNIT_INT8 || w->unit_type > QTTS_UNIT_INT4 ||
      w->D != QTTS_ATTN_D || w->nq % w->nk != 0 ||
      w->nq / w->nk > QTTS_ATTN_MAX_G || w->H % 16 != 0 || qd % 16 != 0 || w->I % 16 != 0 ||
      S < 2 || S > 8 || B < 1 ||
      R > QTTS_MAX_BATCH || T < S || (pos_dev == nullptr && (pos_host < 0 || pos_host > T - S)) ||
      n_splits > s->max_splits || x_in == x_out || !qtts_plan_ok(*p, *w, 0, R) ||
      i8 != (v_scale != nullptr) ||
      (i8 && (cache_bf16 || T % 128 != 0 || (T > 512 && T % 512 != 0))) || row0 < 0 ||
      row0 + B > cache_rows) {
    return (int)cudaErrorInvalidValue;
  }
  const int cache = i8 ? 2 : cache_bf16 ? 1 : 0;
  // the launch's first stream: row0 cache rows of layer 0 in (the layers'
  // stride stays cache_rows rows)
  const size_t first = (size_t)row0 * w->nk * T;
  const size_t esize = cache == 2 ? 1 : cache == 1 ? 2 : 4;
  void* kc = static_cast<char*>(k_cache) + first * w->D * esize;
  void* vc = static_cast<char*>(v_cache) + first * w->D * esize;
  float* ks = i8 ? k_scale + first : nullptr;
  float* vs = i8 ? v_scale + first : nullptr;
  const QttsVStepLaunch a{*w, *s, *p, x_in, x_out, kc, vc, ks, vs, pos_dev, B, S, T, pos_host,
                          cache_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w->unit_type) {
    case QTTS_UNIT_INT4: return qtts_launch_vstep_int4(a, cache, st);
    case QTTS_UNIT_BF16: return qtts_launch_vstep_bf16(a, cache, st);
    default: return qtts_launch_vstep_cache<int8_t>(a, cache, st);
  }
}

// The launch-per-op pass K6 ran before it was persistent (ten launches per
// layer: the row prologues and GEMVs of K4's launch sequence, the slot
// write, the split attention reading every slot from the cache, the
// combine): the reference chip_smoke.py holds the persistent pass to, bit for
// bit.  No wrapper calls it.
int qtts_verify_step_multi(const QttsStepWeights* w, const QttsBatchScratch* s, const float* x_in,
                           float* x_out, void* k_cache, void* v_cache, int cache_bf16, int B,
                           int S, int T, const int64_t* pos_dev, int pos_host, void* stream) {
  if (cache_bf16 != 0 && cache_bf16 != 1) return (int)cudaErrorInvalidValue;
  return launch_verify_step(*w, *s, x_in, x_out, k_cache, v_cache, cache_bf16, B, S, T, pos_dev,
                            pos_host, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

#endif  // QTTS_HAS_PART(0)
