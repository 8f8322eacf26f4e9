// Kernel K10: the tensor-parallel MTP sub-code chain of one frame, one
// persistent cooperative launch per device for every rank placed there.
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_mtp_tp.py::fused_mtp_chain_tp
// (_make_tp_chain_kernel), one Pallas kernel per chip that runs the whole
// chain on its Megatron shard and exchanges partial sums over ICI inside the
// kernel.  Same function: iterations it = 0 .. n + 1; it 0 and 1 feed
// last_hidden and code0_embed; from it 2, sample j = it - 2: the rank's
// [1, Hs] x [Hs, V] head rows, all-reduced, then scaled, the sampler on the
// replicated noise, the table row into sub_sum and the next input; while
// it <= n, a trunk pass at position it: per layer the rank's qkv rows, its
// kv heads' attention over a float32 [L, nk, n + 2, D] scratch, the wo
// partial all-reduced into the residual, RMSNorm, gate|up, silu, the down
// partial all-reduced into the residual.
//
// Design.  K2's transport (qtts_stream.cuh) on each rank's block group:
// the rank's trunk shard as K1's row pack and its slice of the head rows
// ([n, V, Hs]: columns [r Hs, (r + 1) Hs) of every head row) stream through
// the TMA weight ring in chain order, each product's output rows spread over
// all the rank's blocks by the rank's plan (ops/persistent.py, the same
// bounds on every rank).  Phases end at the rank's group barrier; the o,
// down and head products end in qtts_tp.cuh's exchange, the ranks' rows
// summed in the hypercube's order.  The draw runs on block 0 of each rank on
// the replicated noise, so every rank draws the same sub-code.  The head's
// partials are summed before the scale, as the JAX kernel sums them.
//
// Rounding: every product and sum is rounded on its own and each reduction
// runs in a fixed order that the plain version (ops/fused_mtp_tp.py) takes
// step for step, the orders K10 took before the ring: the RMSNorms'
// per-thread sums and halving trees (tp_prologue); the row products'
// 16 slices per KC-row chunk (slice s: k = s, s + 16, ... of the chunk, each
// bf16 x int8 or bf16 x bf16 product exact in float32, so the fused
// multiply-add rounds once as the separate sum would), the slices added in
// order, times the row's scale, the chunks added in order (tp_stage_rows);
// the attention's 4-wide lane dots and warp tree, the softmax's and the
// weighted values' slot order (tp_attn_item); the exchange's hypercube.
// RoPE reads a cos / sin table of the chain's n + 2 positions that the
// wrapper computes once per entry, as the plain version does.  So the two
// agree bit for bit on the card.
//
// What bounds it on the H100: the ranks' trunk shards and head rows, read
// once per pass and per head (the 1.7B trunk at tp=4: 302 MB x 16 passes of
// int8 over all ranks, 1.44 ms at 3.35 TB/s when the ranks share the card,
// most of it from L2 after the first pass); at one token it is
// latency-bound: five group barriers and two exchanges per layer and pass,
// one block's draw per sub-code.

#include "qtts_tp.cuh"

// One rank's shard, inputs and buffers (every pointer on the rank's device).
struct QttsTpRank {
  QttsStepWeights w;              // the trunk shard: K1's row pack at the shard's widths (int8)
  QttsPlan p;                     // the rank's plan on bpr blocks: trunk and head rows
  const void* heads;              // [n, V, Hs] int8 or bf16: the rank's slice of each head row
  const float* head_scales;       // [n, V] (applied after the all-reduce)
  const __nv_bfloat16* tables;    // [n, Vt, H]
  const float* gumbel;            // [n, V] (unread when greedy)
  const float* final_norm;        // [H]
  const float* last_hidden;       // [H]
  const float* code0_embed;       // [H]
  const float* rope;              // [n + 2, 2, D / 2]: cos, sin of position * inv_freq
  float* x;                       // [H] residual
  float* x_in;                    // [H] the sampled embedding, the next pass's input
  float* qkv;                     // [A]
  float* attn;                    // [nq D]
  float* gu;                      // [2 I]
  float* part;                    // [W] the rank's partial of the current exchange
  float* logits;                  // [V]
  float* k_cache;                 // [L, nk, n + 2, D] float32
  float* v_cache;
  int32_t* codes;                 // [n] the rank's sub-codes
  float* sub_sum;                 // [H]
};

struct QttsTpChainArgs {
  QttsTpRank rank[QTTS_TP_MAX];
  QttsTpLink link[QTTS_TP_MAX];
  int32_t tp, rank0, n_local, bpr;  // the launch runs ranks rank0 .. rank0 + n_local - 1
  int32_t n, V, Vt, W;
  int32_t KCo, KCd;                 // the o and down products' chunks (the JAX pack's KC)
  uint32_t gen;                     // this call's flag value
  float temperature;                // max(temperature, 1e-6) (sampled)
  int32_t top_k;
  float top_p;
  int32_t greedy, heads_bf16, cross_device, stall_ns;
  int64_t timeout_ns;
};
static_assert(sizeof(QttsTpChainArgs) <= 4096, "a kernel parameter of at most 4 KB");

namespace {

// The halving tree of part[0 .. n) (n a power of two) on threads t < n of
// the barrier sync: in round o = n / 2, n / 4, ..., 1, part[t] += part[t + o]
// for t < o.  Returns part[0] on every thread; part is free after it.
template <typename Sync>
__device__ __forceinline__ float tp_tree(float* part, int n, Sync sync, int t) {
  for (int o = n / 2; o > 0; o >>= 1) {
    if (t < o) part[t] = __fadd_rn(part[t], part[t + o]);
    sync();
  }
  const float total = part[0];
  sync();
  return total;
}

// 1 / sqrt(ss / K + eps), each step rounded (IEEE division and square root).
__device__ __forceinline__ float tp_inv_rms(float ss, int K, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)K), eps)));
}

// The GEMV input (sh[k] = bf16(transform(in))[k0 + k] for k < n; IN_NORM,
// IN_PLAIN, IN_SILU as in qtts_prologue) with every product and sum rounded
// on its own in the plain version's order: thread t of 256 sums the squares
// of k = t, t + 256, ... in order, tp_tree adds the 256 sums (part: 256
// floats).  The activations come from other blocks of the launch, so they
// are read past L1.
template <int IN_MODE>
__device__ __forceinline__ void tp_prologue(const float* in, const float* __restrict__ norm_w,
                                            float eps, int K, int k0, int n, float* sh,
                                            float* part) {
  float r = 0.f;
  if (IN_MODE == QTTS_IN_NORM) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += QTTS_P_THREADS) {
      const float v = __ldcg(in + k);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    part[threadIdx.x] = ss;
    __syncthreads();
    r = tp_inv_rms(tp_tree(part, QTTS_P_THREADS, QttsBlockSync{}, threadIdx.x), K, eps);
  }
  for (int k = threadIdx.x; k < n; k += QTTS_P_THREADS) {
    const int kk = k0 + k;
    float v;
    if (IN_MODE == QTTS_IN_NORM) {
      v = __fmul_rn(__fmul_rn(__ldcg(in + kk), r), norm_w[kk]);
    } else if (IN_MODE == QTTS_IN_PLAIN) {
      v = __ldcg(in + kk);
    } else {
      const float g = __ldcg(in + kk);
      const float u = __ldcg(in + K + kk);
      v = __fmul_rn(__fmul_rn(g, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)))), u);
    }
    sh[k] = qtts_bf16_round(v);
  }
  __syncthreads();
}

// Four consecutive weights of a row as floats (exact): 4 bytes of int8, 8 of bf16.
__device__ __forceinline__ void tp_load4(const int8_t* p, float (&w)[4]) {
  const uint32_t word = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = qtts_i8_to_float(word, e);
}
__device__ __forceinline__ void tp_load4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  w[0] = __uint_as_float(raw.x << 16);
  w[1] = __uint_as_float(raw.x & 0xffff0000u);
  w[2] = __uint_as_float(raw.y << 16);
  w[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// A warp's 8 rows of one ring stage (rows 8 warp .. 8 warp + 7 of the
// stage's `rows`, each on a quad of lanes): out[n0 + row] = the row's dot
// product with sh (K floats), per KC-column chunk in order: 16 slices (slice
// s: columns s, s + 16, ... of the chunk, fused multiply-adds in column
// order; lane j of the quad holds slices 4 j .. 4 j + 3, one 4-column load
// per 16 columns), the slices added in order 0 .. 15, times the row's scale
// ss when scaled, added to the previous chunks' sum.
template <typename WT>
__device__ __forceinline__ void tp_stage_rows(const WT* ws, const float* ss, bool scaled,
                                              const float* sh, float* out, int n0, int rows,
                                              int K, int KC, int warp, int lane) {
  const int row = warp * 8 + (lane >> 2), j = lane & 3, quad = lane & ~3;
  const bool live = row < rows;
  const WT* w = ws + (size_t)(live ? row : 0) * K;
  float total = 0.f;
  for (int c0 = 0; c0 < K; c0 += KC) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
#pragma unroll 4
      for (int k = c0 + 4 * j; k < c0 + KC; k += 16) {
        float wv[4];
        tp_load4(w + k, wv);
        const float4 h = *reinterpret_cast<const float4*>(sh + k);
        acc[0] = fmaf(h.x, wv[0], acc[0]);
        acc[1] = fmaf(h.y, wv[1], acc[1]);
        acc[2] = fmaf(h.z, wv[2], acc[2]);
        acc[3] = fmaf(h.w, wv[3], acc[3]);
      }
    }
    float d = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __shfl_sync(0xffffffffu, acc[e], quad | q);
        d = q == 0 && e == 0 ? v : __fadd_rn(d, v);
      }
    }
    const float p = scaled ? __fmul_rn(d, ss[live ? row : 0]) : d;
    total = c0 == 0 ? p : __fadd_rn(total, p);
  }
  if (live && j == 0) out[n0 + row] = total;
}

// Consumes the block's stages of kind `kind` in order (`stage` counts the
// launch's stages), tp_stage_rows on each, as qtts_ring_gemv does with K1's
// rows: after a stage thread 0 refills its slot with the stage n_slots ahead.
template <typename WT>
__device__ __forceinline__ void tp_ring_gemv(const QttsPlan& p, const QttsRing& ring, QttsSeq& q,
                                             int kind, int& stage, const float* sh, float* out,
                                             int KC, bool scaled) {
  qtts_trace_mark(p, 0);
  const QttsKindRows& r = q.kind[kind];
  const int K = r.K, chunks = r.chunks, stage_rows = r.stage_rows, r0 = r.r0, nrows = r.rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = 0; c < chunks; ++c) {
    const int slot = stage % ring.n_slots;
    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);
    if (c == 0) qtts_trace_mark(p, 1);
    tp_stage_rows<WT>(reinterpret_cast<const WT*>(ring.slots + (size_t)slot * ring.slot_bytes),
                      ring.scales + (size_t)slot * ring.slot_rows, scaled, sh, out,
                      r0 + c * stage_rows, min(stage_rows, nrows - c * stage_rows), K, KC, warp,
                      lane);
    __syncthreads();  // every warp is done with the slot
    if (c + 1 == chunks) qtts_trace_mark(p, 2);
    if (threadIdx.x == 0) qtts_ring_issue(ring, q);
    ++stage;
  }
}

struct TpAttnSmem {
  float q[QTTS_ATTN_MAX_G][QTTS_ATTN_D];
  float k[QTTS_ATTN_D];
  float sc[QTTS_ATTN_MAX_G][QTTS_TP_MAX_T];
  float part[QTTS_ATTN_D];
};

// RMSNorm of one head (value v on thread t < D) times w: the squares added by
// tp_tree, each step rounded.
template <typename Sync>
__device__ __forceinline__ float tp_head_norm(float v, float w, float eps, float* part,
                                              Sync sync, int t) {
  part[t] = __fmul_rn(v, v);
  sync();
  const float r = tp_inv_rms(tp_tree(part, QTTS_ATTN_D, sync, t), QTTS_ATTN_D, eps);
  return __fmul_rn(__fmul_rn(v, r), w);
}

// kv head h of the rank at position pos, on threads t < 128 (sync: their
// barrier): its q heads and k normed and rotated (rope: the position's cos
// and sin), k and v stored at slot pos of the float32 scratch, scores over
// slots 0..pos (lane l adds q k over d = 4 l .. 4 l + 3 in order, the warp's
// xor tree adds the lanes, times 1/sqrt(D)), the softmax exp(s - max) / sum
// with the sum in slot order, and attn = sum_s w_s v_s in slot order (the
// JAX kernel's full-row form on the slots it does not mask).
template <typename Sync>
__device__ void tp_attn_item(TpAttnSmem& sm, Sync sync, int t, int h, const QttsStepWeights& w,
                             int l, const float* qkv, const float* rope, float* kc, float* vc,
                             int T, int pos, float* attn) {
  constexpr int D = QTTS_ATTN_D;
  const int g = w.nq / w.nk, qd = w.nq * D, kvd = w.nk * D;
  const float* qn = w.q_norm + (size_t)l * D;
  const float* kn = w.k_norm + (size_t)l * D;
  for (int gi = 0; gi < g; ++gi) {
    sm.q[gi][t] = tp_head_norm(__ldcg(qkv + (h * g + gi) * D + t), qn[t], w.eps, sm.part, sync, t);
  }
  sm.k[t] = tp_head_norm(__ldcg(qkv + qd + h * D + t), kn[t], w.eps, sm.part, sync, t);
  const float v = __ldcg(qkv + qd + kvd + h * D + t);
  sync();
  if (t < D / 2) {
    const float c = rope[(size_t)pos * D + t], s = rope[(size_t)pos * D + D / 2 + t];
    for (int gi = 0; gi <= g; ++gi) {
      float* x = gi < g ? sm.q[gi] : sm.k;
      const float a = x[t], b = x[t + D / 2];
      x[t] = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
      x[t + D / 2] = __fadd_rn(__fmul_rn(b, c), __fmul_rn(a, s));
    }
  }
  sync();
  float* kl = kc + ((size_t)l * w.nk + h) * T * D;
  float* vl = vc + ((size_t)l * w.nk + h) * T * D;
  kl[(size_t)pos * D + t] = sm.k[t];
  vl[(size_t)pos * D + t] = v;
  sync();
  const int warp = t >> 5, lane = t & 31;
  for (int p = warp; p < g * (pos + 1); p += D / 32) {
    const int gi = p / (pos + 1), s = p % (pos + 1);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d = __fadd_rn(d, __fmul_rn(sm.q[gi][lane * 4 + e], __ldcg(kl + (size_t)s * D + lane * 4 + e)));
    }
    d = qtts_warp_reduce(d, QttsSumF());
    if (lane == 0) sm.sc[gi][s] = __fmul_rn(d, w.attn_scale);
  }
  sync();
  if (t < g) {
    float m = sm.sc[t][0];
    for (int s = 1; s <= pos; ++s) m = fmaxf(m, sm.sc[t][s]);
    float sum = 0.f;
    for (int s = 0; s <= pos; ++s) {
      const float e = expf(__fsub_rn(sm.sc[t][s], m));
      sm.sc[t][s] = e;
      sum = __fadd_rn(sum, e);
    }
    for (int s = 0; s <= pos; ++s) sm.sc[t][s] = __fdiv_rn(sm.sc[t][s], sum);
  }
  sync();
  for (int gi = 0; gi < g; ++gi) {
    float o = 0.f;
    for (int s = 0; s <= pos; ++s) {
      o = __fadd_rn(o, __fmul_rn(sm.sc[gi][s], __ldcg(vl + (size_t)s * D + t)));
    }
    attn[(h * g + gi) * D + t] = o;
  }
}

// The union region's areas: the GEMV input (QTTS_P_MAX_K floats) and the
// prologue's tree (256 floats) after it; an attention item, or block 0's
// sampler scratch, in the phases that have no GEMV input.
constexpr size_t TP_UNION_BYTES = 4 * ((size_t)QTTS_P_MAX_K + QTTS_P_THREADS);
static_assert(sizeof(TpAttnSmem) <= TP_UNION_BYTES && sizeof(QttsSampleSmem) <= TP_UNION_BYTES,
              "the union region holds an attention item and the sampler");

template <typename HT, bool SYS>
__global__ void __launch_bounds__(QTTS_P_THREADS, 1)
tp_chain_kernel(const __grid_constant__ QttsTpChainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ QttsSeq seq;
  float* sh = reinterpret_cast<float*>(smem);  // the GEMV input
  float* tree = sh + QTTS_P_MAX_K;
  TpAttnSmem& am = *reinterpret_cast<TpAttnSmem*>(smem);
  QttsSampleSmem& ss = *reinterpret_cast<QttsSampleSmem*>(smem);
  const int t = threadIdx.x;
  const int b = (int)blockIdx.x % a.bpr, me = a.rank0 + (int)blockIdx.x / a.bpr;
  const QttsTpRank& R = a.rank[me];
  const QttsStepWeights& w = R.w;
  const QttsPlan& p = R.p;
  const int H = w.H, D = w.D, nk = w.nk, I = w.I, qd = w.nq * D, T = a.n + 2, Hs = H / a.tp;
  QttsRing ring;
  const QttsSetSpec spec{&w, static_cast<const int8_t*>(R.heads), R.head_scales, a.n, a.V, 1,
                         Hs, (int)sizeof(HT)};
  qtts_ring_start(ring, seq, smem, p, &spec, b);
  const QttsTpSync sync{a.tp, me, b, a.bpr, a.W, a.gen, a.stall_ns, a.timeout_ns};
  uint32_t* bar = a.link[me].bar;
  const QttsNamedSync item_sync{1};
  int stage = 0, site = 0;
  for (int it = 0; it < a.n + 2; ++it) {
    if (it >= 2) {
      // sub-code j: this rank's head rows of RMSNorm(x) * final_norm, the
      // partial [V] all-reduced, then scaled
      const int j = it - 2;
      tp_prologue<QTTS_IN_NORM>(R.x, R.final_norm, w.eps, H, me * Hs, Hs, sh, tree);
      tp_ring_gemv<HT>(p, ring, seq, QTTS_KIND_HEAD, stage, sh, R.part, Hs, false);
      const QttsKindRows& hr = seq.kind[QTTS_KIND_HEAD];
      const float* scale = R.head_scales + (size_t)j * a.V;
      float* logits = R.logits;
      qtts_tp_allreduce<SYS>(a.link, sync, site++, hr.r0, hr.rows, R.part,
                             [logits, scale](int c, float v) {
                               logits[c] = __fmul_rn(v, scale[c]);
                             });
      qtts_group_barrier(p, bar, b, a.bpr);
      if (b == 0) {
        // the draw on the replicated noise, then the table row
        const float* lg = R.logits;
        const int sub = qtts_sample_regs<QTTS_SAMPLE_VPT>(
            [lg](int v) { return __ldcg(lg + v); }, a.V, R.gumbel + (size_t)j * a.V,
            a.temperature, a.top_k, a.top_p, a.greedy, ss);
        if (t == 0) R.codes[j] = sub;
        const __nv_bfloat16* row = R.tables + ((size_t)j * a.Vt + sub) * H;
        for (int k = t; k < H; k += blockDim.x) {
          const float e = __bfloat162float(row[k]);
          R.sub_sum[k] = j == 0 ? e : R.sub_sum[k] + e;
          R.x_in[k] = e;
        }
      }
      if (it > a.n) break;
      qtts_group_barrier(p, bar, b, a.bpr);
    }
    // the trunk pass at position it
    const float* in = it == 0 ? R.last_hidden : it == 1 ? R.code0_embed : R.x_in;
    for (int l = 0; l < w.L; ++l) {
      const float* xr = l == 0 ? in : R.x;
      float* x = R.x;
      tp_prologue<QTTS_IN_NORM>(xr, w.attn_norm + (size_t)l * H, w.eps, H, 0, H, sh, tree);
      tp_ring_gemv<int8_t>(p, ring, seq, QTTS_KIND_QKV, stage, sh, R.qkv, H, true);
      qtts_group_barrier(p, bar, b, a.bpr);
      if (t < QTTS_ATTN_D) {
        for (int h = b; h < nk; h += a.bpr) {
          tp_attn_item(am, item_sync, t, h, w, l, R.qkv, R.rope, R.k_cache, R.v_cache, T, it,
                       R.attn);
        }
      }
      qtts_group_barrier(p, bar, b, a.bpr);
      tp_prologue<QTTS_IN_PLAIN>(R.attn, nullptr, w.eps, qd, 0, qd, sh, tree);
      tp_ring_gemv<int8_t>(p, ring, seq, QTTS_KIND_O, stage, sh, R.part, a.KCo, true);
      const QttsKindRows& orow = seq.kind[QTTS_KIND_O];
      qtts_tp_allreduce<SYS>(a.link, sync, site++, orow.r0, orow.rows, R.part,
                             [x, xr](int c, float v) { x[c] = __fadd_rn(__ldcg(xr + c), v); });
      qtts_group_barrier(p, bar, b, a.bpr);
      tp_prologue<QTTS_IN_NORM>(R.x, w.mlp_norm + (size_t)l * H, w.eps, H, 0, H, sh, tree);
      tp_ring_gemv<int8_t>(p, ring, seq, QTTS_KIND_GU, stage, sh, R.gu, H, true);
      qtts_group_barrier(p, bar, b, a.bpr);
      tp_prologue<QTTS_IN_SILU>(R.gu, nullptr, w.eps, I, 0, I, sh, tree);
      tp_ring_gemv<int8_t>(p, ring, seq, QTTS_KIND_DOWN, stage, sh, R.part, a.KCd, true);
      const QttsKindRows& drow = seq.kind[QTTS_KIND_DOWN];
      qtts_tp_allreduce<SYS>(a.link, sync, site++, drow.r0, drow.rows, R.part,
                             [x](int c, float v) { x[c] = __fadd_rn(x[c], v); });
      qtts_group_barrier(p, bar, b, a.bpr);
    }
  }
  qtts_trace_end(p);
}

template <typename HT>
int launch_chain(const QttsTpChainArgs& a, cudaStream_t st) {
  const int grid = a.n_local * a.bpr, smem = a.rank[a.rank0].p.smem_bytes;
  return a.cross_device ? qtts_launch_persistent(tp_chain_kernel<HT, true>, a, grid, smem, st)
                        : qtts_launch_persistent(tp_chain_kernel<HT, false>, a, grid, smem, st);
}

bool chain_args_ok(const QttsTpChainArgs& a) {
  if (a.tp < 1 || a.tp > QTTS_TP_MAX || a.rank0 < 0 || a.n_local < 1 ||
      a.rank0 + a.n_local > a.tp ||
      a.bpr < 1 || a.n < 1 || a.n + 2 > QTTS_TP_MAX_T || a.V > QTTS_P_THREADS * QTTS_SAMPLE_VPT ||
      a.V > a.Vt || a.V % 4 || (a.heads_bf16 != 0 && a.heads_bf16 != 1) || (a.tp & (a.tp - 1)) ||
      a.KCo < 16 || a.KCo % 16 || a.KCd < 16 || a.KCd % 16) {
    return false;
  }
  const QttsTpRank& r0 = a.rank[a.rank0];
  const size_t hsize = a.heads_bf16 ? 2 : 1;
  for (int r = a.rank0; r < a.rank0 + a.n_local; ++r) {
    const QttsTpRank& R = a.rank[r];
    const QttsStepWeights& w = R.w;
    const int H = w.H, Hs = H / a.tp, g = w.nk > 0 ? w.nq / w.nk : 0;
    const int hrows = R.p.stage_rows[QTTS_KIND_HEAD];
    if (w.unit_type != QTTS_UNIT_INT8 || w.D != QTTS_ATTN_D || w.nk < 1 || w.nq % w.nk != 0 ||
        g > QTTS_ATTN_MAX_G || H % a.tp || Hs % 16 || H % 16 || (w.nq * w.D) % a.KCo ||
        w.I % a.KCd || a.W < H ||
        a.W < a.V || w.H != r0.w.H || w.nq != r0.w.nq ||
        w.nk != r0.w.nk || w.I != r0.w.I || w.L != r0.w.L || !qtts_plan_ok(R.p, w, 0) ||
        R.p.grid != a.bpr || R.p.smem_bytes != r0.p.smem_bytes ||
        (size_t)R.p.union_bytes < TP_UNION_BYTES || hrows < 4 || hrows % 4 ||
        hrows > R.p.slot_rows || (size_t)hrows * Hs * hsize > (size_t)R.p.slot_bytes) {
      return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Kernel K10 entry: the ranks rank0 .. rank0 + n_local - 1 of a (all on the
// current device) run the whole chain in one cooperative launch of
// n_local x bpr blocks on stream.  Each rank writes its sub-codes and
// sub_sum; an exchange that timed out leaves the rank's status nonzero.
int qtts_tp_mtp_chain(const QttsTpChainArgs* a, void* stream) {
  if (!chain_args_ok(*a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a->heads_bf16 ? launch_chain<__nv_bfloat16>(*a, st) : launch_chain<int8_t>(*a, st);
}

// Enables peer access from each device of devs[0 .. n) to every other
// (distinct devices only); cudaErrorPeerAccessUnsupported when a pair
// cannot reach each other.
int qtts_tp_enable_peers(const int* devs, int n) {
  int cur = 0;
  QTTS_TRY(cudaGetDevice(&cur));
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      if (devs[i] == devs[j]) continue;
      int ok = 0;
      QTTS_TRY(cudaDeviceCanAccessPeer(&ok, devs[i], devs[j]));
      if (!ok) return (int)cudaErrorPeerAccessUnsupported;
      QTTS_TRY(cudaSetDevice(devs[i]));
      const cudaError_t e = cudaDeviceEnablePeerAccess(devs[j], 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
      } else if (e != cudaSuccess) {
        cudaSetDevice(cur);
        return (int)e;
      }
    }
  }
  QTTS_TRY(cudaSetDevice(cur));
  return (int)cudaSuccess;
}

// sizeof(QttsTpChainArgs): ops/_build.py checks its ctypes mirror against it.
int qtts_tp_chain_args_size() { return (int)sizeof(QttsTpChainArgs); }

}  // extern "C"
