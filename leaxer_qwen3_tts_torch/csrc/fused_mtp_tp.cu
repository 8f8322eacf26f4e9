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
// it <= n, a trunk pass at position it: per layer the rank's qkv units, its
// kv heads' attention over a float32 [L, nk, n + 2, D] scratch, the wo
// partial all-reduced into the residual, RMSNorm, gate|up, silu, the down
// partial all-reduced into the residual.
//
// The exchange (tp_exchange): a hypercube all-reduce of log2(tp) rounds;
// in round r rank me writes its value into rank me ^ (1 << r)'s receive slot
// and raises the slot's flag to this call's generation (st.release after a
// fence; .gpu scope on one device, .sys with __threadfence_system across
// devices), waits for its own slot's flag to reach the generation
// (ld.acquire), and adds what it received after its own value; a + b == b + a
// bitwise, so every rank holds the same bits.  Each exchange site (2 per
// layer and pass, 1 per head) has its own slots and flags, per 64-column
// tile, so a slot is written once per call; the generation (a per-call
// counter, never a reset) keeps the previous call's flags from satisfying
// this call's waits.  A wait that sees no flag within the timeout sets the
// rank's status word and every later wait of the launch is skipped, so a
// fault ends the launch with a status instead of hanging the card; the
// wrapper zeroes the status words before each launch and raises when one
// was set (ops/fused_mtp_tp.py::check_timeouts, read behind the launch).
//
// Rounding: every product and sum is rounded on its own (explicit _rn
// intrinsics, no fused multiply-add), and each reduction runs in a fixed
// order the plain version (ops/fused_mtp_tp.py) takes step for step: the
// RMSNorms' per-thread sums and halving trees, the unit products' 16 row
// slices, the attention's 4-wide lane dots and warp tree, the softmax's and
// the weighted values' slot order.  RoPE reads a cos / sin table of the
// chain's n + 2 positions that the wrapper computes once per entry, as the
// plain version does.  So the two agree bit for bit on the card.
//
// Co-residency: ranks on one device are block groups of one cooperative
// launch (grid = ranks x blocks per rank; the launch is refused if the grid
// cannot be co-resident), or a rank would spin on a peer that never runs.
// Ranks on distinct devices are one launch per device with peer pointers.
//
// What bounds it on the H100: the ranks' trunk shards and head rows, read
// once per pass and per head (the 1.7B trunk at tp=4: 302 MB x 16 passes of
// int8 over all ranks, 1.44 ms at 3.35 TB/s when the ranks share the card);
// at one token it is latency-bound: four grid barriers and two exchanges per
// layer and pass, one block's draw per sub-code.  Not done yet: the TMA
// weight ring of K2 (ROADMAP K-speed).

#include "qtts_stream.cuh"
#include "qtts_tp.cuh"

namespace cg = cooperative_groups;

// One rank's shard, inputs and buffers (every pointer on the rank's device;
// the peers' recv and flags are read through the whole array).
struct QttsTpRank {
  QttsTpWeights w;
  const void* heads;              // [n, Hs, V] int8 or bf16: rows [r Hs, (r+1) Hs) of the heads
  const float* head_scales;       // [n, V]
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
  float* logits;                  // [V]
  float* k_cache;                 // [L, nk, n + 2, D] float32
  float* v_cache;
  float* recv;                    // [sites, rounds, W] receive slots
  uint32_t* flags;                // [sites, rounds, W / 64]
  int32_t* codes;                 // [n] the rank's sub-codes
  float* sub_sum;                 // [H]
  int32_t* status;                // [1] nonzero: an exchange timed out
};

struct QttsTpChainArgs {
  QttsTpRank rank[QTTS_TP_MAX];
  int32_t tp, rank0, n_local, bpr;  // the launch runs ranks rank0 .. rank0 + n_local - 1
  int32_t n, V, Vt, sites, W;
  uint32_t gen;                     // this call's flag value
  float temperature;                // max(temperature, 1e-6) (sampled)
  int32_t top_k;
  float top_p;
  int32_t greedy, heads_bf16, cross_device, stall_ns;
  int64_t timeout_ns;
};

namespace {

template <bool SYS>
__device__ __forceinline__ void flag_release(uint32_t* p, uint32_t v) {
  if (SYS) {
    asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  } else {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  }
}

template <bool SYS>
__device__ __forceinline__ uint32_t flag_acquire(const uint32_t* p) {
  uint32_t v;
  if (SYS) {
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  }
  return v;
}

// Spins until *flag == gen, or sets *status after timeout_ns (and returns at
// once when a wait of this launch already timed out).
template <bool SYS>
__device__ void tp_wait(const uint32_t* flag, uint32_t gen, int32_t* status, int64_t timeout_ns) {
  if (*reinterpret_cast<volatile int32_t*>(status) != 0) return;
  const uint64_t t0 = qtts_globaltimer();
  while (flag_acquire<SYS>(flag) != gen) {
    if (qtts_globaltimer() - t0 > (uint64_t)timeout_ns) {
      atomicExch(status, 1);
      return;
    }
  }
}

// The hypercube all-reduce of tile `tile` (64 columns; the value of column
// tile * 64 + t on threads t < 64) at exchange site `site`.  With stall_ns,
// odd ranks hold each send back that long (the check's stalled pass).
template <bool SYS>
__device__ float tp_exchange(const QttsTpChainArgs& a, int me, int site, int tile, float v) {
  const int t = threadIdx.x;
  const int ntiles = a.W / QTTS_TP_COLS;
  const QttsTpRank& mine = a.rank[me];
  const int rounds = 31 - __clz(a.tp);
  for (int r = 0; r < rounds; ++r) {
    const int partner = me ^ (1 << r);
    const size_t slot = (size_t)site * rounds + r;
    if (a.stall_ns > 0 && (me & 1)) {
      if (t == 0) {
        const uint64_t t0 = qtts_globaltimer();
        while (qtts_globaltimer() - t0 < (uint64_t)a.stall_ns) {
        }
      }
      __syncthreads();
    }
    if (t < QTTS_TP_COLS) a.rank[partner].recv[slot * a.W + tile * QTTS_TP_COLS + t] = v;
    __syncthreads();
    if (t == 0) {
      if (SYS) {
        __threadfence_system();
      } else {
        __threadfence();
      }
      flag_release<SYS>(a.rank[partner].flags + slot * ntiles + tile, a.gen);
      tp_wait<SYS>(mine.flags + slot * ntiles + tile, a.gen, mine.status, a.timeout_ns);
    }
    __syncthreads();
    if (t < QTTS_TP_COLS) {
      const float* src = mine.recv + slot * a.W + tile * QTTS_TP_COLS + t;
      v = v + (SYS ? __ldcv(src) : __ldcg(src));
    }
  }
  return v;
}

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

// qtts_tp_prologue's GEMV input (sh[k] = bf16(transform(in))[k0 + k] for
// k < n; IN_NORM, IN_PLAIN, IN_SILU) with every product and sum rounded on
// its own in the plain version's order: thread t of 256 sums the squares of
// k = t, t + 256, ... in order, tp_tree adds the 256 sums.  K9 keeps the
// shared prologue: in its GEMV this one took the K9 step from 12.4-14.4 to
// 19.6 ms at the 1.7B widths (tp=4) on an H100 (`chip_ab.py --mesh`; the
// norm variant compiled to 40 registers instead of 48).  The activations
// come from other blocks of the launch, so they are read past L1.
template <int IN_MODE>
__device__ __forceinline__ void tp_prologue(const float* in, const float* __restrict__ norm_w,
                                            float eps, int K, int k0, int n, float* sh) {
  float r = 0.f;
  if (IN_MODE == QTTS_IN_NORM) {
    __shared__ float part[QTTS_TP_THREADS];
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += QTTS_TP_THREADS) {
      const float v = __ldcg(in + k);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    part[threadIdx.x] = ss;
    __syncthreads();
    r = tp_inv_rms(tp_tree(part, QTTS_TP_THREADS, QttsBlockSync{}, threadIdx.x), K, eps);
  }
  for (int k = threadIdx.x; k < n; k += QTTS_TP_THREADS) {
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
__device__ void tp_attn_item(TpAttnSmem& sm, Sync sync, int t, int h, const QttsTpWeights& w,
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

template <typename HT, bool SYS>
__global__ void __launch_bounds__(QTTS_TP_THREADS, 1)
tp_chain_kernel(const __grid_constant__ QttsTpChainArgs a) {
  extern __shared__ float sh[];  // the GEMV input: max(H, nq D, I, Hs) floats
  __shared__ float red[QTTS_TP_SLICES][QTTS_TP_COLS];
  __shared__ TpAttnSmem am;
  __shared__ QttsSampleSmem ss;
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int b = blockIdx.x % a.bpr;
  const int me = a.rank0 + blockIdx.x / a.bpr;
  const QttsTpRank& R = a.rank[me];
  const QttsTpWeights& w = R.w;
  const int H = w.H, D = w.D, nk = w.nk, I = w.I, NU = w.NU;
  const int qd = w.nq * D, A = (w.nq + 2 * nk) * D, T = a.n + 2, Hs = H / a.tp;
  const int Uq = A / NU, Uo = (qd / w.KCo) * (H / NU), Ug = 2 * I / NU, Ud = (I / w.KCd) * (H / NU);
  const QttsNamedSync item_sync{1};
  int site = 0;
  for (int it = 0; it < a.n + 2; ++it) {
    if (it >= 2) {
      // sub-code j: this rank's head rows of RMSNorm(x) * final_norm, the
      // partial [V] all-reduced, then scaled
      const int j = it - 2;
      tp_prologue<QTTS_IN_NORM>(R.x, R.final_norm, w.eps, H, me * Hs, Hs, sh);
      const HT* hw = static_cast<const HT*>(R.heads) + (size_t)j * Hs * a.V;
      for (int tile = b; tile < a.V / QTTS_TP_COLS; tile += a.bpr) {
        float v = qtts_tp_tile<HT>(sh, hw, nullptr, a.V, a.V, Hs, 1, tile, red);
        v = tp_exchange<SYS>(a, me, site, tile, v);
        if (t < QTTS_TP_COLS) {
          const int c = tile * QTTS_TP_COLS + t;
          R.logits[c] = __fmul_rn(v, R.head_scales[(size_t)j * a.V + c]);
        }
      }
      ++site;
      grid.sync();
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
      grid.sync();
    }
    // the trunk pass at position it
    const float* in = it == 0 ? R.last_hidden : it == 1 ? R.code0_embed : R.x_in;
    for (int l = 0; l < w.L; ++l) {
      const float* xr = l == 0 ? in : R.x;
      tp_prologue<QTTS_IN_NORM>(xr, w.attn_norm + (size_t)l * H, w.eps, H, 0, H, sh);
      for (int tile = b; tile < A / QTTS_TP_COLS; tile += a.bpr) {
        const float v = qtts_tp_tile<int8_t>(sh, w.qkv_u + (size_t)l * Uq * H * NU,
                                             w.qkv_s + (size_t)l * Uq * NU, A, NU, H, 1, tile,
                                             red);
        if (t < QTTS_TP_COLS) R.qkv[tile * QTTS_TP_COLS + t] = v;
      }
      grid.sync();
      if (t < QTTS_ATTN_D) {
        for (int h = b; h < nk; h += a.bpr) {
          tp_attn_item(am, item_sync, t, h, w, l, R.qkv, R.rope, R.k_cache, R.v_cache, T, it,
                       R.attn);
        }
      }
      grid.sync();
      tp_prologue<QTTS_IN_PLAIN>(R.attn, nullptr, w.eps, qd, 0, qd, sh);
      for (int tile = b; tile < H / QTTS_TP_COLS; tile += a.bpr) {
        float v = qtts_tp_tile<int8_t>(sh, w.wo_u + (size_t)l * Uo * w.KCo * NU,
                                       w.wo_s + (size_t)l * Uo * NU, H, NU, w.KCo, qd / w.KCo,
                                       tile, red);
        v = tp_exchange<SYS>(a, me, site, tile, v);
        if (t < QTTS_TP_COLS) {
          const int c = tile * QTTS_TP_COLS + t;
          R.x[c] = __ldcg(xr + c) + v;
        }
      }
      ++site;
      grid.sync();
      tp_prologue<QTTS_IN_NORM>(R.x, w.mlp_norm + (size_t)l * H, w.eps, H, 0, H, sh);
      for (int tile = b; tile < 2 * I / QTTS_TP_COLS; tile += a.bpr) {
        const float v = qtts_tp_tile<int8_t>(sh, w.gu_u + (size_t)l * Ug * H * NU,
                                             w.gu_s + (size_t)l * Ug * NU, 2 * I, NU, H, 1, tile,
                                             red);
        if (t < QTTS_TP_COLS) R.gu[tile * QTTS_TP_COLS + t] = v;
      }
      grid.sync();
      tp_prologue<QTTS_IN_SILU>(R.gu, nullptr, w.eps, I, 0, I, sh);
      for (int tile = b; tile < H / QTTS_TP_COLS; tile += a.bpr) {
        float v = qtts_tp_tile<int8_t>(sh, w.wd_u + (size_t)l * Ud * w.KCd * NU,
                                       w.wd_s + (size_t)l * Ud * NU, H, NU, w.KCd, I / w.KCd,
                                       tile, red);
        v = tp_exchange<SYS>(a, me, site, tile, v);
        if (t < QTTS_TP_COLS) {
          const int c = tile * QTTS_TP_COLS + t;
          R.x[c] = __ldcg(R.x + c) + v;
        }
      }
      ++site;
      grid.sync();
    }
  }
}

template <typename HT, bool SYS>
int launch_chain(const QttsTpChainArgs& a, size_t smem, cudaStream_t st) {
  auto kernel = tp_chain_kernel<HT, SYS>;
  int dev = 0, sms = 0, per_sm = 0;
  QTTS_TRY(cudaGetDevice(&dev));
  QTTS_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  QTTS_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, QTTS_TP_THREADS, smem));
  const int grid = a.n_local * a.bpr;
  if (grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<QttsTpChainArgs*>(&a)};
  QTTS_TRY(cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(QTTS_TP_THREADS), args,
                                       smem, st));
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Kernel K10 entry: the ranks rank0 .. rank0 + n_local - 1 of a (all on the
// current device) run the whole chain in one cooperative launch of
// n_local x bpr blocks on stream.  Each rank writes its sub-codes and
// sub_sum; an exchange that timed out leaves the rank's status nonzero.
int qtts_tp_mtp_chain(const QttsTpChainArgs* a, void* stream) {
  const int tp = a->tp;
  if (tp < 2 || tp > QTTS_TP_MAX || (tp & (tp - 1)) || a->rank0 < 0 || a->n_local < 1 ||
      a->rank0 + a->n_local > tp || a->bpr < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const QttsTpWeights& w = a->rank[a->rank0].w;
  const int H = w.H, A = (w.nq + 2 * w.nk) * w.D;
  if (!qtts_tp_shapes_ok(w) || H % tp != 0 ||
      (H / tp) % 4 != 0 || a->n < 1 || a->n + 2 > QTTS_TP_MAX_T || a->V % QTTS_TP_COLS != 0 ||
      a->V > QTTS_P_THREADS * QTTS_SAMPLE_VPT || a->V > a->Vt || H % QTTS_TP_COLS != 0 ||
      A % QTTS_TP_COLS != 0 || a->W < H || a->W < a->V || a->W % QTTS_TP_COLS != 0 ||
      a->sites != (a->n + 1) * 2 * w.L + a->n) {
    return (int)cudaErrorInvalidValue;
  }
  const int qd = w.nq * w.D;
  int kmax = H > qd ? H : qd;
  kmax = kmax > w.I ? kmax : w.I;
  const size_t smem = (size_t)kmax * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->cross_device) {
    return a->heads_bf16 ? launch_chain<__nv_bfloat16, true>(*a, smem, st)
                         : launch_chain<int8_t, true>(*a, smem, st);
  }
  return a->heads_bf16 ? launch_chain<__nv_bfloat16, false>(*a, smem, st)
                       : launch_chain<int8_t, false>(*a, smem, st);
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
