// Kernel K9: the tensor-parallel decode step, one persistent cooperative
// launch per device and step for every rank placed there.
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_tp.py::fused_decode_step_tp, whose
// shard_map runs two Pallas kernels per layer on each chip's Megatron shard
// (_make_attn_half, _make_mlp_half) with a psum after each.  Same function:
// per layer, every rank's attention half (RMSNorm of x; its qkv columns, its
// q and kv heads' QK-norm and RoPE at pos, the new slot written into its
// shard of the cache, GQA attention over slots 0..pos; its rows of wo) and
// MLP half (RMSNorm; its gate|up columns, silu(gate) * up; its rows of
// down), each half's [H] partials all-reduced into the residual.
//
// Design.  Each rank's block group runs K1's persistent step phases
// (qtts_stream.cuh::qtts_step_phases) on the rank's shard: K1's row pack at
// the shard's widths, streamed through the TMA weight ring on each block's
// mbarriers, on a plan over the group's blocks, with K1's attention items on
// the rank's kv heads of its cache shard.  Two things differ from K1
// (TpStepGroup): a phase ends at a barrier of the rank's own blocks, and the
// o and down products write the block's rows of the rank's partial, which
// the exchange of qtts_tp.cuh sums over the ranks in the hypercube's order
// (((p0 + p1) + (p2 + p3)) at tp = 4, the same bits on every rank; the plain
// step's ops/fused_tp.py::allreduce sums in that order too, where it summed
// in rank order when the host added the halves' partials) before the
// residual add x = x + total.  So at tp = 1 the step is K1's bit for bit,
// and with every peer's weights zero rank 0's result is K1's on rank 0's
// shard (x + ((p0 + 0) + (0 + 0))).  The JAX pack's K-split scales are per
// column over the whole shard K, so the row pack holds the same int8 values
// and scales; a row's dot product then runs over the whole K before its
// scale (the JAX kernel scales each KC chunk), which moves values by float32
// rounding only.
//
// What bounds it on the H100: every rank's shard bytes (the 0.6B talker:
// 440 MB of int8 over all ranks, 0.13 ms at 3.35 TB/s; the ranks share one
// card's HBM when the mesh lists it tp times); at one token it is
// latency-bound, as K1 is: five group barriers and two exchanges per layer,
// on SM-count / (ranks on the device) blocks per rank.

#include "qtts_tp.cuh"

// One rank's step (every pointer on the rank's device).
struct QttsTpStepRank {
  QttsStepWeights w;  // the rank's shard: K1's row pack at the shard's widths (int8 units)
  QttsStepScratch s;
  QttsPlan p;         // the rank's plan on bpr blocks
  const float* x_in;  // [H] the step's input
  float* x;           // [H] the rank's residual: the step's output
  float* part;        // [H] the rank's partial of the current o or down product
  void* k_cache;      // [L, nk / tp, T, D] bf16 or float32: the rank's kv heads
  void* v_cache;
};

struct QttsTpStepArgs {
  QttsTpStepRank rank[QTTS_TP_MAX];
  QttsTpLink link[QTTS_TP_MAX];
  int32_t tp, rank0, n_local, bpr;  // the launch runs ranks rank0 .. rank0 + n_local - 1
  int32_t T, pos, cache_bf16, cross_device, stall_ns;
  uint32_t gen;                     // this call's flag value
  int64_t timeout_ns;
};
static_assert(sizeof(QttsTpStepArgs) <= 4096, "a kernel parameter of at most 4 KB");

namespace {

// The phases' block group: block b of rank me's bpr blocks, its barriers the
// rank's own, its o and down products all-reduced over the ranks.
template <bool SYS>
struct TpStepGroup {
  const QttsTpStepArgs& a;
  int me, b;
  QttsTpSync sync;
  __device__ __forceinline__ int block() const { return b; }
  __device__ __forceinline__ int blocks() const { return a.bpr; }
  __device__ __forceinline__ void barrier(const QttsPlan& p) const {
    qtts_group_barrier(p, a.link[me].bar, b, a.bpr);
  }
  template <typename WT>
  __device__ __forceinline__ void residual(const QttsPlan& p, const QttsRing& ring, QttsSeq& q,
                                           int kind, int& stage, const float* sh, float* x,
                                           int site) const {
    float* part = a.rank[me].part;
    qtts_ring_gemv<false, WT>(p, ring, q, kind, stage, sh, part);
    const QttsKindRows& r = q.kind[kind];
    qtts_tp_allreduce<SYS>(a.link, sync, site, r.r0, r.rows, part,
                           [x](int n, float total) { x[n] = __fadd_rn(x[n], total); });
  }
};

template <typename CT, bool SYS>
__global__ void __launch_bounds__(QTTS_P_THREADS, 1)
tp_step_kernel(const __grid_constant__ QttsTpStepArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ QttsSeq seq;
  const int b = (int)blockIdx.x % a.bpr, me = a.rank0 + (int)blockIdx.x / a.bpr;
  const QttsTpStepRank& R = a.rank[me];
  QttsRing ring;
  const QttsSetSpec spec{&R.w, nullptr, nullptr, 0, 0, 1, 0, 0};
  qtts_ring_start(ring, seq, smem, R.p, &spec, b);
  const TpStepGroup<SYS> g{a, me, b,
                           QttsTpSync{a.tp, me, b, a.bpr, R.w.H, a.gen, a.stall_ns, a.timeout_ns}};
  int stage = 0;
  qtts_step_phases<CT, int8_t, TpStepGroup<SYS>>(
      R.w, R.s, R.p, ring, seq, 0, stage, R.x_in, R.x, static_cast<CT*>(R.k_cache),
      static_cast<CT*>(R.v_cache), a.T, a.pos, smem, false, nullptr, nullptr, g);
  qtts_trace_end(R.p);
}

bool step_args_ok(const QttsTpStepArgs& a) {
  if (a.tp < 1 || a.tp > QTTS_TP_MAX || (a.tp & (a.tp - 1)) || a.rank0 < 0 || a.n_local < 1 ||
      a.rank0 + a.n_local > a.tp || a.bpr < 1 || a.pos < 0 || a.pos >= a.T ||
      (a.cache_bf16 != 0 && a.cache_bf16 != 1)) {
    return false;
  }
  const QttsTpStepRank& r0 = a.rank[a.rank0];
  for (int r = a.rank0; r < a.rank0 + a.n_local; ++r) {
    const QttsTpStepRank& R = a.rank[r];
    const QttsStepWeights& w = R.w;
    // every rank: an int8 shard of rank rank0's shape on a plan of bpr
    // blocks with rank rank0's shared memory
    if (w.unit_type != QTTS_UNIT_INT8 || w.D != QTTS_ATTN_D || w.nk < 1 || w.nq % w.nk != 0 ||
        w.H % 16 ||
        (w.nq * w.D) % 16 || w.I % 16 || w.H != r0.w.H || w.nq != r0.w.nq || w.nk != r0.w.nk ||
        w.I != r0.w.I || w.L != r0.w.L || a.pos / QTTS_ATTN_CHUNK + 1 > R.s.max_splits ||
        !qtts_plan_ok(R.p, w, 0) || R.p.grid != a.bpr || R.p.smem_bytes != r0.p.smem_bytes ||
        R.x_in == R.x) {
      return false;
    }
  }
  return true;
}

template <typename CT>
int launch_step(const QttsTpStepArgs& a, cudaStream_t st) {
  const int grid = a.n_local * a.bpr, smem = a.rank[a.rank0].p.smem_bytes;
  return a.cross_device ? qtts_launch_persistent(tp_step_kernel<CT, true>, a, grid, smem, st)
                        : qtts_launch_persistent(tp_step_kernel<CT, false>, a, grid, smem, st);
}

}  // namespace

extern "C" {

// Kernel K9 entry: the ranks rank0 .. rank0 + n_local - 1 of a (all on the
// current device) run one decode step in one cooperative launch of
// n_local x bpr blocks on stream; each rank's x gets the step's output and
// its cache shard the new slot.  A grid that cannot be co-resident fails
// with cudaErrorCooperativeLaunchTooLarge; an exchange that timed out leaves
// the rank's status nonzero.
int qtts_tp_decode_step(const QttsTpStepArgs* a, void* stream) {
  if (!step_args_ok(*a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a->cache_bf16 ? launch_step<__nv_bfloat16>(*a, st) : launch_step<float>(*a, st);
}

// sizeof(QttsTpStepArgs): ops/_build.py checks its ctypes mirror against it.
int qtts_tp_step_args_size() { return (int)sizeof(QttsTpStepArgs); }

}  // extern "C"
