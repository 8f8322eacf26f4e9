// The persistent transport of kernels K1, K2, K3 and K7: one cooperative
// launch per decode step (K1), per sub-code chain (K2; K3, the same chain on
// a float32 cache) or per whole frame (K7: the chain, then the talker step
// and its lm_head), whose weights stream through a shared-memory ring ahead
// of the data dependency.  Kernels K4 and K5 run the same transport for B
// rows (the batched section below), each row K1's or K2's arithmetic in K1's
// or K2's order, and K6 runs K4's phases on S candidates per stream.  Probe
// P1 (unit_probe.cu) streams its unit walk through a ring on the same
// mbarrier and bulk-copy helpers.
//
// What it keeps from the launch-per-op sequences (qtts_decode_step_multi,
// qtts_mtp_chain_multi, qtts_frame_step_multi, qtts_verify_step_multi):
// every value, bit for bit.
// Each output row is one
// warp's dot product in K1's lane order (lane l takes the 16-byte chunks at
// l*16 + i*512, fmaf in element order, then the xor butterfly, the separate
// scale product and residual sum); the GEMV input is qtts_gemv_prologue's,
// op for op, on a 256-thread block (qtts_prep_scale's partition and
// qtts_block_reduce's tree); attention runs qtts_attn_split_body's
// arithmetic and qtts_attn_combine_body's merge, op for op; the sampler
// keeps qtts_sample_index's op sequence and reduction trees.
//
// What it changes is how the bytes get there and how long each step waits:
//   * Work plan.  Each block owns a fixed contiguous range of output rows in
//     every GEMV (qkv, o, gate|up, down, and the chain's heads), balanced over
//     the grid in multiples of four rows.  The wrapper computes the ranges,
//     the ring's geometry and the shared-memory size (ops/persistent.py) and
//     passes them in a QttsPlan.  A plan covers one weight set (a
//     transformer and its heads) or two (K7: the MTP trunk with its heads,
//     then the talker with its lm_head), with a bounds table per set.
//   * Weight ring.  A block's rows of one GEMV are cut into stages of at most
//     slot_bytes, and the stages of the whole launch form one sequence (layer
//     by layer, phase by phase; in the chain, the trunk passes and the heads
//     in chain order; in the frame, the chain's and then the talker's).
//     Thread 0 keeps the next n_slots stages in flight:
//     each stage is a 1-D TMA bulk copy (cp.async.bulk) of the rows' weight
//     bytes (int8, bf16 or int4 units) plus one of their float32 scales (one
//     a row; K / 128 a row at int4), completed on the slot's mbarrier.  A
//     slot is refilled the moment its stage has been consumed,
//     so the copies of a phase are issued long before the grid barrier its
//     input waits on, across layer boundaries and, in the chain, while one
//     block samples (in the frame, the talker's first stages load while the
//     chain's last sub-code is drawn).  The rows' weights are then read from
//     shared memory.
//   * Latency.  At one token every phase is a chain of dependent round trips
//     to L2, so each input is loaded into registers at once before any of
//     its arithmetic: the GEMV prologue once per block per phase (the
//     launch-per-op GEMV recomputes it per 16-row group, one round trip per
//     loop iteration), the attention combine folded into the o-projection's
//     prologue (per-head factors once, then every block merges the partials
//     itself, deterministically), and the attention item with its next
//     cache slot loaded ahead.  A layer costs five grid barriers (qkv |
//     attention | o | gate-up | down), cooperative groups' grid sync.
//   * The sampler holds its row in registers and evaluates the midpoints of
//     two bisection rounds in one pass (the 3 candidates of the round tree,
//     each the float 0.5f * (lo + hi) the sequential loop would form), one
//     block barrier per pass with the partials double buffered, instead of
//     three barriers per round.  (Four rounds per pass, 15 candidates, and
//     one warp per candidate walking the whole row both measured slower:
//     on one block the candidates' work costs more than the barriers.)
//
// Tensor cores do not help: at one token the products have M = 1.

#pragma once

#include "qtts_kernels.cuh"

#include <mutex>

enum {
  QTTS_KIND_QKV = 0,
  QTTS_KIND_O = 1,
  QTTS_KIND_GU = 2,
  QTTS_KIND_DOWN = 3,
  QTTS_KIND_HEAD = 4,
  QTTS_KINDS = 5
};
// Weight sets a plan streams: one, or two in the frame (the MTP trunk and its
// heads, then the talker and its lm_head).  Set s's kind k is kind index
// s * QTTS_KINDS + k of the plan's tables and of the block's stage sequence.
constexpr int QTTS_SETS = 2;

constexpr int QTTS_P_THREADS = QTTS_GEMV_THREADS;  // 256: qtts_prep_scale's partition
constexpr int QTTS_P_WARPS = QTTS_P_THREADS / 32;
constexpr int QTTS_P_RPW = 8;  // rows a warp holds per stage
constexpr int QTTS_P_MAX_STAGE_ROWS = QTTS_P_WARPS * QTTS_P_RPW;  // 64
constexpr int QTTS_P_MAX_K = 24 * QTTS_P_THREADS;  // 6144: the widest GEMV input in registers
constexpr int QTTS_P_MAX_KV_HEADS = 64;  // the kv heads a plan takes
// the plan's attention tickets: one per (row, kv head) of a batched launch
constexpr int QTTS_P_MAX_TICKETS = QTTS_MAX_BATCH * QTTS_P_MAX_KV_HEADS;
constexpr int QTTS_SPEC_DEPTH = 2;  // bisection rounds per sampler pass: 3 candidates
constexpr int QTTS_BISECT_ROUNDS = 40;
constexpr int QTTS_SAMPLE_VPT = 8;  // logits per thread: V <= 2048

// The per-launch work plan (mirrored by ctypes in ops/_build.py, built by
// ops/persistent.py::make_plan).  Shared memory, in order: the union region
// (the GEMV input: MAX_K floats at one row, or the bf16 inputs of a block's
// batch rows; two attention items; or the sampler's scratch), n_slots
// mbarriers, n_slots scale areas of slot_rows floats, n_slots weight slots.
//
// A batched launch (K4, K5) may split its grid into `groups` groups of
// consecutive blocks, group g taking batch rows [g * batch / groups,
// (g + 1) * batch / groups) through every product: each group holds every
// weight row once, each block its group's rows' inputs in shared memory.
struct QttsPlan {
  // [n_sets * QTTS_KINDS, grid + groups]: group by group, the row starts of
  // the group's blocks and then its end; block b of group g owns rows
  // [k][b + g] .. [k][b + g + 1] of kind index k
  const int32_t* bounds;
  int32_t grid;           // blocks: all co-resident
  int32_t n_slots;        // ring slots
  int32_t slot_bytes;     // weight bytes per slot (a multiple of 16)
  int32_t slot_rows;      // scale floats per slot (a multiple of 4)
  // rows per stage of each kind index (multiples of 4, <= 64)
  int32_t stage_rows[QTTS_SETS * QTTS_KINDS];
  int32_t smem_bytes;     // dynamic shared memory
  int32_t union_bytes;    // bytes of the union region (a multiple of 128)
  uint32_t* tickets;      // [n_tickets] attention tickets per (row, kv head) (zeroed once)
  int32_t trace_rows;     // rows of trace (0: no trace)
  uint64_t* trace;        // [trace_rows, grid] %globaltimer ns: see qtts_phase_barrier
  int32_t batch;          // rows of the launch (1: K1, K2)
  int32_t groups;         // batch groups (1 unless batched)
  int32_t n_tickets;
  int32_t n_sets;         // weight sets (2: the frame)
  // K6's checks only (0 on every path): each slot-write item first waits
  // this many ns, so that a reader the phase's grid barrier does not hold
  // back reads its slot before the write
  int32_t write_stall_ns;
};

// The group of this block (groups of floor-divided block ranges).
static __host__ __device__ __forceinline__ int qtts_group_of(const QttsPlan& p, int block) {
  return ((block + 1) * p.groups - 1) / p.grid;
}

// The sampler's shared scratch (inside the union region): per-warp partials
// of the pass's candidates, double buffered.
struct QttsSampleSmem {
  // a pass's per-warp candidate counts (top-k), then the least and the
  // largest key of the values inside the interval
  __align__(16) int cnt[2][QTTS_P_WARPS][8];
  __align__(16) float part[2][QTTS_P_WARPS][4];  // a pass's per-warp candidate sums (top-p)
  float lim[2][QTTS_P_WARPS];                    // per-warp min and max of the scaled row
  float red[2][QTTS_P_WARPS];                    // per-warp softmax max, then sum
};

// Byte offsets of the plan's shared-memory areas.
struct QttsSmemLayout {
  size_t bars, scales, slots, total;
};
static __host__ __device__ __forceinline__ size_t qtts_align(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}
static __host__ __device__ __forceinline__ QttsSmemLayout qtts_plan_layout(const QttsPlan& p) {
  QttsSmemLayout o;
  o.bars = (size_t)p.union_bytes;
  o.scales = o.bars + qtts_align((size_t)8 * p.n_slots, 16);
  o.slots = qtts_align(o.scales + (size_t)4 * p.slot_rows * p.n_slots, 128);
  o.total = o.slots + (size_t)p.slot_bytes * p.n_slots;
  return o;
}

// ---------------------------------------------------------------------------
// mbarriers, bulk copies and the grid barrier
// ---------------------------------------------------------------------------

static __device__ __forceinline__ uint32_t qtts_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void qtts_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(qtts_smem_addr(bar)), "r"(count)
               : "memory");
}

static __device__ __forceinline__ void qtts_mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   qtts_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
static __device__ __forceinline__ void qtts_mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "QTTS_MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra QTTS_MBAR_WAIT;\n"
      "}\n" ::"r"(qtts_smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One 1-D TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completed on `bar`.
static __device__ __forceinline__ void qtts_bulk_load(void* dst, const void* src, uint32_t bytes,
                                                      uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(qtts_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(qtts_smem_addr(bar))
      : "memory");
}

static __device__ __forceinline__ uint64_t qtts_globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The index of the block's next grid barrier, for the trace.
static __device__ __forceinline__ int& qtts_barrier_index() {
  __shared__ int index;
  return index;
}

// The block's column of the trace: its block in the plan (blockIdx.x, or its
// place in its rank's block group in the tensor-parallel kernels).
static __device__ __forceinline__ int& qtts_trace_col() {
  __shared__ int col;
  return col;
}

// Thread 0 of block b, with a trace: row 1 holds the block's start; rows
// 5i + 2 .. 5i + 6 the end of the phase's input, the moment its first weight
// stage was in shared memory and the end of its last stage's dot products
// before that slot's refill (GEMV phases; in a sampler phase, the sampling
// block's ends of the top-k threshold, the softmax and the top-p threshold;
// 0 elsewhere), the arrival at grid barrier i and the departure from it;
// row 5n + 2 after n barriers the block's end (qtts_trace_end).
static __device__ __forceinline__ void qtts_trace_at(const QttsPlan& p, int row) {
  if (row < p.trace_rows) p.trace[(size_t)row * p.grid + qtts_trace_col()] = qtts_globaltimer();
}

static __device__ __forceinline__ void qtts_trace_mark(const QttsPlan& p, int offset) {
  if (p.trace != nullptr && threadIdx.x == 0) {
    qtts_trace_at(p, 5 * qtts_barrier_index() + 2 + offset);
  }
}

// The grid barrier between two phases (cooperative groups' grid sync; an
// arrive/spin barrier on a generation counter measured twice as slow, and
// the same one-atomic barrier written out with the phase's last ring refill
// issued between arrival and wait gained nothing).
static __device__ __forceinline__ void qtts_phase_barrier(const QttsPlan& p) {
  const bool traced = p.trace != nullptr && threadIdx.x == 0;
  if (traced) qtts_trace_at(p, 5 * qtts_barrier_index() + 5);
  qtts_grid_sync();
  if (traced) qtts_trace_at(p, 5 * qtts_barrier_index()++ + 6);
}

static __device__ __forceinline__ void qtts_trace_end(const QttsPlan& p) {
  if (p.trace != nullptr && threadIdx.x == 0) qtts_trace_at(p, 5 * qtts_barrier_index() + 2);
}

// ---------------------------------------------------------------------------
// The stage sequence and the ring
// ---------------------------------------------------------------------------

// One block's rows of one kind and where its matrices live.
struct QttsKindRows {
  const int8_t* W;  // unit 0's [N, K] rows (the bytes of int8, bf16 or int4 values)
  const float* S;   // unit 0's [N, sfloats] scales
  int N, r0, rows, stage_rows, chunks, K;
  int row_bytes;  // bytes per row: K (int8), 2K (bf16) or K / 2 (int4)
  int sfloats;    // float32 scales per row: 1, or K / 128 at int4
};

// Bytes per row and scales per row of K weights of unit type `unit`.
static __host__ __device__ __forceinline__ int qtts_row_bytes(int unit, int K) {
  return unit == QTTS_UNIT_INT4 ? K / 2 : unit == QTTS_UNIT_BF16 ? 2 * K : K;
}
static __host__ __device__ __forceinline__ int qtts_row_scales(int unit, int K) {
  return unit == QTTS_UNIT_INT4 ? K / 128 : 1;
}

// What one weight set streams: L layers and `heads` head products of N_head
// rows; the passes and heads in chain order, `lead` passes (0 or 1) then
// `heads` times a pass and a head: pass, pass, head 0, pass, head 1, ...,
// the last head (the chain: lead 1); pass, head (the frame's talker and its
// lm_head: lead 0); one pass (a step: lead 1, no heads).  head_k and
// head_esize: a head row's width and bytes per weight where they are not the
// trunk's (the tensor-parallel chain's rank slice of the heads; bf16 heads
// beside an int8 or int4 trunk; 0: H and the trunk's unit type, int8 beside
// an int4 trunk, whose heads are never int4).
struct QttsSetSpec {
  const QttsStepWeights* w;
  const int8_t* heads;
  const float* head_scales;
  int n_heads, head_rows, lead;
  int head_k, head_esize;
};

// The block's stage sequence over the plan's sets, in order.
struct QttsSeq {
  QttsKindRows kind[QTTS_SETS * QTTS_KINDS];  // set s's kind k at s * QTTS_KINDS + k
  int L[QTTS_SETS], lead[QTTS_SETS], heads[QTTS_SETS];
  int n_sets, total;
  // thread 0's cursor: the next stage to issue, as (set, segment, layer or
  // head, kind, chunk); a set's segments are its lead passes, then a pass
  // and a head for each head
  int next, set, seg, unit, cur_kind, chunk;
};

struct QttsRing {
  unsigned char* slots;
  float* scales;
  uint64_t* full;
  int n_slots, slot_bytes, slot_rows;
};

// Thread 0 of every block, once: the rows of each kind of set `set` that
// the plan gives block `block`; returns the set's stage count.
static __device__ int qtts_seq_set(QttsSeq& q, const QttsPlan& p, int set, const QttsSetSpec& sp,
                                   int block) {
  const QttsStepWeights& w = *sp.w;
  const int H = w.H, qd = w.nq * w.D, A = qd + 2 * w.nk * w.D, I = w.I;
  const int at = block + qtts_group_of(p, block);  // the block's bounds entry
  const int N[QTTS_KINDS] = {A, H, 2 * I, H, sp.head_rows};
  const int K[QTTS_KINDS] = {H, qd, H, I, sp.head_k > 0 ? sp.head_k : H};
  const int8_t* W[QTTS_KINDS] = {w.wqkv, w.wo, w.wgu, w.wd, sp.heads};
  const float* S[QTTS_KINDS] = {w.sqkv, w.so, w.sgu, w.sd, sp.head_scales};
  int per_layer = 0;
  for (int k = 0; k < QTTS_KINDS; ++k) {
    const int at_k = set * QTTS_KINDS + k;
    QttsKindRows& r = q.kind[at_k];
    const bool used = k != QTTS_KIND_HEAD || sp.n_heads > 0;
    r.W = W[k];
    r.S = S[k];
    r.N = N[k];
    r.K = K[k];
    r.row_bytes = qtts_row_bytes(w.unit_type, K[k]);
    r.sfloats = qtts_row_scales(w.unit_type, K[k]);
    if (k == QTTS_KIND_HEAD) {  // the trunk's unit type unless set; int8 beside int4
      const int esize = sp.head_esize > 0 ? sp.head_esize : w.unit_type == QTTS_UNIT_BF16 ? 2 : 1;
      r.row_bytes = esize * K[k];
      r.sfloats = 1;
    }
    r.stage_rows = p.stage_rows[at_k];
    r.r0 = used ? p.bounds[at_k * (p.grid + p.groups) + at] : 0;
    r.rows = used ? p.bounds[at_k * (p.grid + p.groups) + at + 1] - r.r0 : 0;
    r.chunks = r.rows > 0 ? (r.rows + r.stage_rows - 1) / r.stage_rows : 0;
    if (k != QTTS_KIND_HEAD) per_layer += r.chunks;
  }
  q.L[set] = w.L;
  q.lead[set] = sp.lead;
  q.heads[set] = sp.n_heads;
  return (sp.lead + sp.n_heads) * w.L * per_layer +
         sp.n_heads * q.kind[set * QTTS_KINDS + QTTS_KIND_HEAD].chunks;
}

// Thread 0: the copies of the cursor's stage into slot next % n_slots
// (nothing past the end), then the cursor one stage on.
static __device__ void qtts_ring_issue(const QttsRing& ring, QttsSeq& q) {
  if (q.next >= q.total) return;
  const QttsKindRows& r = q.kind[q.set * QTTS_KINDS + q.cur_kind];
  const int n0 = r.r0 + q.chunk * r.stage_rows;
  const int rows = min(r.stage_rows, r.rows - q.chunk * r.stage_rows);
  const int slot = q.next % ring.n_slots;
  uint64_t* bar = ring.full + slot;
  const uint32_t wbytes = (uint32_t)rows * r.row_bytes;
  const uint32_t sbytes = 4u * rows * r.sfloats;
  qtts_mbar_expect_tx(bar, wbytes + sbytes);
  qtts_bulk_load(ring.slots + (size_t)slot * ring.slot_bytes,
                 r.W + ((size_t)q.unit * r.N + n0) * r.row_bytes, wbytes, bar);
  qtts_bulk_load(ring.scales + (size_t)slot * ring.slot_rows,
                 r.S + ((size_t)q.unit * r.N + n0) * r.sfloats, sbytes, bar);
  // advance: chunks of a kind, kinds of a layer, layers of a pass; the
  // chunks of a head; then the next segment, and past a set's last
  // segment the next set
  ++q.next;
  bool seg_done = false;
  if (q.cur_kind == QTTS_KIND_HEAD) {
    seg_done = ++q.chunk == r.chunks;
  } else if (++q.chunk == r.chunks) {
    q.chunk = 0;
    if (++q.cur_kind == QTTS_KIND_HEAD) {
      q.cur_kind = 0;
      seg_done = ++q.unit == q.L[q.set];
    }
  }
  if (seg_done) {
    q.chunk = 0;
    if (++q.seg == q.lead[q.set] + 2 * q.heads[q.set]) {
      q.seg = 0;
      if (++q.set == q.n_sets) return;  // the end: q.next == q.total
    }
    const int after = q.seg - q.lead[q.set];  // segments past the lead passes
    const bool head = after >= 0 && after % 2 == 1;
    q.cur_kind = head ? QTTS_KIND_HEAD : 0;
    q.unit = head ? after / 2 : 0;
  }
}

// Every thread: the ring's areas in dynamic shared memory; thread 0 builds
// the sequence of the plan's sets (spec[0 .. p.n_sets)) for plan block
// `block`, initialises the slots' barriers and issues the first n_slots
// stages.  Ends with a block barrier.
static __device__ void qtts_ring_start(QttsRing& ring, QttsSeq& q, unsigned char* smem,
                                       const QttsPlan& p, const QttsSetSpec* spec, int block) {
  const QttsSmemLayout lay = qtts_plan_layout(p);
  ring.full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  ring.scales = reinterpret_cast<float*>(smem + lay.scales);
  ring.slots = smem + lay.slots;
  ring.n_slots = p.n_slots;
  ring.slot_bytes = p.slot_bytes;
  ring.slot_rows = p.slot_rows;
  if (threadIdx.x == 0) {
    qtts_barrier_index() = 0;
    qtts_trace_col() = block;
    if (p.trace != nullptr) qtts_trace_at(p, 1);
    q.n_sets = p.n_sets;
    q.total = 0;
    for (int s = 0; s < p.n_sets; ++s) q.total += qtts_seq_set(q, p, s, spec[s], block);
    q.next = q.set = q.seg = q.unit = q.cur_kind = q.chunk = 0;
    for (int s = 0; s < ring.n_slots; ++s) qtts_mbar_init(ring.full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < ring.n_slots; ++s) qtts_ring_issue(ring, q);
  }
  __syncthreads();
}

// The ring of a whole-grid plan (block blockIdx.x).
static __device__ void qtts_ring_start(QttsRing& ring, QttsSeq& q, unsigned char* smem,
                                       const QttsPlan& p, const QttsSetSpec* spec) {
  qtts_ring_start(ring, q, smem, p, spec, (int)blockIdx.x);
}

// The ring of a one-set plan: the transformer w, then n_heads heads of V
// rows in chain order (none: one pass), of head_esize bytes per weight (0:
// as QttsSetSpec's).
static __device__ void qtts_ring_start(QttsRing& ring, QttsSeq& q, unsigned char* smem,
                                       const QttsPlan& p, const QttsStepWeights& w,
                                       const int8_t* heads, const float* head_scales, int n_heads,
                                       int V, int head_esize = 0) {
  const QttsSetSpec spec{&w, heads, head_scales, n_heads, V, 1, 0, head_esize};
  qtts_ring_start(ring, q, smem, p, &spec);
}

// Byte b of `word` as a signed int8, as float: the byte biased by 128 forms
// the low mantissa byte of 2^23 (the float 8388608 + u, exact), minus
// 8388736 -- exactly (float)(int8_t)byte, in a byte permute and a float add
// instead of a quarter-rate integer-to-float conversion.
static __device__ __forceinline__ float qtts_i8_to_float(uint32_t word, int b) {
  const uint32_t biased = word ^ 0x80808080u;
  const uint32_t bits = __byte_perm(biased, 0x4B000000u, (uint32_t)b | 0x7650u);
  return __fadd_rn(__uint_as_float(bits), -8388736.f);
}

// int4 units: a tag type (the slots hold bytes, two weights each).
struct QttsInt4 {
  uint8_t pair;
};
template <typename WT>
constexpr bool qtts_int4_units = std::is_same<WT, QttsInt4>::value;

// Weight units: int8 (a row's scale applied after the dot product) or bf16
// (scales of one).  Both convert exactly to float, so the same FMA chain
// over a unit's values gives the same sums whatever type held them.  (int4
// units take their own path through qtts_stage_rows: group scales.)
//
// A lane's n consecutive weights of one row into words (n / 4 words of
// int8, n / 2 of bf16): 16-byte loads, one 8-byte load for 8 int8.
template <typename WT, int n>
static __device__ __forceinline__ void qtts_unit_load(const WT* p, uint32_t* words) {
  constexpr int bytes = n * (int)sizeof(WT);
  if constexpr (bytes == 8) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    words[0] = (uint32_t)v.x;
    words[1] = (uint32_t)v.y;
  } else {
    static_assert(bytes % 16 == 0, "whole 16-byte loads");
#pragma unroll
    for (int i = 0; i < bytes / 16; ++i) {
      const int4 v = reinterpret_cast<const int4*>(p)[i];
      words[4 * i] = (uint32_t)v.x;
      words[4 * i + 1] = (uint32_t)v.y;
      words[4 * i + 2] = (uint32_t)v.z;
      words[4 * i + 3] = (uint32_t)v.w;
    }
  }
}

// Weight e of the words qtts_unit_load filled, as float (exact): an int8
// byte by qtts_i8_to_float; a bf16 value by a 16-bit shift (e even: the
// low half of its word, little-endian).
template <typename WT>
static __device__ __forceinline__ float qtts_unit_value(const uint32_t* words, int e) {
  if constexpr (sizeof(WT) == 1) {
    return qtts_i8_to_float(words[e >> 2], e & 3);
  } else {
    const uint32_t w = words[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// The position in shared memory of the B=1 GEMV input's column k: in each
// 512-column pass, lane l's four float4 (columns 16l + 4q .. 16l + 4q + 3, q
// < 4) sit at 128q + 4l, so that the warp's float4 loads of one q fall on
// distinct banks.  (Unswizzled, lane l's chunk starts 64 bytes after lane l -
// 1's: a quarter warp's loads hit two 4-bank groups, a 4-way conflict on the
// input loads that a warp's M rows share; the prologue's stores now take
// that 4-way conflict instead, once per phase.  A layout free of conflicts
// both ways, float4 32q + (l ^ 2q), measured slower: its per-q lane offsets
// cost the dot products registers.)  The layout moves no value: each lane
// reads the same 16 floats in the same order.
static __device__ __forceinline__ int qtts_sh_col(int k) {
  return (k & ~511) | (((k >> 2) & 3) << 7) | (((k >> 4) & 31) << 2) | (k & 3);
}

// qtts_stage_rows at int4 units, defined in fused_int4.cu: the one
// translation unit that instantiates the int4 kernels (so a change to the
// int4 arithmetic rebuilds that source alone).
template <bool ACCUM, int M>
static __device__ __forceinline__ void qtts_stage_rows4(const unsigned char* ws, const float* ss,
                                                        const float* sh, float* out, int n0,
                                                        int K, int warp, int lane);

// A warp's M rows (warp, warp + 8, ...) of one stage: each a dot product in
// K1's lane order, then the xor butterfly and qtts_gemv_store's epilogue
// (the residual, with ACCUM, loaded before the dot products).  M is a
// template argument so that the rows' FFMA chains interleave.  sh: the
// input in qtts_sh_col's layout.  WT: the unit type; a bf16 lane reads its
// 16 columns as two 16-byte loads, in the same FMA order as int8.
template <bool ACCUM, int M, typename WT>
static __device__ __forceinline__ void qtts_stage_rows(const WT* ws, const float* ss,
                                                       const float* sh, float* out, int n0, int K,
                                                       int warp, int lane) {
  if constexpr (qtts_int4_units<WT>) {
    qtts_stage_rows4<ACCUM, M>(reinterpret_cast<const unsigned char*>(ws), ss, sh, out, n0, K,
                               warp, lane);
    return;
  }
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
#pragma unroll
    for (int j = 0; j < M; ++j) {
      uint32_t words[4 * sizeof(WT)];
      qtts_unit_load<WT, 16>(ws + (size_t)(warp + j * QTTS_P_WARPS) * K + k0, words);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[j] = fmaf(hv[e], qtts_unit_value<WT>(words, e), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = qtts_warp_reduce(acc[j], QttsSumF());
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int row = warp + j * QTTS_P_WARPS;
      const float v = __fmul_rn(acc[j], ss[row]);
      out[n0 + row] = ACCUM ? __fadd_rn(res[j], v) : v;
    }
  }
}

// Consumes the block's stages of one GEMV kind index in order (`stage`
// counts the launch's stages): out[n] (+)= scale[n] * sum_k sh[k] * W[n, k]
// for the block's rows n, sh the bf16-rounded input (K floats in
// qtts_sh_col's layout, from qtts_prologue).  Warp w takes the stage's rows
// w, w + 8, ...; after a stage thread 0 refills its slot with the stage
// n_slots ahead.
template <bool ACCUM, typename WT = int8_t>
static __device__ __forceinline__ void qtts_ring_gemv(const QttsPlan& p, const QttsRing& ring,
                                                      QttsSeq& q, int kind, int& stage,
                                                      const float* sh, float* out) {
  qtts_trace_mark(p, 0);
  const QttsKindRows& r = q.kind[kind];
  const int K = r.K, chunks = r.chunks, stage_rows = r.stage_rows, r0 = r.r0, nrows = r.rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = 0; c < chunks; ++c) {
    const int slot = stage % ring.n_slots;
    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);
    if (c == 0) qtts_trace_mark(p, 1);
    const int rows = min(stage_rows, nrows - c * stage_rows);
    const int n0 = r0 + c * stage_rows;
    const WT* ws = reinterpret_cast<const WT*>(ring.slots + (size_t)slot * ring.slot_bytes);
    const float* ss = ring.scales + (size_t)slot * ring.slot_rows;
    const int mine = rows > warp ? (rows - warp + QTTS_P_WARPS - 1) / QTTS_P_WARPS : 0;
    switch (mine) {
      case 1: qtts_stage_rows<ACCUM, 1, WT>(ws, ss, sh, out, n0, K, warp, lane); break;
      case 2: qtts_stage_rows<ACCUM, 2, WT>(ws, ss, sh, out, n0, K, warp, lane); break;
      case 3: qtts_stage_rows<ACCUM, 3, WT>(ws, ss, sh, out, n0, K, warp, lane); break;
      case 4: qtts_stage_rows<ACCUM, 4, WT>(ws, ss, sh, out, n0, K, warp, lane); break;
      case 5: qtts_stage_rows<ACCUM, 5, WT>(ws, ss, sh, out, n0, K, warp, lane); break;
      case 6: qtts_stage_rows<ACCUM, 6, WT>(ws, ss, sh, out, n0, K, warp, lane); break;
      case 7: qtts_stage_rows<ACCUM, 7, WT>(ws, ss, sh, out, n0, K, warp, lane); break;
      case 8: qtts_stage_rows<ACCUM, 8, WT>(ws, ss, sh, out, n0, K, warp, lane); break;
      default: break;
    }
    __syncthreads();  // every warp is done with the slot
    if (c + 1 == chunks) qtts_trace_mark(p, 2);
    if (threadIdx.x == 0) qtts_ring_issue(ring, q);
    ++stage;
  }
}

// ---------------------------------------------------------------------------
// Phase inputs with every load issued before its arithmetic
// ---------------------------------------------------------------------------

// qtts_gemv_prologue's values for K <= VPT * 256 (the same expressions in
// the same order), with the thread's inputs loaded into registers first,
// into sh in qtts_sh_col's layout; raw, if given, gets the float32 values
// before the bf16 rounding, in column order.
template <int IN_MODE, int VPT>
static __device__ __forceinline__ void qtts_prologue_vpt(const float* in,
                                                         const float* __restrict__ norm_w,
                                                         float eps, int K, float* sh,
                                                         float* raw) {
  const int tid = threadIdx.x;
  float a[VPT], b[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int k = tid + i * QTTS_P_THREADS;
    a[i] = 0.f;
    b[i] = 0.f;
    if (k < K) {
      a[i] = in[k];
      if (IN_MODE == QTTS_IN_NORM) b[i] = norm_w[k];
      if (IN_MODE == QTTS_IN_SILU) b[i] = in[K + k];
    }
  }
  float r = 0.f;
  if (IN_MODE == QTTS_IN_NORM) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (tid + i * QTTS_P_THREADS < K) {
        const float v = a[i];
        ss += v * v;
      }
    }
    ss = qtts_block_reduce(ss, QttsSumF());
    r = rsqrtf(ss / (float)K + eps);
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int k = tid + i * QTTS_P_THREADS;
    if (k < K) {
      float v;
      if (IN_MODE == QTTS_IN_NORM) {
        v = (a[i] * r) * b[i];
      } else if (IN_MODE == QTTS_IN_PLAIN) {
        v = a[i];
      } else {
        const float g = a[i];
        const float u = b[i];
        v = g * (1.f / (1.f + expf(-g))) * u;
      }
      if (raw != nullptr) raw[k] = v;
      sh[qtts_sh_col(k)] = qtts_bf16_round(v);
    }
  }
  __syncthreads();
}

// The GEMV input (IN_MODE as in qtts_gemv_prologue) of K <= QTTS_P_MAX_K;
// raw as in qtts_prologue_vpt.
template <int IN_MODE>
static __device__ __forceinline__ void qtts_prologue(const float* in,
                                                     const float* __restrict__ norm_w, float eps,
                                                     int K, float* sh, float* raw = nullptr) {
  if (K <= 4 * QTTS_P_THREADS) {
    qtts_prologue_vpt<IN_MODE, 4>(in, norm_w, eps, K, sh, raw);
  } else if (K <= 8 * QTTS_P_THREADS) {
    qtts_prologue_vpt<IN_MODE, 8>(in, norm_w, eps, K, sh, raw);
  } else if (K <= 12 * QTTS_P_THREADS) {
    qtts_prologue_vpt<IN_MODE, 12>(in, norm_w, eps, K, sh, raw);
  } else {
    qtts_prologue_vpt<IN_MODE, 24>(in, norm_w, eps, K, sh, raw);
  }
}

// Run by the attention item that finishes a kv head's splits last (an
// atomic ticket per head): qtts_attn_combine_body's merge, op for op, of the
// head's q heads into attn, with the partials read past L1 (other blocks
// wrote them in this launch).  Thread t of the item's QTTS_ATTN_D threads.
static __device__ __forceinline__ void qtts_attn_combine_l2(int t, int hq, const float* part,
                                                            float* attn, int max_splits,
                                                            int pos) {
  constexpr int D = QTTS_ATTN_D;
  const int n_splits = pos / QTTS_ATTN_CHUNK + 1;
  constexpr int U = 8;  // splits loaded at once
  const float* base = part + (size_t)hq * max_splits * (D + 2);
  float M = QTTS_NEG_INF;
  for (int s0 = 0; s0 < n_splits; s0 += U) {
    float mv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) mv[u] = s0 + u < n_splits ? __ldcg(base + (s0 + u) * (D + 2)) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < n_splits) M = fmaxf(M, mv[u]);
    }
  }
  float L = 0.f, o = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += U) {
    float mv[U], lv[U], av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* b = base + (s0 + u) * (D + 2);
      const bool in = s0 + u < n_splits;
      mv[u] = in ? __ldcg(b) : 0.f;
      lv[u] = in ? __ldcg(b + 1) : 0.f;
      av[u] = in ? __ldcg(b + 2 + t) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < n_splits) {
        const float f = expf(mv[u] - M);
        L += lv[u] * f;
        o += av[u] * f;
      }
    }
  }
  attn[(size_t)hq * D + t] = o / L;
}

// Prefetches into L2 the cached k and v rows item (h, split) will read
// (slots [split * CHUNK, min((split + 1) * CHUNK, pos)), the new slot pos
// excluded), one 128-byte line per thread and step, t: the thread's index
// among the item's QTTS_ATTN_D threads; on an int8 cache also the lines of
// those slots' k and v scales (ks, vs: the layer row's [nk, T]).
template <typename CT>
static __device__ __forceinline__ void qtts_attn_prefetch(const CT* kc, const CT* vc, int h,
                                                          int split, int T, int pos, int t,
                                                          const float* ks = nullptr,
                                                          const float* vs = nullptr) {
  constexpr int D = QTTS_ATTN_D;
  constexpr int LINES = D * (int)sizeof(CT) / 128;  // lines per cache row
  const int start = split * QTTS_ATTN_CHUNK;
  const int end = min(start + QTTS_ATTN_CHUNK, pos);
  for (int i = t; i < (end - start) * LINES * 2; i += D) {
    const int j = start + (i >> 1) / LINES, line = (i >> 1) % LINES;
    const CT* base = (i & 1) ? vc : kc;
    const void* ptr = base + ((size_t)h * T + j) * D + line * (128 / (int)sizeof(CT));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(ptr));
  }
  if constexpr (qtts_int8_cache<CT>) {
    const int lines = (end - start + 31) / 32;  // 32 scales a line
    if (t < 2 * lines) {
      const float* ptr = ((t & 1) ? vs : ks) + (size_t)h * T + start + (t >> 1) * 32;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ptr));
    }
  }
}

// RMSNorm of N head vectors at once, element t of the item's D threads:
// qtts_head_norm's value for each, with qtts_group_sum's reduction tree (the
// warp butterfly, then warp 0's butterfly over the four warp partials), the
// N trees run side by side on one set of barriers.  scratch: 5 * N floats.
template <int N>
static __device__ __forceinline__ void qtts_head_norms(float (&v)[N], const float (&w)[N],
                                                       float eps, float* scratch,
                                                       QttsNamedSync sync, int t) {
  constexpr int D = QTTS_ATTN_D;
  constexpr int nw = D / 32;
  const int lane = t & 31, warp = t >> 5;
  float ss[N];
#pragma unroll
  for (int i = 0; i < N; ++i) ss[i] = qtts_warp_reduce(v[i] * v[i], QttsSumF());
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[i * nw + warp] = ss[i];
  }
  sync();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float r = lane < nw ? scratch[i * nw + lane] : QttsSumF::identity();
      r = qtts_warp_reduce(r, QttsSumF());
      if (lane == 0) scratch[N * nw + i] = r;
    }
  }
  sync();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float r = rsqrtf(scratch[N * nw + i] / (float)D + eps);
    v[i] = (v[i] * r) * w[i];
  }
  sync();
}

// Work item (h, split) of the B=1 split attention on one 128-thread half,
// GG = nq / nk q heads per kv head: qtts_attn_split_body<CT, false> with
// S = 1 and row 0, op for op.  Reordered where no value depends on it: the
// item's qkv, norm and angle operands load at once, its GG + 1 head norms
// share their barriers, each warp keeps four cache slots in flight, and
// the dot products of a block of four slots run before that block's
// (serial) online-softmax updates.  With attn given (the position's only
// split), the item also merges its heads into attn itself, as the combine
// would.  OWN = false (K6): the slot-write phase has stored every row's new
// slot, and the item reads every slot, its own included, from the cache (the
// same values: the write rounds to the cache dtype as the item would).
//
// On an int8 cache (CT = int8_t; ks, vs: the layer row's [nk, T] scales) the
// item quantizes the new k and v on their scales (qtts_kv_scales, one more
// pair of barriers), split 0 stores the int8 values and the scales, and the
// slot's own term reads those same values, as a slot read from the cache
// would; slot j's score is (q . k_j) * scale * ks[j] and its value term
// (p * vs[j]) * v_j, the JAX kernel's ew = e * vs.
template <typename CT, int GG, bool OWN>
static __device__ __forceinline__ void qtts_attn_item(
    QttsAttnSmem& sm, QttsNamedSync sync, int t, int h, int split, const float* qkv,
    const float* __restrict__ q_norm, const float* __restrict__ k_norm,
    const float* __restrict__ inv_freq, CT* __restrict__ kc, CT* __restrict__ vc,
    float* __restrict__ part, float* attn, int nq, int nk, int T, int pos, int max_splits,
    float eps, float scale, float* __restrict__ ks, float* __restrict__ vs) {
  constexpr int D = QTTS_ATTN_D;
  if (split * QTTS_ATTN_CHUNK > pos) return;
  auto& q_s = sm.q_s;
  auto& k_s = sm.k_s;
  auto& v_s = sm.v_s;
  const int qd = nq * D, kvd = nk * D;
  // q heads 0..GG-1, then k
  float hv[GG + 1], hw[GG + 1];
#pragma unroll
  for (int gi = 0; gi < GG; ++gi) {
    hv[gi] = qkv[(h * GG + gi) * D + t];
    hw[gi] = q_norm[t];
  }
  hv[GG] = qkv[qd + h * D + t];
  hw[GG] = k_norm[t];
  const float vin = qkv[qd + kvd + h * D + t];
  float c = 0.f, s = 0.f;
  if (t < D / 2) {
    const float ang = (float)pos * inv_freq[t];
    c = cosf(ang);
    s = sinf(ang);
  }
  qtts_head_norms<GG + 1>(hv, hw, eps, &sm.wacc[0][0][0], sync, t);
#pragma unroll
  for (int gi = 0; gi < GG; ++gi) q_s[gi][t] = hv[gi];
  k_s[t] = hv[GG];
  v_s[t] = vin;
  sync();
  if (t < D / 2) {
#pragma unroll
    for (int gi = 0; gi < GG; ++gi) qtts_rope_pair(q_s[gi][t], q_s[gi][t + D / 2], c, s);
    qtts_rope_pair(k_s[t], k_s[t + D / 2], c, s);
  }
  sync();
  float ks_own = 0.f, vs_own = 0.f;  // the new slot's int8 scales
  if constexpr (qtts_int8_cache<CT>) {
    if (OWN) {
      const float2 sc = qtts_kv_scales(k_s[t], v_s[t], sm.red, sync, t);
      ks_own = sc.x;
      vs_own = sc.y;
      const float kq = qtts_quant8(k_s[t], ks_own), vq = qtts_quant8(v_s[t], vs_own);
      k_s[t] = kq;
      v_s[t] = vq;
      if (split == 0) {
        kc[((size_t)h * T + pos) * D + t] = (int8_t)kq;
        vc[((size_t)h * T + pos) * D + t] = (int8_t)vq;
        if (t == 0) {
          ks[(size_t)h * T + pos] = ks_own;
          vs[(size_t)h * T + pos] = vs_own;
        }
      }
    }
  } else {
    const CT kq = qtts_to_cache<CT>(k_s[t]);
    const CT vq = qtts_to_cache<CT>(v_s[t]);
    k_s[t] = qtts_from_cache(kq);
    v_s[t] = qtts_from_cache(vq);
    if (OWN && split == 0) {
      kc[((size_t)h * T + pos) * D + t] = kq;
      vc[((size_t)h * T + pos) * D + t] = vq;
    }
  }
  sync();

  const int warp = t >> 5, lane = t & 31;
  float qr[GG][4];
  float m[GG], l[GG], acc[GG][4];
#pragma unroll
  for (int gi = 0; gi < GG; ++gi) {
    m[gi] = QTTS_NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[gi][e] = 0.f;
      qr[gi][e] = q_s[gi][lane * 4 + e];
    }
  }
  const int start = split * QTTS_ATTN_CHUNK;
  const int end = min(start + QTTS_ATTN_CHUNK, pos + 1);
  auto fetch = [&](int j, float (&kf)[4], float (&vf)[4]) {
    if (OWN && j == pos) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kf[e] = k_s[lane * 4 + e];
        vf[e] = v_s[lane * 4 + e];
      }
    } else {
      qtts_load4(kc + ((size_t)h * T + j) * D + lane * 4, kf);
      qtts_load4(vc + ((size_t)h * T + j) * D + lane * 4, vf);
    }
  };
  // an int8 cache's slot scales, beside its values
  auto fetch_scales = [&](int j, float& a, float& b) {
    if (OWN && j == pos) {
      a = ks_own;
      b = vs_own;
    } else {
      a = ks[(size_t)h * T + j];
      b = vs[(size_t)h * T + j];
    }
  };
  // the warp's slots j0, j0 + 4, ... in order, DEPTH in flight
  constexpr int DEPTH = 4;
  const int j0 = start + warp;
  float kb[DEPTH][4], vb[DEPTH][4];
  float ksb[DEPTH], vsb[DEPTH];
#pragma unroll
  for (int u = 0; u < DEPTH; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) kb[u][e] = vb[u][e] = 0.f;
    ksb[u] = vsb[u] = 0.f;
    if (j0 + 4 * u < end) {
      fetch(j0 + 4 * u, kb[u], vb[u]);
      if constexpr (qtts_int8_cache<CT>) fetch_scales(j0 + 4 * u, ksb[u], vsb[u]);
    }
  }
  for (int jb = j0; jb < end; jb += 4 * DEPTH) {
    float dots[DEPTH][GG];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
#pragma unroll
      for (int gi = 0; gi < GG; ++gi) {
        const float (&kf)[4] = kb[u];
        float d = qr[gi][0] * kf[0] + qr[gi][1] * kf[1] + qr[gi][2] * kf[2] + qr[gi][3] * kf[3];
        dots[u][gi] = qtts_warp_reduce(d, QttsSumF());
      }
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int j = jb + 4 * u;
      if (j < end) {
#pragma unroll
        for (int gi = 0; gi < GG; ++gi) {
          float sc = dots[u][gi] * scale;
          if constexpr (qtts_int8_cache<CT>) sc = sc * ksb[u];
          const float mn = fmaxf(m[gi], sc);
          const float alpha = expf(m[gi] - mn);
          const float p = expf(sc - mn);
          l[gi] = l[gi] * alpha + p;
          // the value term's weight: p, times the slot's v scale on an int8 cache
          const float pv = qtts_int8_cache<CT> ? p * vsb[u] : p;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][e] = acc[gi][e] * alpha + pv * vb[u][e];
          m[gi] = mn;
        }
        if (j + 4 * DEPTH < end) {
          fetch(j + 4 * DEPTH, kb[u], vb[u]);
          if constexpr (qtts_int8_cache<CT>) fetch_scales(j + 4 * DEPTH, ksb[u], vsb[u]);
        }
      }
    }
  }
  auto& wm = sm.wm;
  auto& wl = sm.wl;
  auto& wacc = sm.wacc;
#pragma unroll
  for (int gi = 0; gi < GG; ++gi) {
    if (lane == 0) {
      wm[warp][gi] = m[gi];
      wl[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) wacc[warp][gi][lane * 4 + e] = acc[gi][e];
  }
  sync();
  for (int gi = 0; gi < GG; ++gi) {
    float M = wm[0][gi];
    for (int w = 1; w < 4; ++w) M = fmaxf(M, wm[w][gi]);
    float L = 0.f, o = 0.f;
    for (int w = 0; w < 4; ++w) {
      const float f = expf(wm[w][gi] - M);
      L += wl[w][gi] * f;
      o += wacc[w][gi][t] * f;
    }
    if (attn != nullptr) {
      // the only split: qtts_attn_combine_body's merge of one partial, op
      // for op, without the round trip through part
      const float Mc = fmaxf(QTTS_NEG_INF, M);
      const float f = expf(M - Mc);
      float Lc = 0.f, oc = 0.f;
      Lc += L * f;
      oc += o * f;
      attn[(size_t)(h * GG + gi) * D + t] = oc / Lc;
      continue;
    }
    float* dst = part + ((size_t)(h * GG + gi) * max_splits + split) * (D + 2);
    if (t == 0) {
      dst[0] = M;
      dst[1] = L;
    }
    dst[2 + t] = o;
  }
}

// The item dispatched on the group size nq / nk (1, 2, 4 or 8).
template <typename CT, bool OWN = true>
static __device__ __forceinline__ void qtts_attn_item_any(
    QttsAttnSmem& sm, QttsNamedSync sync, int t, int h, int split, const float* qkv,
    const float* __restrict__ q_norm, const float* __restrict__ k_norm,
    const float* __restrict__ inv_freq, CT* __restrict__ kc, CT* __restrict__ vc,
    float* __restrict__ part, float* attn, int nq, int nk, int T, int pos, int max_splits,
    float eps, float scale, float* ks = nullptr, float* vs = nullptr) {
#define QTTS_ITEM(GG)                                                                         \
  qtts_attn_item<CT, GG, OWN>(sm, sync, t, h, split, qkv, q_norm, k_norm, inv_freq, kc, vc,   \
                              part, attn, nq, nk, T, pos, max_splits, eps, scale, ks, vs)
  switch (nq / nk) {
    case 1: QTTS_ITEM(1); break;
    case 2: QTTS_ITEM(2); break;
    case 4: QTTS_ITEM(4); break;
    default: QTTS_ITEM(8); break;
  }
#undef QTTS_ITEM
}

// ---------------------------------------------------------------------------
// One decode step through every layer, as grid phases
// ---------------------------------------------------------------------------

// Where the step's blocks stand: the whole grid, whose phases end at grid
// barriers and whose o and down products add into the residual (K1-K7).
// The tensor-parallel step (fused_tp.cu) runs the same phases on one rank's
// block group with a barrier of its own and an all-reduce of the residual's
// partials (`site`: the product's exchange, 2 per layer).
struct QttsWholeGrid {
  __device__ __forceinline__ int block() const { return (int)blockIdx.x; }
  __device__ __forceinline__ int blocks() const { return (int)gridDim.x; }
  __device__ __forceinline__ void barrier(const QttsPlan& p) const { qtts_phase_barrier(p); }
  template <typename WT>
  __device__ __forceinline__ void residual(const QttsPlan& p, const QttsRing& ring, QttsSeq& q,
                                           int kind, int& stage, const float* sh, float* x,
                                           int site) const {
    qtts_ring_gemv<true, WT>(p, ring, q, kind, stage, sh, x);
  }
};

// x_in is read by layer 0's qkv prologue and copied to x there.  `set`: the
// plan's weight set of w.  `un`: the union region.  last_barrier: end with a
// grid barrier (a phase follows).  WT: w's unit type.  ks, vs: an int8
// cache's [L, nk, T] scales (CT = int8_t), updated in place with the cache.
// g: the blocks the phases run on (QttsWholeGrid: the launch's grid).
template <typename CT, typename WT = int8_t, typename G = QttsWholeGrid>
static __device__ __forceinline__ void qtts_step_phases(const QttsStepWeights& w,
                                                        const QttsStepScratch& s,
                                        const QttsPlan& p, const QttsRing& ring,
                                        QttsSeq& q, int set, int& stage, const float* x_in,
                                        float* x, CT* kc, CT* vc, int T, int pos,
                                        unsigned char* un, bool last_barrier,
                                        float* ks = nullptr, float* vs = nullptr,
                                        const G& g = G()) {
  const int H = w.H, I = w.I, D = w.D;
  const int kinds = set * QTTS_KINDS;  // the set's kind indices
  const int n_splits = pos / QTTS_ATTN_CHUNK + 1;
  const int tid = threadIdx.x;
  const int half = tid / QTTS_ATTN_D, t = tid % QTTS_ATTN_D;
  const QttsNamedSync hsync{1 + half};
  const int lane0 = 2 * g.block() + half, lanes = 2 * g.blocks();  // attention item dealing
  const size_t row = (size_t)w.nk * T * D;
  const size_t srow = (size_t)w.nk * T;  // one layer's int8 scales
  float* sh = reinterpret_cast<float*>(un);
  QttsAttnSmem* am = reinterpret_cast<QttsAttnSmem*>(un);
  for (int l = 0; l < w.L; ++l) {
    float* ksl = qtts_int8_cache<CT> ? ks + l * srow : nullptr;
    float* vsl = qtts_int8_cache<CT> ? vs + l * srow : nullptr;
    // this layer's cached k / v rows of the half's attention items, into L2
    // now: the item loop would otherwise wait on device memory slot by slot
    for (int it = lane0; it < w.nk * n_splits; it += lanes) {
      qtts_attn_prefetch(kc + l * row, vc + l * row, it % w.nk, it / w.nk, T, pos, t, ksl, vsl);
    }
    // qkv = bf16(RMSNorm(x) * attn_norm) @ Wqkv * scale
    qtts_prologue<QTTS_IN_NORM>(l == 0 ? x_in : x, w.attn_norm + (size_t)l * H, w.eps, H, sh);
    if (l == 0 && x_in != x) {
      for (int k = g.block() * blockDim.x + tid; k < H; k += g.blocks() * blockDim.x) {
        x[k] = x_in[k];
      }
    }
    qtts_ring_gemv<false, WT>(p, ring, q, kinds + QTTS_KIND_QKV, stage, sh, s.qkv);
    g.barrier(p);
    // the split attention: K1's items, two per block at once; the last item
    // of each kv head to finish merges the head's splits into s.attn
    for (int it = lane0; it < w.nk * n_splits; it += lanes) {
      const int h = it % w.nk;
      hsync();  // the half's previous item is done with its shared memory
      qtts_attn_item_any<CT>(am[half], hsync, t, h, it / w.nk, s.qkv, w.q_norm + (size_t)l * D,
                         w.k_norm + (size_t)l * D, w.inv_freq, kc + l * row, vc + l * row,
                         s.part, n_splits == 1 ? s.attn : nullptr, w.nq, w.nk, T, pos,
                         s.max_splits, w.eps, w.attn_scale, ksl, vsl);
      if (n_splits == 1) continue;
      __threadfence();  // the item's partials, before its ticket
      hsync();
      int* ticket = reinterpret_cast<int*>(am[half].red);  // free once the item is done
      if (t == 0) *ticket = (int)atomicAdd(p.tickets + h, 1u);
      hsync();
      if (*ticket == n_splits - 1) {
        __threadfence();
        const int g = w.nq / w.nk;
        for (int gi = 0; gi < g; ++gi) {
          qtts_attn_combine_l2(t, h * g + gi, s.part, s.attn, s.max_splits, pos);
        }
        if (t == 0) p.tickets[h] = 0u;  // every split has taken its ticket
      }
    }
    g.barrier(p);
    // x += bf16(attn) @ Wo * scale
    qtts_prologue<QTTS_IN_PLAIN>(s.attn, nullptr, 0.f, w.nq * D, sh);
    g.template residual<WT>(p, ring, q, kinds + QTTS_KIND_O, stage, sh, x, 2 * l);
    g.barrier(p);
    // gu = bf16(RMSNorm(x) * mlp_norm) @ Wgu * scale
    qtts_prologue<QTTS_IN_NORM>(x, w.mlp_norm + (size_t)l * H, w.eps, H, sh);
    qtts_ring_gemv<false, WT>(p, ring, q, kinds + QTTS_KIND_GU, stage, sh, s.gu);
    g.barrier(p);
    // x += bf16(silu(gate) * up) @ Wd * scale
    qtts_prologue<QTTS_IN_SILU>(s.gu, nullptr, 0.f, I, sh);
    g.template residual<WT>(p, ring, q, kinds + QTTS_KIND_DOWN, stage, sh, x, 2 * l + 1);
    if (l + 1 < w.L || last_barrier) g.barrier(p);
  }
}

// ---------------------------------------------------------------------------
// The sampler on registers (K2, K5; K7's code0 draw on Vc values)
// ---------------------------------------------------------------------------

// The argmax's block scratch (one per kernel, whatever VPT).
struct QttsArgmaxSmem {
  float rv[32];
  int ri[32];
  int result;
};
static __device__ __forceinline__ QttsArgmaxSmem& qtts_argmax_smem() {
  __shared__ QttsArgmaxSmem sm;
  return sm;
}

// First index of the maximum of the block's values (thread tid holds index
// tid + i * blockDim.x in val[i]); qtts_block_argmax_first's comparisons.
template <int VPT>
static __device__ __forceinline__ int qtts_argmax_regs(const float (&val)[VPT], int n) {
  float* rv = qtts_argmax_smem().rv;
  int* ri = qtts_argmax_smem().ri;
  int& result = qtts_argmax_smem().result;
  float bv = -CUDART_INF_F;
  int bi = n;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < n && val[i] > bv) {
      bv = val[i];
      bi = v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    rv[warp] = bv;
    ri[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < nw ? rv[lane] : -CUDART_INF_F;
    bi = lane < nw ? ri[lane] : n;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) result = bi;
  }
  __syncthreads();
  const int out = result;
  __syncthreads();
  return out;
}

// A float's key in the order of the signed integers (the float order; -0
// and +0 get two keys), and back.
static __device__ __forceinline__ int qtts_float_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
static __device__ __forceinline__ float qtts_key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The midpoints of the round tree below (lo, hi): node c's interval is the
// (lo, hi) the sequential bisection holds when its path leads there; the
// left child (2c + 1) takes hi = mid, the right child (2c + 2) lo = mid.
template <int N>
static __device__ __forceinline__ void qtts_round_tree(float lo, float hi, float (&mid)[N]) {
  float nlo[N], nhi[N];
  nlo[0] = lo;
  nhi[0] = hi;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    mid[c] = 0.5f * (nlo[c] + nhi[c]);
    if (2 * c + 2 < N) {
      nlo[2 * c + 1] = nlo[c];
      nhi[2 * c + 1] = mid[c];
      nlo[2 * c + 2] = mid[c];
      nhi[2 * c + 2] = nhi[c];
    }
  }
}

// Follows the round tree from the root for `rounds` (<= depth) rounds: at
// node c `right[c]` sends the search right (lo = mid[c]), else left
// (hi = mid[c]).
template <int N>
static __device__ __forceinline__ void qtts_round_walk(const float (&mid)[N],
                                                       const bool (&right)[N], int rounds,
                                                       float& lo, float& hi) {
  int node = 0;
#pragma unroll
  for (int d = 0; (1 << d) - 1 < N; ++d) {
    if (d < rounds) {
      float m = 0.f;
      bool r = false;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        if (c == node) {
          m = mid[c];
          r = right[c];
        }
      }
      if (r) {
        lo = m;
        node = 2 * node + 2;
      } else {
        hi = m;
        node = 2 * node + 1;
      }
    }
  }
}

// qtts_sample_index's function on the logits load(v) for v < V (V <= 256 *
// VPT), every value in registers at v = tid + i * 256.  Same op sequence:
// temperature, the top-k threshold by 40 rounds of bisection on
// integer counts, the masked softmax with qtts_block_reduce's trees (every
// warp runs the second level itself), the
// top-p threshold by 40 rounds on float sums in each thread's order and the
// same block tree (every warp runs the second level itself), the
// first-index argmax of masked + noise.  The min and max of the scaled row
// share one reduction (both are exact in any order), the rounds run
// QTTS_SPEC_DEPTH at a time, and a bisection whose mask is off (top-k
// outside (0, V), top-p >= 1) is skipped, since its threshold is then unread.
// A round's decision depends on one value: the top_k-th largest u (the
// count reaches top_k exactly when u >= mid) or the probability u at which
// the kept mass falls below top_p (kept exactly when mid < u).  u lies in
// the interval (top-k: in [lo, hi]; top-p: in (plo, phi] once both ends
// have moved), and each pass also finds the least and the largest value
// there; when they are equal that value is u, and the rest of the
// bisection runs on lo and hi alone, u deciding each round (the same float
// steps, no reduction).
// With a plan `tp` whose trace is on, thread 0 marks the phase's trace rows
// 0-2 after the top-k threshold, the softmax and the top-p threshold.
template <int VPT, typename Load>
static __device__ int qtts_sample_regs(Load load, int V, const float* gumbel, float temperature,
                                       int top_k, float top_p, int greedy, QttsSampleSmem& sm,
                                       const QttsPlan* tp = nullptr) {
  constexpr int N = (1 << QTTS_SPEC_DEPTH) - 1;
  static_assert(N == 3, "a pass exchanges three candidates per warp");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float lg[VPT], gm[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = tid + i * QTTS_P_THREADS;
    lg[i] = v < V ? load(v) : 0.f;
    gm[i] = v < V && !greedy ? __ldcg(gumbel + v) : 0.f;
  }
  if (greedy) return qtts_argmax_regs<VPT>(lg, V);
  float lmin = QttsMinF::identity(), lmax = QttsMaxF::identity();
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (tid + i * QTTS_P_THREADS < V) {
      lg[i] = lg[i] / temperature;
      lmin = fminf(lmin, lg[i]);
      lmax = fmaxf(lmax, lg[i]);
    }
  }
  lmin = qtts_warp_reduce(lmin, QttsMinF());
  lmax = qtts_warp_reduce(lmax, QttsMaxF());
  if (lane == 0) {
    sm.lim[0][warp] = lmin;
    sm.lim[1][warp] = lmax;
  }
  __syncthreads();
  float lo = QttsMinF::identity(), hi = QttsMaxF::identity();
#pragma unroll
  for (int w = 0; w < QTTS_P_WARPS; ++w) {
    lo = fminf(lo, sm.lim[0][w]);
    hi = fmaxf(hi, sm.lim[1][w]);
  }
  const bool k_active = top_k > 0 && top_k < V;
  int buf = 0;
  if (k_active) {
    for (int done = 0; done < QTTS_BISECT_ROUNDS; done += QTTS_SPEC_DEPTH, buf ^= 1) {
      float mid[N];
      qtts_round_tree(lo, hi, mid);
      // cnt: the candidates' counts; kmin, kmax: the keys of the values in
      // [lo, hi], where the top_k-th largest lies
      int cnt[N];
      int kmin = 0x7fffffff, kmax = -0x7fffffff - 1;
#pragma unroll
      for (int c = 0; c < N; ++c) cnt[c] = 0;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (tid + i * QTTS_P_THREADS < V) {
#pragma unroll
          for (int c = 0; c < N; ++c) cnt[c] += lg[i] >= mid[c] ? 1 : 0;
          if (lg[i] >= lo && lg[i] <= hi) {
            kmin = min(kmin, qtts_float_key(lg[i]));
            kmax = max(kmax, qtts_float_key(lg[i]));
          }
        }
      }
      int4 w0, w1;
      w0.x = __reduce_add_sync(0xffffffffu, cnt[0]);
      w0.y = __reduce_add_sync(0xffffffffu, cnt[1]);
      w0.z = __reduce_add_sync(0xffffffffu, cnt[2]);
      w0.w = 0;
      w1.x = __reduce_min_sync(0xffffffffu, kmin);
      w1.y = __reduce_max_sync(0xffffffffu, kmax);
      w1.z = w1.w = 0;
      if (lane == 0) {
        *reinterpret_cast<int4*>(sm.cnt[buf][warp]) = w0;
        *reinterpret_cast<int4*>(sm.cnt[buf][warp] + 4) = w1;
      }
      __syncthreads();
      int total[N] = {};  // integers: any order
      kmin = 0x7fffffff;
      kmax = -0x7fffffff - 1;
#pragma unroll
      for (int w = 0; w < QTTS_P_WARPS; ++w) {
        const int4 t = *reinterpret_cast<const int4*>(sm.cnt[buf][w]);
        total[0] += t.x;
        total[1] += t.y;
        total[2] += t.z;
        const int4 k = *reinterpret_cast<const int4*>(sm.cnt[buf][w] + 4);
        kmin = min(kmin, k.x);
        kmax = max(kmax, k.y);
      }
      if (kmin == kmax) {
        // one value u (the top_k-th largest) is left in [lo, hi]: every
        // later round's count reaches top_k exactly when u >= its midpoint
        const float u = qtts_key_float(kmin);
        for (int r = done; r < QTTS_BISECT_ROUNDS; ++r) {
          const float m = 0.5f * (lo + hi);
          if (u >= m) lo = m; else hi = m;
        }
        break;
      }
      bool right[N];
#pragma unroll
      for (int c = 0; c < N; ++c) right[c] = total[c] >= top_k;
      qtts_round_walk(mid, right, QTTS_BISECT_ROUNDS - done, lo, hi);
    }
  }
  if (tp != nullptr) qtts_trace_mark(*tp, 0);
  float mloc = QttsMaxF::identity();
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (tid + i * QTTS_P_THREADS < V) {
      const float s = lg[i];
      lg[i] = (s >= lo || !k_active) ? s : QTTS_NEG_INF;
      mloc = fmaxf(mloc, lg[i]);
    }
  }
  // the max, then the sum, each by qtts_block_reduce's tree with its second
  // level run by every warp (one block barrier each)
  mloc = qtts_warp_reduce(mloc, QttsMaxF());
  if (lane == 0) sm.red[0][warp] = mloc;
  __syncthreads();
  const float mm = qtts_warp_reduce(
      lane < QTTS_P_WARPS ? sm.red[0][lane] : QttsMaxF::identity(), QttsMaxF());
  float pr[VPT];
  float sloc = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    pr[i] = 0.f;
    if (tid + i * QTTS_P_THREADS < V) {
      const float e = expf(lg[i] - mm);
      pr[i] = e;
      sloc += e;
    }
  }
  sloc = qtts_warp_reduce(sloc, QttsSumF());
  if (lane == 0) sm.red[1][warp] = sloc;
  __syncthreads();
  const float se = qtts_warp_reduce(
      lane < QTTS_P_WARPS ? sm.red[1][lane] : QttsSumF::identity(), QttsSumF());
#pragma unroll
  for (int i = 0; i < VPT; ++i) pr[i] = pr[i] / se;
  if (tp != nullptr) qtts_trace_mark(*tp, 1);
  const bool p_off = top_p >= 1.f;
  float plo = 0.f, phi = 1.f;
  if (!p_off) {
    for (int done = 0; done < QTTS_BISECT_ROUNDS; done += QTTS_SPEC_DEPTH, buf ^= 1) {
      float mid[N];
      qtts_round_tree(plo, phi, mid);
      // s: the candidates' sums; kmin, kmax: the keys of the probabilities
      // in (plo, phi], once both ends have moved (then the probability whose
      // mass crosses top_p lies there)
      const bool isolate = plo != 0.f && phi != 1.f;
      float s[N];
      int kmin = 0x7fffffff, kmax = -0x7fffffff - 1;
#pragma unroll
      for (int c = 0; c < N; ++c) s[c] = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (tid + i * QTTS_P_THREADS < V) {
#pragma unroll
          for (int c = 0; c < N; ++c) s[c] += pr[i] > mid[c] ? pr[i] : 0.f;
          if (isolate && pr[i] > plo && pr[i] <= phi) {
            kmin = min(kmin, __float_as_int(pr[i]));
            kmax = max(kmax, __float_as_int(pr[i]));
          }
        }
      }
      float4 ws;
      ws.x = qtts_warp_reduce(s[0], QttsSumF());
      ws.y = qtts_warp_reduce(s[1], QttsSumF());
      ws.z = qtts_warp_reduce(s[2], QttsSumF());
      ws.w = 0.f;
      int4 wk;
      if (isolate) {
        wk.x = __reduce_min_sync(0xffffffffu, kmin);
        wk.y = __reduce_max_sync(0xffffffffu, kmax);
      }
      if (lane == 0) {
        *reinterpret_cast<float4*>(sm.part[buf][warp]) = ws;
        if (isolate) *reinterpret_cast<int4*>(sm.cnt[buf][warp] + 4) = wk;
      }
      __syncthreads();
      if (isolate) {
        kmin = 0x7fffffff;
        kmax = -0x7fffffff - 1;
#pragma unroll
        for (int w = 0; w < QTTS_P_WARPS; ++w) {
          const int4 k = *reinterpret_cast<const int4*>(sm.cnt[buf][w] + 4);
          kmin = min(kmin, k.x);
          kmax = max(kmax, k.y);
        }
        if (kmin == kmax) {
          // one probability u lies in (plo, phi]: every later round keeps
          // the mass past top_p exactly when its midpoint is below u
          const float u = __int_as_float(kmin);
          for (int r = done; r < QTTS_BISECT_ROUNDS; ++r) {
            const float m = 0.5f * (plo + phi);
            if (m < u) plo = m; else phi = m;
          }
          break;
        }
      }
      const float4 pv = lane < QTTS_P_WARPS ? *reinterpret_cast<const float4*>(sm.part[buf][lane])
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float pc[N] = {pv.x, pv.y, pv.z};
      bool right[N];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float r = qtts_warp_reduce(pc[c], QttsSumF());
        right[c] = !(r < top_p);  // s < top_p keeps the lower half (phi = mid)
      }
      qtts_round_walk(mid, right, QTTS_BISECT_ROUNDS - done, plo, phi);
    }
  }
  if (tp != nullptr) qtts_trace_mark(*tp, 2);
  float val[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const float fin = (pr[i] > plo || p_off) ? lg[i] : QTTS_NEG_INF;
    val[i] = fin + gm[i];
  }
  return qtts_argmax_regs<VPT>(val, V);
}

// The sampler on logits [V] in device memory, V <= 256 * QTTS_SAMPLE_VPT
// (K2, K5: written by other blocks in this launch, so read past L1).
static __device__ __forceinline__ int qtts_sample_fast(const float* logits, int V,
                                                       const float* gumbel, float temperature,
                                                       int top_k, float top_p, int greedy,
                                                       QttsSampleSmem& sm,
                                                       const QttsPlan* tp = nullptr) {
  return qtts_sample_regs<QTTS_SAMPLE_VPT>(
      [logits](int v) { return __ldcg(logits + v); }, V, gumbel, temperature, top_k, top_p,
      greedy, sm, tp);
}

// ---------------------------------------------------------------------------
// The B=1 sub-code chain (K2, K3, and the chain of K7's frame)
// ---------------------------------------------------------------------------

// One more B=1 step after a chain, on another weight set (the frame's
// talker step): its weights, scratch, plan set, residual (read and written
// in place), caches (and an int8 cache's scales) and position.
template <typename CT>
struct QttsStepTail {
  const QttsStepWeights* w;
  const QttsStepScratch* s;
  int set;
  float* x;
  CT* kc;
  CT* vc;
  float* ks;
  float* vs;
  int T, pos;
};

// The whole chain of weight set `set` as grid phases: two prefix trunk
// passes at positions 0 and 1 (c.last_hidden, then c.code0_embed) into the
// (n + 2)-slot cache, then for j = 0..n-1 the head product, block 0's draw
// and gather, and (j < n - 1) a trunk pass on the sampled embedding at
// position 2 + j.  After the last gather block 0 runs last() (the frame's
// next input); with a tail, a grid barrier and the tail's step follow, else
// the chain ends without a grid barrier.  Every pass, the tail's included,
// runs at the one call site of qtts_step_phases: inlined once, the step's
// phases keep their registers (a step called from several sites is an
// out-of-line function, which spilled in its GEMV and attention loops).
// WT: the unit type of w.  TCT and TWT: the tail's cache and unit types;
// where either is not the chain's (the frame's int8 talker cache beside a
// bf16 chain cache; a talker of another unit type than the trunk) the
// tail's step has a call site of its own.  HT: the heads' unit type (int8
// or bf16), the trunk's unless given.
template <typename CT, typename WT = int8_t, typename TCT = CT, typename HT = WT,
          typename TWT = WT, typename Last>
static __device__ __forceinline__ void qtts_chain_phases(
    const QttsStepWeights& w, const QttsStepScratch& s, const QttsPlan& p, const QttsRing& ring,
    QttsSeq& q, int set, int& stage, const QttsChainArgs& c, unsigned char* un, Last last,
    const QttsStepTail<TCT>* tail = nullptr) {
  const int H = w.H, V = c.V, n = c.n;
  float* sh = reinterpret_cast<float*>(un);
  const int passes = n + 1 + (tail != nullptr ? 1 : 0);
  for (int pass = 0; pass < passes; ++pass) {
    const bool talker = pass == n + 1;
    const float* in = pass == 0 ? c.last_hidden : pass == 1 ? c.code0_embed : c.x_in;
    if constexpr (std::is_same<CT, TCT>::value && std::is_same<WT, TWT>::value) {
      qtts_step_phases<CT, WT>(talker ? *tail->w : w, talker ? *tail->s : s, p, ring, q,
                           talker ? tail->set : set, stage, talker ? tail->x : in,
                           talker ? tail->x : c.x,
                           talker ? tail->kc : static_cast<CT*>(c.k_cache),
                           talker ? tail->vc : static_cast<CT*>(c.v_cache),
                           talker ? tail->T : n + 2, talker ? tail->pos : pass, un, true);
    } else if (talker) {
      qtts_step_phases<TCT, TWT>(*tail->w, *tail->s, p, ring, q, tail->set, stage, tail->x,
                                 tail->x, tail->kc, tail->vc, tail->T, tail->pos, un, true,
                                 tail->ks, tail->vs);
    } else {
      qtts_step_phases<CT, WT>(w, s, p, ring, q, set, stage, in, c.x,
                               static_cast<CT*>(c.k_cache), static_cast<CT*>(c.v_cache), n + 2,
                               pass, un, true);
    }
    if (pass == 0 || talker) continue;
    const int j = pass - 1;
    // logits = bf16(RMSNorm(x) * final_norm) @ head_j * scale_j
    qtts_prologue<QTTS_IN_NORM>(c.x, c.final_norm, w.eps, H, sh);
    qtts_ring_gemv<false, HT>(p, ring, q, set * QTTS_KINDS + QTTS_KIND_HEAD, stage, sh,
                              c.logits);
    qtts_phase_barrier(p);
    if (blockIdx.x == 0) {
      // the draw, then the embedding row into sub_sum and the next trunk input
      const int sub = qtts_sample_fast(c.logits, V, c.gumbel + (size_t)j * V,
                                             c.temperature, c.top_k, c.top_p, c.greedy,
                                             *reinterpret_cast<QttsSampleSmem*>(un), &p);
      if (threadIdx.x == 0) c.subcodes[j] = sub;
      const __nv_bfloat16* table = c.tables + (size_t)j * c.Vt * H + (size_t)sub * H;
      for (int k = threadIdx.x; k < H; k += blockDim.x) {
        const float e = __bfloat162float(table[k]);
        c.sub_sum[k] = j == 0 ? e : c.sub_sum[k] + e;
        c.x_in[k] = e;
      }
      if (j == n - 1) last();
    }
    // the next pass reads the sampled embedding (the tail: the next input)
    if (j + 1 < n || tail != nullptr) qtts_phase_barrier(p);
  }
}

// ---------------------------------------------------------------------------
// B rows against one weight stream (K4, K5)
// ---------------------------------------------------------------------------
//
// A batched launch streams exactly the stages K1 (K2) streams on its plan;
// the batch adds arithmetic per byte.  Each block holds its group's rows'
// GEMV inputs in the union region as bf16 (exactly the values
// qtts_prologue_vpt rounds to), row by row, K values each.  A stage is cut
// into units of R stage rows x BT batch rows, dealt to the warps in turn; a
// unit walks the whole input in K1's lane order (lane l takes the 16
// columns at l * 16 + t * 512 in pass t, fmaf in element order), converting
// each weight once for its BT rows and each input value once for its R rows,
// then runs K1's xor butterfly, scale product and residual sum per (row,
// batch row).  So every (n, b) output is K1's on row b, bit for bit, and a
// lane holds R x BT <= 32 accumulators whatever B is.

// The group rows [b0, b0 + nb) of this block (all B rows with one group).
static __device__ __forceinline__ void qtts_group_rows(const QttsPlan& p, int& b0, int& nb) {
  const int g = qtts_group_of(p, blockIdx.x);
  b0 = g * p.batch / p.groups;
  nb = (g + 1) * p.batch / p.groups - b0;
}

// The column of act's swizzled row layout that holds input column k: each
// 512-column pass stores lane l's second 8 columns 256 after its first, so
// that the 32 lanes' 16-byte loads of one half fall on distinct banks.
// Rows are kp = K rounded up to 512 apart.
static __device__ __forceinline__ int qtts_act_col(int k) {
  return (k & ~511) | (((k >> 3) & 1) << 8) | (((k >> 4) & 31) << 3) | (k & 7);
}

// qtts_bstage_unit at int4 units, defined in fused_int4.cu beside
// qtts_stage_rows4, whose sum order it keeps per (row, batch row).
template <bool ACCUM, int R, int BT>
static __device__ __forceinline__ void qtts_bstage_unit4(const unsigned char* ws, const float* ss,
                                                         const __nv_bfloat16* act, int K,
                                                         float* out, int ldo, int n0, int r0,
                                                         int b0, int nb, int lane);

// Unit (stage rows [r0, r0 + R), group rows [b0, b0 + BT) of nb) of a stage
// whose first row is n0: `out` rows are `ldo` floats apart, row 0 the
// group's first.  Batch rows past nb compute on row nb - 1 and store nothing.
// Every array index below is a compile-time constant once the loops unroll.
// WT: the unit type (a bf16 half row is one 16-byte load, an int8 one 8
// bytes; int4 units take qtts_bstage_unit4: group scales, no row scale).
template <bool ACCUM, int R, int BT, typename WT>
static __device__ __forceinline__ void qtts_bstage_unit(const WT* ws, const float* ss,
                                                        const __nv_bfloat16* act, int K,
                                                        float* out, int ldo, int n0, int r0,
                                                        int b0, int nb, int lane) {
  if constexpr (qtts_int4_units<WT>) {
    qtts_bstage_unit4<ACCUM, R, BT>(reinterpret_cast<const unsigned char*>(ws), ss, act, K, out,
                                    ldo, n0, r0, b0, nb, lane);
    return;
  }
  // lane l stores pair l = (stage row r0 + l / BT, batch row b0 + l % BT)
  const int pr = lane / BT, pb = lane % BT;
  const bool stores = lane < R * BT && b0 + pb < nb;
  float* dst = out + (size_t)(b0 + pb) * ldo + n0 + r0 + pr;
  float res = 0.f;
  if (ACCUM && stores) res = *dst;
  const int kp = (K + 511) & ~511;
  const WT* wrow = ws + (size_t)r0 * K + lane * 16;
  const __nv_bfloat16* arow = act + lane * 8;
  float acc[R][BT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[r][b] = 0.f;
  }
  for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
    const int t0 = k0 - lane * 16;  // the pass's first column
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t wv[R][2 * sizeof(WT)];  // the rows' 8 weights of this half
#pragma unroll
      for (int r = 0; r < R; ++r) qtts_unit_load<WT, 8>(wrow + (size_t)r * K + t0 + 8 * h, wv[r]);
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
        for (int r = 0; r < R; ++r) wf[r] = qtts_unit_value<WT>(wv[r], e);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const uint32_t word = av[b][e >> 1];
          const float hv = __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][b] = fmaf(hv, wf[r], acc[r][b]);
        }
      }
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
  if (stores) {
    const float sv = __fmul_rn(v, ss[r0 + pr]);
    *dst = ACCUM ? __fadd_rn(res, sv) : sv;
  }
}

// The cost of a stage cut into units of R rows x BT batch rows: the slowest
// warp's units, each R * BT multiply-adds, 2R weight and BT input
// conversions per column.
static __device__ __forceinline__ int qtts_unit_cost(int rows, int nb, int R, int BT) {
  const int units = (rows / R) * ((nb + BT - 1) / BT);
  return (units + QTTS_P_WARPS - 1) / QTTS_P_WARPS * (R * BT + 2 * R + BT);
}

// A stage's units dealt to the warps: (R, BT) of {1, 2, 4} x {2, 4, 8} of
// the least qtts_unit_cost (the larger R on a tie).
template <bool ACCUM, typename WT>
static __device__ __forceinline__ void qtts_bstage(const WT* ws, const float* ss,
                                                   const __nv_bfloat16* act, int K, float* out,
                                                   int ldo, int n0, int rows, int nb, int warp,
                                                   int lane) {
  int R = 4, bt = 8, best = qtts_unit_cost(rows, nb, 4, 8);
#pragma unroll
  for (int c = 1; c < 9; ++c) {
    const int r = 4 >> (c / 3), b = 8 >> (c % 3);
    const int cost = qtts_unit_cost(rows, nb, r, b);
    if (cost < best) {
      best = cost;
      R = r;
      bt = b;
    }
  }
  const int tiles = (nb + bt - 1) / bt;
  const int units = (rows / R) * tiles;
  for (int u = warp; u < units; u += QTTS_P_WARPS) {
    const int r0 = (u / tiles) * R, b0 = (u % tiles) * bt;
#define QTTS_UNIT(RR, BB) \
  qtts_bstage_unit<ACCUM, RR, BB, WT>(ws, ss, act, K, out, ldo, n0, r0, b0, nb, lane)
    if (bt == 8) {
      if (R == 4) QTTS_UNIT(4, 8); else if (R == 2) QTTS_UNIT(2, 8); else QTTS_UNIT(1, 8);
    } else if (bt == 4) {
      if (R == 4) QTTS_UNIT(4, 4); else if (R == 2) QTTS_UNIT(2, 4); else QTTS_UNIT(1, 4);
    } else {
      if (R == 4) QTTS_UNIT(4, 2); else if (R == 2) QTTS_UNIT(2, 2); else QTTS_UNIT(1, 2);
    }
#undef QTTS_UNIT
  }
}

// Consumes the block's stages of one GEMV kind for its nb group rows, as
// qtts_ring_gemv does for one row: out[b, n] (+)= scale[n] * sum_k act[b, k]
// * W[n, k], out's rows ldo floats apart from the group's first.
template <bool ACCUM, typename WT = int8_t>
static __device__ __forceinline__ void qtts_ring_bgemv(const QttsPlan& p, const QttsRing& ring,
                                                       QttsSeq& q, int kind, int& stage,
                                                       const __nv_bfloat16* act, int nb,
                                                       float* out, int ldo) {
  qtts_trace_mark(p, 0);
  const QttsKindRows& r = q.kind[kind];
  const int K = r.K, chunks = r.chunks, stage_rows = r.stage_rows, r0 = r.r0, nrows = r.rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = 0; c < chunks; ++c) {
    const int slot = stage % ring.n_slots;
    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);
    if (c == 0) qtts_trace_mark(p, 1);
    const int rows = min(stage_rows, nrows - c * stage_rows);
    const WT* ws = reinterpret_cast<const WT*>(ring.slots + (size_t)slot * ring.slot_bytes);
    const float* ss = ring.scales + (size_t)slot * ring.slot_rows;
    qtts_bstage<ACCUM, WT>(ws, ss, act, K, out, ldo, r0 + c * stage_rows, rows, nb, warp, lane);
    __syncthreads();  // every warp is done with the slot
    if (c + 1 == chunks) qtts_trace_mark(p, 2);
    if (threadIdx.x == 0) qtts_ring_issue(ring, q);
    ++stage;
  }
}

// The batched prologue's block-reduction scratch: per-warp partials and each
// row's RMS factor for up to 8 rows, by chunk parity.  One instance per
// kernel (a __shared__ array per template instance would not fit the
// plan's static reserve).
struct QttsBRed {
  float part[2][8][QTTS_P_WARPS];
  float rs[2][8];
};
static __device__ __forceinline__ QttsBRed& qtts_bred() {
  __shared__ QttsBRed red;
  return red;
}

// The GEMV inputs of nb rows (`ld` floats apart in `in`) into act [nb, kp]
// bf16 (qtts_act_col's layout), IN_MODE NORM or PLAIN: row b's values are
// qtts_prologue_vpt's on row b (the same partition of K over the 256
// threads, the same expressions, qtts_block_reduce's tree), CB rows at a
// time with every load issued before its arithmetic and the CB rows'
// reductions sharing one pair of block barriers.
template <int IN_MODE, int VPT>
static __device__ __forceinline__ void qtts_bprologue_vpt(const float* in, int ld,
                                                          const float* __restrict__ norm_w,
                                                          float eps, int K, int nb,
                                                          __nv_bfloat16* act) {
  static_assert(IN_MODE != QTTS_IN_SILU, "the silu input is qtts_silu_rows'");
  constexpr int CB0 = 48 / VPT;
  constexpr int CB = CB0 < 1 ? 1 : (CB0 > 8 ? 8 : CB0);  // rows per chunk: 24 to 48 loads in flight
  QttsBRed& red = qtts_bred();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kp = (K + 511) & ~511;  // act's row stride
  float nw[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int k = tid + i * QTTS_P_THREADS;
    nw[i] = IN_MODE == QTTS_IN_NORM && k < K ? norm_w[k] : 0.f;
  }
  for (int c0 = 0, par = 0; c0 < nb; c0 += CB, par ^= 1) {
    float a[CB][VPT];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int k = tid + i * QTTS_P_THREADS;
        a[c][i] = c0 + c < nb && k < K ? in[(size_t)(c0 + c) * ld + k] : 0.f;
      }
    }
    float r[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) r[c] = 0.f;
    if (IN_MODE == QTTS_IN_NORM) {
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          if (tid + i * QTTS_P_THREADS < K) {
            const float v = a[c][i];
            ss += v * v;
          }
        }
        ss = qtts_warp_reduce(ss, QttsSumF());
        if (lane == 0) red.part[par][c][warp] = ss;
      }
      __syncthreads();
      // qtts_block_reduce's second level, one warp per row
      for (int c = warp; c < CB; c += QTTS_P_WARPS) {
        float t = lane < QTTS_P_WARPS ? red.part[par][c][lane] : QttsSumF::identity();
        t = qtts_warp_reduce(t, QttsSumF());
        if (lane == 0) red.rs[par][c] = rsqrtf(t / (float)K + eps);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < CB; ++c) r[c] = red.rs[par][c];
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c0 + c < nb) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const int k = tid + i * QTTS_P_THREADS;
          if (k < K) {
            const float v = IN_MODE == QTTS_IN_NORM ? (a[c][i] * r[c]) * nw[i] : a[c][i];
            act[(size_t)(c0 + c) * kp + qtts_act_col(k)] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
  __syncthreads();
}

// The batched GEMV input (NORM or PLAIN) of K <= QTTS_P_MAX_K, dispatched as
// qtts_prologue.
template <int IN_MODE>
static __device__ __forceinline__ void qtts_bprologue(const float* in, int ld,
                                                      const float* __restrict__ norm_w, float eps,
                                                      int K, int nb, __nv_bfloat16* act) {
  if (K <= 4 * QTTS_P_THREADS) {
    qtts_bprologue_vpt<IN_MODE, 4>(in, ld, norm_w, eps, K, nb, act);
  } else if (K <= 8 * QTTS_P_THREADS) {
    qtts_bprologue_vpt<IN_MODE, 8>(in, ld, norm_w, eps, K, nb, act);
  } else if (K <= 12 * QTTS_P_THREADS) {
    qtts_bprologue_vpt<IN_MODE, 12>(in, ld, norm_w, eps, K, nb, act);
  } else {
    qtts_bprologue_vpt<IN_MODE, 24>(in, ld, norm_w, eps, K, nb, act);
  }
}

// The rows' positions of a batched step, read once per launch.
static __device__ __forceinline__ int* qtts_brow_pos() {
  __shared__ int pos[QTTS_MAX_BATCH];
  return pos;
}

// The down projection's input, silu(gate) * up of every row, computed once
// over the grid (qtts_prologue_vpt's expression) into hb [B, kp] bf16 in
// act's layout, where each block's rows are then one bulk copy; the proxy
// fence orders these stores before the copies that read them.
static __device__ __forceinline__ void qtts_silu_rows(const float* gu, int I, int B,
                                                      __nv_bfloat16* hb) {
  const int kp = (I + 511) & ~511;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < B * I; e += gridDim.x * blockDim.x) {
    const int b = e / I, k = e - b * I;
    const float g = gu[(size_t)b * 2 * I + k];
    const float up = gu[(size_t)b * 2 * I + I + k];
    const float v = g * (1.f / (1.f + expf(-g))) * up;
    hb[(size_t)b * kp + qtts_act_col(k)] = __float2bfloat16_rn(v);
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// The mbarrier of the batched inputs' bulk copies (one per kernel).
static __device__ __forceinline__ uint64_t* qtts_act_bar() {
  __shared__ __align__(8) uint64_t bar;
  return &bar;
}

// `bytes` (a multiple of 16) of device memory into act by one bulk copy of
// thread 0; every thread returns once it has landed.  `loads` counts the
// copies since the barrier's init (its phase parity).
static __device__ __forceinline__ void qtts_act_load(const void* src, uint32_t bytes, void* act,
                                                     int& loads) {
  uint64_t* bar = qtts_act_bar();
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    qtts_mbar_expect_tx(bar, bytes);
    qtts_bulk_load(act, src, bytes, bar);
  }
  qtts_mbar_wait(bar, (uint32_t)(loads++ & 1));
}

// Attention work item `it` of a batched layer: the rows' items in row order,
// row b's nk x (pos_b / CHUNK + 1) items (kv head fastest, then split), so
// that only items with slots to attend are dealt.  False past the last.
// ops/persistent.py's attention_items models this dealing.
struct QttsBItem {
  int b, h, split, pos;
};
static __device__ __forceinline__ bool qtts_bitem(int it, int B, int nk, QttsBItem& item) {
  const int* rows = qtts_brow_pos();
  for (int b = 0; b < B; ++b) {
    const int pos = rows[b];
    const int n = nk * (pos / QTTS_ATTN_CHUNK + 1);
    if (it < n) {
      item = QttsBItem{b, it % nk, it / nk, pos};
      return true;
    }
    it -= n;
  }
  return false;
}

// One decode step of B rows through every layer, as qtts_step_phases' grid
// phases: row b at position min(pos_dev[b], T - 1), or every row at
// pos_host without pos_dev.  The cache is [L, B, nk, T, D]; x_in [B, H] is
// read by layer 0's qkv prologue and copied to x there.  Attention items run
// over each row's (kv head, split) up to the row's position; the item that
// takes the last ticket of a (row, kv head) merges that row's splits, as
// many as its own position has.
//
// VERIFY (K6): the B rows are S candidates of each of B / S streams, row r
// on cache row r / S at position qtts_row_pos(pos_dev, pos_host, r, T, S)
// (the stream's start clamped into [0, T - S], plus r % S); the cache is
// [L, B / S, nk, T, D].  Candidate s attends slots start .. start + s, which
// rows of other blocks write, so a slot-write phase after the qkv product
// stores every row's new k and v (qtts_kv_write_body: the launch-per-op
// pass's slot-write kernel, op for op) and a grid barrier orders it before
// the attention, whose items then read every slot from the cache: seven
// grid barriers per layer.  K4 is this map at S = 1.  WT: w's unit type.
// ks, vs: an int8 cache's [L, B / S, nk, T] scales (CT = int8_t), which the
// slot-write phase and the items update in place with the cache.
// cache_rows: the rows of the caches' layers (the layer stride) where the
// launch takes a slice of them (a call past QTTS_MAX_BATCH rows split into
// launches: kc, vc, ks and vs then point at the launch's first cache row);
// 0: B / S, the whole cache.
template <typename CT, bool VERIFY = false, typename WT = int8_t>
static __device__ void qtts_bstep_phases(const QttsStepWeights& w, const QttsBatchScratch& s,
                                         const QttsPlan& p, const QttsRing& ring, QttsSeq& q,
                                         int& stage, const float* x_in, float* x, CT* kc, CT* vc,
                                         int B, int T, const int64_t* pos_dev, int pos_host,
                                         unsigned char* un, bool last_barrier, int S_arg = 1,
                                         float* ks = nullptr, float* vs = nullptr,
                                         int cache_rows = 0) {
  const int S = VERIFY ? S_arg : 1;  // K4 and K5: the candidates' map folds away
  const int H = w.H, I = w.I, D = w.D, nq = w.nq, nk = w.nk;
  const int qd = nq * D, A = qd + 2 * nk * D;
  const int tid = threadIdx.x;
  if (tid < B) qtts_brow_pos()[tid] = qtts_row_pos(pos_dev, pos_host, tid, T, S);
  if (tid == 0) {
    qtts_mbar_init(qtts_act_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int act_loads = 0;
  const int kp_i = (I + 511) & ~511;  // the silu input's row stride
  const int half = tid / QTTS_ATTN_D, t = tid % QTTS_ATTN_D;
  const QttsNamedSync hsync{1 + half};
  const int lane0 = 2 * blockIdx.x + half, lanes = 2 * gridDim.x;  // attention item dealing
  const size_t cache_row = (size_t)nk * T * D;  // one row of one layer
  const size_t scale_row = (size_t)nk * T;  // its int8 scales
  const size_t part_row = (size_t)nq * s.max_splits * (D + 2);
  int gb0, nb;
  qtts_group_rows(p, gb0, nb);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(un);
  QttsAttnSmem* am = reinterpret_cast<QttsAttnSmem*>(un);
  const size_t layer_rows = cache_rows > 0 ? (size_t)cache_rows : (size_t)(B / S);
  for (int l = 0; l < w.L; ++l) {
    CT* kl = kc + (size_t)l * layer_rows * cache_row;
    CT* vl = vc + (size_t)l * layer_rows * cache_row;
    float* ksl = qtts_int8_cache<CT> ? ks + (size_t)l * layer_rows * scale_row : nullptr;
    float* vsl = qtts_int8_cache<CT> ? vs + (size_t)l * layer_rows * scale_row : nullptr;
    // row b's scales (null on a bf16 or float32 cache)
    auto srow = [&](float* base, int b) {
      return qtts_int8_cache<CT> ? base + (size_t)(b / S) * scale_row : nullptr;
    };
    // qkv = bf16(RMSNorm(x) * attn_norm) @ Wqkv * scale
    qtts_bprologue<QTTS_IN_NORM>((l == 0 ? x_in : x) + (size_t)gb0 * H, H,
                                 w.attn_norm + (size_t)l * H, w.eps, H, nb, act);
    if (l == 0 && x_in != x) {
      for (int k = blockIdx.x * blockDim.x + tid; k < B * H; k += gridDim.x * blockDim.x) {
        x[k] = x_in[k];
      }
    }
    // this layer's cached k / v rows of the half's attention items, into L2
    // (after the prologue's loads: B rows' caches can queue up the memory
    // system for microseconds)
    QttsBItem item;
    for (int it = lane0; qtts_bitem(it, B, nk, item); it += lanes) {
      qtts_attn_prefetch(kl + item.b / S * cache_row, vl + item.b / S * cache_row, item.h,
                         item.split, T, item.pos, t, srow(ksl, item.b), srow(vsl, item.b));
    }
    qtts_ring_bgemv<false, WT>(p, ring, q, QTTS_KIND_QKV, stage, act, nb, s.qkv + (size_t)gb0 * A,
                               A);
    qtts_phase_barrier(p);
    if constexpr (VERIFY) {
      // every row's new k and v into its slot, one (row, kv head) per item
      for (int it = lane0; it < B * nk; it += lanes) {
        hsync();  // the half's previous item is done with its shared memory
        if (p.write_stall_ns > 0) {
          const uint64_t t0 = qtts_globaltimer();
          while (qtts_globaltimer() - t0 < (uint64_t)p.write_stall_ns) {
          }
        }
        qtts_kv_write_body<CT>(am[half], hsync, t, it % nk, it / nk, s.qkv, A,
                               w.k_norm + (size_t)l * D, w.inv_freq, kl, vl, cache_row, nq, nk, T,
                               pos_dev, pos_host, S, w.eps, ksl, vsl);
      }
      qtts_phase_barrier(p);  // the new slots, before any candidate attends them
    }
    // the split attention: K1's items on (row, kv head, split), two per block
    for (int it = lane0; qtts_bitem(it, B, nk, item); it += lanes) {
      const int b = item.b, h = item.h, pos = item.pos;
      const int n_splits = pos / QTTS_ATTN_CHUNK + 1;  // the row's own splits
      float* part = s.part + b * part_row;
      float* attn = s.attn + (size_t)b * qd;
      hsync();  // the half's previous item is done with its shared memory
      qtts_attn_item_any<CT, !VERIFY>(am[half], hsync, t, h, item.split, s.qkv + (size_t)b * A,
                                      w.q_norm + (size_t)l * D, w.k_norm + (size_t)l * D,
                                      w.inv_freq, kl + b / S * cache_row, vl + b / S * cache_row,
                                      part, n_splits == 1 ? attn : nullptr, nq, nk, T, pos,
                                      s.max_splits, w.eps, w.attn_scale, srow(ksl, b),
                                      srow(vsl, b));
      if (n_splits == 1) continue;
      __threadfence();  // the item's partials, before its ticket
      hsync();
      uint32_t* tk = p.tickets + (size_t)b * nk + h;  // one ticket per (row, kv head)
      int* ticket = reinterpret_cast<int*>(am[half].red);  // free once the item is done
      if (t == 0) *ticket = (int)atomicAdd(tk, 1u);
      hsync();
      if (*ticket == n_splits - 1) {
        __threadfence();
        const int g = nq / nk;
        for (int gi = 0; gi < g; ++gi) {
          qtts_attn_combine_l2(t, h * g + gi, part, attn, s.max_splits, pos);
        }
        if (t == 0) *tk = 0u;  // every split of the row has taken its ticket
      }
    }
    qtts_phase_barrier(p);
    // x += bf16(attn) @ Wo * scale
    qtts_bprologue<QTTS_IN_PLAIN>(s.attn + (size_t)gb0 * qd, qd, nullptr, 0.f, qd, nb, act);
    qtts_ring_bgemv<true, WT>(p, ring, q, QTTS_KIND_O, stage, act, nb, x + (size_t)gb0 * H, H);
    qtts_phase_barrier(p);
    // gu = bf16(RMSNorm(x) * mlp_norm) @ Wgu * scale
    qtts_bprologue<QTTS_IN_NORM>(x + (size_t)gb0 * H, H, w.mlp_norm + (size_t)l * H, w.eps, H, nb,
                                 act);
    qtts_ring_bgemv<false, WT>(p, ring, q, QTTS_KIND_GU, stage, act, nb,
                               s.gu + (size_t)gb0 * 2 * I, 2 * I);
    qtts_phase_barrier(p);
    // x += bf16(silu(gate) * up) @ Wd * scale, the input made once over the
    // grid: every block would otherwise read its rows' B x 2I floats
    qtts_silu_rows(s.gu, I, B, s.hb);
    qtts_phase_barrier(p);
    qtts_act_load(s.hb + (size_t)gb0 * kp_i, (uint32_t)(2 * nb * kp_i), act, act_loads);
    qtts_ring_bgemv<true, WT>(p, ring, q, QTTS_KIND_DOWN, stage, act, nb, x + (size_t)gb0 * H, H);
    if (l + 1 < w.L || last_barrier) qtts_phase_barrier(p);
  }
}

// ---------------------------------------------------------------------------
// The cooperative launch
// ---------------------------------------------------------------------------

// The plan's constraints on weight set `set`: the transformer w and V head
// rows (0 without heads) of head_esize bytes per weight (0: the trunk's
// unit type, int8 beside int4 units).
static inline bool qtts_plan_set_ok(const QttsPlan& p, int set, const QttsStepWeights& w, int V,
                                    int head_esize = 0) {
  const int qd = w.nq * w.D;
  const int K[QTTS_KINDS] = {w.H, qd, w.H, w.I, w.H};
  const int g = w.nq / w.nk;
  if (g != 1 && g != 2 && g != 4 && g != 8) return false;
  if (w.H > QTTS_P_MAX_K || w.I > QTTS_P_MAX_K || qd > QTTS_P_MAX_K ||
      w.nk > QTTS_P_MAX_KV_HEADS || p.n_tickets < p.batch * w.nk) {
    return false;
  }
  if (w.unit_type < QTTS_UNIT_INT8 || w.unit_type > QTTS_UNIT_INT4) return false;
  const int head_b = head_esize > 0 ? head_esize : w.unit_type == QTTS_UNIT_BF16 ? 2 : 1;
  for (int k = 0; k < QTTS_KINDS; ++k) {
    if (k == QTTS_KIND_HEAD && V == 0) continue;
    const bool head = k == QTTS_KIND_HEAD;
    const int r = p.stage_rows[set * QTTS_KINDS + k];
    const size_t row_bytes = head ? (size_t)head_b * K[k] : qtts_row_bytes(w.unit_type, K[k]);
    const int sfloats = head ? 1 : qtts_row_scales(w.unit_type, K[k]);
    if (K[k] % 16 || r < 4 || r % 4 || r > QTTS_P_MAX_STAGE_ROWS || r * sfloats > p.slot_rows ||
        (size_t)r * row_bytes > (size_t)p.slot_bytes ||
        (!head && w.unit_type == QTTS_UNIT_INT4 && K[k] % 256)) {
      return false;
    }
  }
  return true;
}

// The plan's scalar constraints against the transformer it drives (V: the
// head rows, 0 without heads; B: the rows of a batched launch, 0 for K1, K2,
// K3 and K7, whose GEMV input is MAX_K floats).  A two-set plan (K7) also
// drives w2 with V2 head rows.
static inline bool qtts_plan_ok(const QttsPlan& p, const QttsStepWeights& w, int V, int B = 0,
                                const QttsStepWeights* w2 = nullptr, int V2 = 0,
                                int head_esize = 0) {
  if (p.grid < 1 || p.n_slots < 1 || p.slot_bytes % 16 || p.slot_rows % 4 || p.union_bytes % 128) {
    return false;
  }
  if (p.batch != (B > 0 ? B : 1) || p.groups < 1 || p.groups > p.batch || p.groups > p.grid ||
      p.n_tickets > QTTS_P_MAX_TICKETS || p.tickets == nullptr) {
    return false;
  }
  if (p.n_sets != (w2 != nullptr ? 2 : 1) || (w2 != nullptr && B > 0) ||
      !qtts_plan_set_ok(p, 0, w, V, head_esize) ||
      (w2 != nullptr && !qtts_plan_set_ok(p, 1, *w2, V2))) {
    return false;
  }
  // the union region: the GEMV input (MAX_K floats, or each of a group's
  // rows in bf16), two attention items, or the sampler's scratch
  const int qd = w.nq * w.D;
  const int k_hq = w.H > qd ? w.H : qd;
  const int k_wide = k_hq > w.I ? k_hq : w.I;  // the widest GEMV input
  const int k_act = (k_wide + 511) & ~511;      // act's row stride
  size_t need = B > 0 ? (size_t)2 * k_act * ((B + p.groups - 1) / p.groups)
                      : 4 * (size_t)QTTS_P_MAX_K;
  need = 2 * sizeof(QttsAttnSmem) > need ? 2 * sizeof(QttsAttnSmem) : need;
  need = sizeof(QttsSampleSmem) > need ? sizeof(QttsSampleSmem) : need;
  return (size_t)p.union_bytes >= need && qtts_plan_layout(p).total == (size_t)p.smem_bytes;
}

// Launches `kernel` on `grid` blocks with `smem` bytes of dynamic shared
// memory and one argument struct, after checking once per (kernel, shared
// memory size) that the grid can be co-resident: a grid that cannot fails
// with cudaErrorCooperativeLaunchTooLarge.  A kernel's dynamic shared-memory
// attribute is set again whenever a launch asks for another size than the
// last (the 0.6B and 1.7B plans differ, and a launch past the attribute
// fails); the lock is held through the launch, so that no other thread's
// plan changes the attribute in between.
template <typename Args>
static int qtts_launch_persistent(void (*kernel)(Args), const Args& a, int grid, int smem,
                                  cudaStream_t st) {
  struct Seen {
    const void* fn;
    int smem, max_grid;
  };
  static std::mutex mu;
  static Seen seen[16];
  static int n_seen = 0;
  static Seen allowed[8];  // the size each kernel's attribute allows now
  static int n_allowed = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  int at = 0;
  while (at < n_allowed && allowed[at].fn != fn) ++at;
  if (at == n_allowed || allowed[at].smem != smem) {
    QTTS_TRY(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (at < 8) {
      allowed[at] = Seen{fn, smem, 0};
      if (at == n_allowed) ++n_allowed;
    }
  }
  int max_grid = 0;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].fn == fn && seen[i].smem == smem) max_grid = seen[i].max_grid;
  }
  if (max_grid == 0) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    QTTS_TRY(cudaGetDevice(&dev));
    QTTS_TRY(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
    if (!coop) return (int)cudaErrorNotSupported;
    QTTS_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    QTTS_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, QTTS_P_THREADS, smem));
    max_grid = sms * per_sm;
    if (max_grid == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (n_seen < 16) seen[n_seen++] = Seen{fn, smem, max_grid};
  }
  if (grid > max_grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {const_cast<Args*>(&a)};
  QTTS_TRY(cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(QTTS_P_THREADS), params,
                                       (size_t)smem, st));
  return (int)cudaGetLastError();
}

// The launch on a plan's grid and shared memory.
template <typename Args>
static int qtts_launch_persistent(void (*kernel)(Args), const Args& a, const QttsPlan& p,
                                  cudaStream_t st) {
  return qtts_launch_persistent(kernel, a, p.grid, p.smem_bytes, st);
}

// ---------------------------------------------------------------------------
// The B=1 step (K1) and chain (K2, K3) kernels: fused_step.cu and
// fused_mtp.cu instantiate them at int8 and bf16 units, fused_int4.cu at
// int4 units (a translation unit of its own, built beside the others)
// ---------------------------------------------------------------------------

// The persistent step's one argument (travels by value).
struct QttsStepLaunch {
  QttsStepWeights w;
  QttsStepScratch s;
  QttsPlan p;
  const float* x_in;
  float* x;
  void* k_cache;
  void* v_cache;
  float* k_scale;  // [L, nk, T] scales of an int8 cache (CT = int8_t), else null
  float* v_scale;
  int32_t T, pos;
};

// The persistent chain's one argument (travels by value).
struct QttsChainLaunch {
  QttsStepWeights w;
  QttsStepScratch s;
  QttsPlan p;
  QttsChainArgs c;
};

// The persistent batched step's one argument (K4; travels by value).
struct QttsBStepLaunch {
  QttsStepWeights w;
  QttsBatchScratch s;
  QttsPlan p;
  const float* x_in;
  float* x;
  void* k_cache;
  void* v_cache;
  float* k_scale;  // [L, B, nk, T] scales of an int8 cache (CT = int8_t), else null
  float* v_scale;
  const int64_t* pos_dev;
  int32_t B, T, pos_host;
  int32_t cache_rows;  // the caches' rows per layer (k_cache at the launch's first row)
};

// The persistent verify pass's one argument (K6; travels by value).
struct QttsVStepLaunch {
  QttsStepWeights w;
  QttsBatchScratch s;
  QttsPlan p;
  const float* x_in;
  float* x;
  void* k_cache;
  void* v_cache;
  float* k_scale;  // [L, B, nk, T] scales of an int8 cache (CT = int8_t), else null
  float* v_scale;
  const int64_t* pos_dev;
  int32_t B, S, T, pos_host;
  int32_t cache_rows;  // the caches' streams per layer (k_cache at the launch's first stream)
};

// The persistent batched chain's one argument (K5; travels by value).
struct QttsBChainLaunch {
  QttsStepWeights w;
  QttsBatchScratch s;
  QttsPlan p;
  QttsChainBatchArgs c;
};

namespace {

// CT: the cache type; WT: the units' type.
template <typename CT, typename WT>
__global__ void __launch_bounds__(QTTS_P_THREADS, 1)
step_kernel(const __grid_constant__ QttsStepLaunch a) {
  extern __shared__ __align__(128) unsigned char qtts_ring_smem[];
  __shared__ QttsSeq seq;
  QttsRing ring;
  qtts_ring_start(ring, seq, qtts_ring_smem, a.p, a.w, nullptr, nullptr, 0, 0);
  int stage = 0;
  qtts_step_phases<CT, WT>(a.w, a.s, a.p, ring, seq, 0, stage, a.x_in, a.x,
                           static_cast<CT*>(a.k_cache), static_cast<CT*>(a.v_cache), a.T, a.pos,
                           qtts_ring_smem, false, a.k_scale, a.v_scale);
  qtts_trace_end(a.p);
}

// CT: the chain's cache type; WT: the trunk's units; HT: the heads' (int8 or
// bf16, whatever the trunk's).
template <typename CT, typename WT, typename HT>
__global__ void __launch_bounds__(QTTS_P_THREADS, 1)
chain_kernel(const __grid_constant__ QttsChainLaunch a) {
  extern __shared__ __align__(128) unsigned char qtts_ring_smem[];
  __shared__ QttsSeq seq;
  QttsRing ring;
  const QttsChainArgs& c = a.c;
  qtts_ring_start(ring, seq, qtts_ring_smem, a.p, a.w, c.heads, c.head_scales, c.n, c.V,
                  c.heads_bf16 ? 2 : 1);
  int stage = 0;
  qtts_chain_phases<CT, WT, CT, HT>(a.w, a.s, a.p, ring, seq, 0, stage, c, qtts_ring_smem,
                                    [] {});
  qtts_trace_end(a.p);
}

// The chain of heads type HT on a float32 or bf16 cache.
template <typename WT, typename HT>
int qtts_launch_chain_cache(const QttsChainLaunch& l, cudaStream_t st) {
  return l.c.cache_bf16
             ? qtts_launch_persistent(chain_kernel<__nv_bfloat16, WT, HT>, l, l.p, st)
             : qtts_launch_persistent(chain_kernel<float, WT, HT>, l, l.p, st);
}

// The chain of trunk type WT with int8 or bf16 heads.
template <typename WT>
int qtts_launch_chain_heads(const QttsChainLaunch& l, cudaStream_t st) {
  return l.c.heads_bf16 ? qtts_launch_chain_cache<WT, __nv_bfloat16>(l, st)
                        : qtts_launch_chain_cache<WT, int8_t>(l, st);
}

// K4 (fused_step_batched.cu; int4 units: fused_int4.cu).  CT: the cache
// type; WT: the units' type.
template <typename CT, typename WT>
__global__ void __launch_bounds__(QTTS_P_THREADS, 1)
bstep_kernel(const __grid_constant__ QttsBStepLaunch a) {
  extern __shared__ __align__(128) unsigned char qtts_ring_smem[];
  __shared__ QttsSeq seq;
  QttsRing ring;
  qtts_ring_start(ring, seq, qtts_ring_smem, a.p, a.w, nullptr, nullptr, 0, 0);
  int stage = 0;
  qtts_bstep_phases<CT, false, WT>(a.w, a.s, a.p, ring, seq, stage, a.x_in, a.x,
                                   static_cast<CT*>(a.k_cache), static_cast<CT*>(a.v_cache), a.B,
                                   a.T, a.pos_dev, a.pos_host, qtts_ring_smem, false, 1,
                                   a.k_scale, a.v_scale, a.cache_rows);
  qtts_trace_end(a.p);
}

// The batched step on a float32 (cache 0), bf16 (1) or int8 (2) cache.
template <typename WT>
int qtts_launch_bstep_cache(const QttsBStepLaunch& a, int cache, cudaStream_t st) {
  switch (cache) {
    case 0: return qtts_launch_persistent(bstep_kernel<float, WT>, a, a.p, st);
    case 1: return qtts_launch_persistent(bstep_kernel<__nv_bfloat16, WT>, a, a.p, st);
    case 2: return qtts_launch_persistent(bstep_kernel<int8_t, WT>, a, a.p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6 (fused_verify.cu; int4 units: fused_int4.cu): K4's phases in their
// VERIFY mode on B x S rows.
template <typename CT, typename WT>
__global__ void __launch_bounds__(QTTS_P_THREADS, 1)
vstep_kernel(const __grid_constant__ QttsVStepLaunch a) {
  extern __shared__ __align__(128) unsigned char qtts_ring_smem[];
  __shared__ QttsSeq seq;
  QttsRing ring;
  qtts_ring_start(ring, seq, qtts_ring_smem, a.p, a.w, nullptr, nullptr, 0, 0);
  int stage = 0;
  qtts_bstep_phases<CT, true, WT>(a.w, a.s, a.p, ring, seq, stage, a.x_in, a.x,
                                  static_cast<CT*>(a.k_cache), static_cast<CT*>(a.v_cache),
                                  a.B * a.S, a.T, a.pos_dev, a.pos_host, qtts_ring_smem, false,
                                  a.S, a.k_scale, a.v_scale, a.cache_rows);
  qtts_trace_end(a.p);
}

// The verify pass on a float32 (cache 0), bf16 (1) or int8 (2) cache.
template <typename WT>
int qtts_launch_vstep_cache(const QttsVStepLaunch& a, int cache, cudaStream_t st) {
  switch (cache) {
    case 0: return qtts_launch_persistent(vstep_kernel<float, WT>, a, a.p, st);
    case 1: return qtts_launch_persistent(vstep_kernel<__nv_bfloat16, WT>, a, a.p, st);
    case 2: return qtts_launch_persistent(vstep_kernel<int8_t, WT>, a, a.p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5 (fused_mtp_batched.cu; int4 trunks: fused_int4.cu).  CT: the chain's
// cache type; WT: the trunk's units; HT: the heads' (int8 or bf16, whatever
// the trunk's).  Two prefix passes, then per step the heads' B-row GEMV on
// the ring, block b's draw of row b, and (but after the last) a trunk pass.
template <typename CT, typename WT, typename HT>
__global__ void __launch_bounds__(QTTS_P_THREADS, 1)
bchain_kernel(const __grid_constant__ QttsBChainLaunch a) {
  extern __shared__ __align__(128) unsigned char qtts_ring_smem[];
  unsigned char* smem = qtts_ring_smem;
  __shared__ QttsSeq seq;
  QttsRing ring;
  const QttsChainBatchArgs& c = a.c;
  const int H = a.w.H, V = c.V, n = c.n, T = n + 2, B = c.B;
  qtts_ring_start(ring, seq, smem, a.p, a.w, c.heads, c.head_scales, n, V, sizeof(HT));
  int stage = 0;
  int gb0, nb;
  qtts_group_rows(a.p, gb0, nb);
  CT* kc = static_cast<CT*>(c.k_cache);
  CT* vc = static_cast<CT*>(c.v_cache);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  qtts_bstep_phases<CT, false, WT>(a.w, a.s, a.p, ring, seq, stage, c.last_hidden, c.x, kc, vc,
                                   B, T, nullptr, 0, smem, true);
  qtts_bstep_phases<CT, false, WT>(a.w, a.s, a.p, ring, seq, stage, c.code0_embed, c.x, kc, vc,
                                   B, T, nullptr, 1, smem, true);
  for (int j = 0; j < n; ++j) {
    // logits = bf16(RMSNorm(x) * final_norm) @ head_j * scale_j, every row
    qtts_bprologue<QTTS_IN_NORM>(c.x + (size_t)gb0 * H, H, c.final_norm, a.w.eps, H, nb, act);
    qtts_ring_bgemv<false, HT>(a.p, ring, seq, QTTS_KIND_HEAD, stage, act, nb,
                               c.logits + (size_t)gb0 * V, V);
    qtts_phase_barrier(a.p);
    if ((int)blockIdx.x < B) {
      // row b's draw on block b, then its embedding row into sub_sum and
      // the next trunk input
      const int b = blockIdx.x;
      const int sub = qtts_sample_fast(
          c.logits + (size_t)b * V, V, c.noise + j * c.noise_step_stride + b * c.noise_row_stride,
          c.temperature[b], c.top_k[b], c.top_p[b], c.greedy[b],
          *reinterpret_cast<QttsSampleSmem*>(smem), &a.p);
      if (threadIdx.x == 0) c.subcodes[b * n + j] = sub;
      const __nv_bfloat16* table = c.tables + (size_t)j * c.Vt * H + (size_t)sub * H;
      float* sum = c.sub_sum + (size_t)b * H;
      float* x_next = c.x_in + (size_t)b * H;
      for (int k = threadIdx.x; k < H; k += blockDim.x) {
        const float e = __bfloat162float(table[k]);
        sum[k] = j == 0 ? e : sum[k] + e;
        x_next[k] = e;
      }
    }
    if (j + 1 < n) {
      qtts_phase_barrier(a.p);  // the next trunk pass reads the sampled embeddings
      qtts_bstep_phases<CT, false, WT>(a.w, a.s, a.p, ring, seq, stage, c.x_in, c.x, kc, vc, B,
                                       T, nullptr, 2 + j, smem, true);
    }
  }
  qtts_trace_end(a.p);
}

// The batched chain of heads type HT on a float32 or bf16 cache.
template <typename WT, typename HT>
int qtts_launch_bchain_cache(const QttsBChainLaunch& l, cudaStream_t st) {
  return l.c.cache_bf16
             ? qtts_launch_persistent(bchain_kernel<__nv_bfloat16, WT, HT>, l, l.p, st)
             : qtts_launch_persistent(bchain_kernel<float, WT, HT>, l, l.p, st);
}

}  // namespace

// fused_int4.cu: K1 at int4 units (cache: 0 float32, 1 bf16, 2 int8 with
// its scales) and the chain on an int4 trunk, each checked by its entry;
// K4 and K6 at int4 units (the same cache codes) and K5 on an int4 trunk
// (int8 or bf16 heads, a float32 or bf16 cache).
int qtts_launch_step_int4(const QttsStepLaunch& a, int cache, cudaStream_t st);
int qtts_launch_chain_int4(const QttsChainLaunch& a, cudaStream_t st);
int qtts_launch_bstep_int4(const QttsBStepLaunch& a, int cache, cudaStream_t st);
int qtts_launch_vstep_int4(const QttsVStepLaunch& a, int cache, cudaStream_t st);
int qtts_launch_bchain_int4(const QttsBChainLaunch& a, cudaStream_t st);

// Part 1 of fused_step_batched.cu, fused_verify.cu and fused_mtp_batched.cu
// (each source two objects of the parallel build): K4 and K6 at bf16 units,
// K5 with bf16 heads (beside an int8 trunk, and the bf16 trunk's).
int qtts_launch_bstep_bf16(const QttsBStepLaunch& a, int cache, cudaStream_t st);
int qtts_launch_vstep_bf16(const QttsVStepLaunch& a, int cache, cudaStream_t st);
int qtts_launch_bchain_bf16_heads(const QttsBChainLaunch& l, cudaStream_t st);

// The B=1 chain entries of fused_mtp.cu (K2 and its launch-per-op chain),
// which K3's entries (fused_mtp_stream.cu) run on a float32 cache.
extern "C" int qtts_mtp_chain(const QttsStepWeights* w, const QttsStepScratch* s,
                              const QttsPlan* p, const QttsChainArgs* a, void* stream);
extern "C" int qtts_mtp_chain_multi(const QttsStepWeights* w, const QttsStepScratch* s,
                                    const QttsChainArgs* a, void* stream);
