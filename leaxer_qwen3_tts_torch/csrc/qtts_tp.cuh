// Shared declarations and device helpers of the tensor-parallel kernels K9
// (fused_tp.cu: the decode step) and K10 (fused_mtp_tp.cu: the sharded MTP
// chain), both persistent launches on the transport of qtts_stream.cuh.
//
// Ranks.  The ranks placed on one device are block groups of one cooperative
// launch (blocks [r bpr, (r + 1) bpr) are rank rank0 + r), so that every rank
// runs while its peers wait on it; ranks on distinct devices are one launch
// per device and reach each other through peer pointers.  A rank's weights
// are K1's row pack at the shard's widths (nq / tp and nk / tp heads, I / tp,
// o with K = nq D / tp, down with K = I / tp), its plan ops/persistent.py's
// on its bpr blocks: every rank's plan has the same bounds, so block b of
// every rank owns the same output rows of every product.
//
// Barriers.  Between phases a block waits only on its own rank's blocks
// (qtts_group_barrier: cooperative groups' grid barrier on a counter of the
// rank's own).  The exchange below is the only wait across ranks.
//
// The exchange (qtts_tp_allreduce).  After a product whose output the ranks
// sum (K9's o and down, K10's o, down and head rows), block b of rank me
// writes its own rows of its partial into receive slot (site, me) of every
// peer and raises the peer's flag (site, me, b) to this call's generation
// (st.release after a fence; .gpu scope on one device, .sys with
// __threadfence_system across devices), then waits until each peer's flag
// (site, peer, b) on its own device holds the generation (ld.acquire), and
// sums the ranks' rows in the hypercube's order, each add rounded on its
// own: in round r (step 2^r) every value i becomes value i plus value
// i ^ 2^r (tp a power of two), and rank me keeps value me.  a + b == b + a
// bitwise, so every rank holds the same bits: ((v0 + v1) + (v2 + v3)) at
// tp = 4.  This is the order of K10's hypercube exchange before it shared
// this one (rank me received its round-r partner's sum), and the plain
// versions' (ops/fused_tp.py::hypercube_sum).  Each exchange site of a call
// has its own slots and flags, so a slot is written once per call, and the
// generation (a per-call counter, never a reset) keeps the previous call's
// flags from satisfying this call's waits.  A wait that sees no flag within
// the timeout sets the rank's status word, and every later wait of the
// launch returns at once, so a fault ends the launch with a status instead of
// hanging the card; the wrappers zero the words before each launch and raise
// when one was set (ops/fused_tp.py::check_timeouts, read behind the launch).
//
// The structs are mirrored by ctypes.Structure classes in ops/_build.py.
#pragma once

#include "qtts_stream.cuh"

constexpr int QTTS_TP_MAX = 8;     // ranks a launch takes
constexpr int QTTS_TP_MAX_T = 32;  // the chain's cache slots (n + 2)

// What the ranks of a launch reach of rank r (every pointer on r's device).
struct QttsTpLink {
  float* recv;       // [sites, tp, W]: slot (site, src) holds rank src's rows
  uint32_t* flags;   // [sites, tp, bpr]: flag (site, src, b) = the generation once block b
                     // of rank src has written its rows
  uint32_t* bar;     // [1] the rank's group-barrier counter (zeroed once, never reset)
  int32_t* status;   // [1] nonzero: an exchange wait of the rank timed out
};

// One block's place in the exchanges of a launch.
struct QttsTpSync {
  int tp, me, b, bpr, W;
  uint32_t gen;        // this call's flag value
  int stall_ns;        // the checks' stalled sends: odd ranks hold each send back this long
  int64_t timeout_ns;  // a wait's limit
};

template <bool SYS>
static __device__ __forceinline__ void qtts_flag_release(uint32_t* p, uint32_t v) {
  if (SYS) {
    asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  } else {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  }
}

template <bool SYS>
static __device__ __forceinline__ uint32_t qtts_flag_acquire(const uint32_t* p) {
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
static __device__ void qtts_tp_wait(const uint32_t* flag, uint32_t gen, int32_t* status,
                                    int64_t timeout_ns) {
  if (*reinterpret_cast<volatile int32_t*>(status) != 0) return;
  const uint64_t t0 = qtts_globaltimer();
  while (qtts_flag_acquire<SYS>(flag) != gen) {
    if (qtts_globaltimer() - t0 > (uint64_t)timeout_ns) {
      atomicExch(status, 1);
      return;
    }
  }
}

// The barrier of block b of one rank's nblocks blocks: cooperative groups'
// grid barrier on the rank's counter.  Block 0 adds 0x80000000 - (nblocks -
// 1) and every other block 1, so each barrier flips the counter's top bit
// and leaves its low bits as they were; a block leaves once the top bit
// differs from the one its own add saw.  With the plan's trace on it records
// the arrival and the departure as qtts_phase_barrier does.
static __device__ __forceinline__ void qtts_group_barrier(const QttsPlan& p, uint32_t* bar, int b,
                                                          int nblocks) {
  const bool traced = p.trace != nullptr && threadIdx.x == 0;
  if (traced) qtts_trace_at(p, 5 * qtts_barrier_index() + 5);
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t add = b == 0 ? 0x80000000u - (uint32_t)(nblocks - 1) : 1u;
    __threadfence();
    const uint32_t old = atomicAdd(bar, add);
    while (((old ^ *reinterpret_cast<volatile uint32_t*>(bar)) & 0x80000000u) == 0u) {
    }
    __threadfence();
  }
  __syncthreads();
  if (traced) qtts_trace_at(p, 5 * qtts_barrier_index()++ + 6);
}

// The all-reduce of exchange site `site` over the block's rows [r0, r0 + n)
// of the ranks' partials (part: this rank's, [W] floats, the block's rows
// written by the block): combine(row, total) on each row, total the ranks'
// values summed in the hypercube's order.  Every thread of the block calls
// it.
template <bool SYS, typename Combine>
static __device__ __forceinline__ void qtts_tp_allreduce(const QttsTpLink* link,
                                                         const QttsTpSync& s, int site, int r0,
                                                         int n, const float* part,
                                                         Combine combine) {
  const int t = threadIdx.x;
  const QttsTpLink& mine = link[s.me];
  if (s.stall_ns > 0 && (s.me & 1)) {
    if (t == 0) {
      const uint64_t t0 = qtts_globaltimer();
      while (qtts_globaltimer() - t0 < (uint64_t)s.stall_ns) {
      }
    }
    __syncthreads();
  }
  const size_t slot = (size_t)site * s.tp;  // slot (site, src) = slot + src
  for (int peer = 0; peer < s.tp; ++peer) {
    if (peer == s.me) continue;
    float* dst = link[peer].recv + (slot + s.me) * s.W + r0;
    for (int i = t; i < n; i += blockDim.x) dst[i] = part[r0 + i];
  }
  __syncthreads();
  if (t == 0) {
    if (SYS) {
      __threadfence_system();
    } else {
      __threadfence();
    }
    for (int peer = 0; peer < s.tp; ++peer) {
      if (peer != s.me) {
        qtts_flag_release<SYS>(link[peer].flags + (slot + s.me) * s.bpr + s.b, s.gen);
      }
    }
    for (int peer = 0; peer < s.tp; ++peer) {
      if (peer != s.me) {
        qtts_tp_wait<SYS>(mine.flags + (slot + peer) * s.bpr + s.b, s.gen, mine.status,
                          s.timeout_ns);
      }
    }
  }
  __syncthreads();
  for (int i = t; i < n; i += blockDim.x) {
    float v[QTTS_TP_MAX];
#pragma unroll
    for (int src = 0; src < QTTS_TP_MAX; ++src) {
      v[src] = 0.f;
      if (src == s.me) {
        v[src] = part[r0 + i];
      } else if (src < s.tp) {
        const float* p = mine.recv + (slot + src) * s.W + r0 + i;
        v[src] = SYS ? __ldcv(p) : __ldcg(p);
      }
    }
#pragma unroll
    for (int step = 1; step < QTTS_TP_MAX; step <<= 1) {
      if (step < s.tp) {
        float u[QTTS_TP_MAX];
#pragma unroll
        for (int k = 0; k < QTTS_TP_MAX; ++k) u[k] = __fadd_rn(v[k], v[k ^ step]);
#pragma unroll
        for (int k = 0; k < QTTS_TP_MAX; ++k) v[k] = u[k];
      }
    }
    float total = v[0];
#pragma unroll
    for (int k = 1; k < QTTS_TP_MAX; ++k) {
      if (k == s.me) total = v[k];
    }
    combine(r0 + i, total);
  }
}
