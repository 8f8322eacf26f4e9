// Probes P1 and P2: a serial chain of unit matvecs in one persistent kernel.
//
// Replaces tools/a8_probe.py::build (its _kernel; P1) and
// tools/w8a8_probe.py::make_fn (its kernel; P2).  Both ask one question of the
// card: does an int8 x int8 -> int32 product beat the int8 -> bf16 convert
// GEMV that K1 ships, on K1's unit shape ([1, 1024] x [1024, 1024])?
//
// P1 walks `steps` times over n_u units; each unit's output, folded back to
// K wide, is normalised (x * rsqrt(mean(x^2) + 1e-6) over every row) into the
// next unit's input.  Its arms:
//   conv   int8 weights converted in registers, bf16-rounded activations,
//          float32 sums (K1's qtts_gemv_rows), times the column scale;
//   a8     the activation quantised per vector, sx = max(max|x| / 127, 1e-8),
//          q = clip(rint(x * (1 / sx)), -127, 127) (rint: half to even, as
//          jnp.round), int8 x int8 sums on the integer path (__dp4a: four
//          byte products into an int32 per instruction; the single row makes
//          an mma tile 15/16 padding), then acc * (sx * s);
//   bf16   bf16 weights (n_u of them: the JAX probe's U/2, the bytes of U int8
//          units), bf16-rounded activations, float32 sums;
//   w2048  int8 units of 2K rows, the output folded (out[:K] + out[K:]);
//   m8     conv with 8 activation rows sharing each weight read.
// P2 makes `steps` passes over n_u units, each unit's input the previous
// unit's y * 1e-3 + its input; its w8a8 arm quantises without P1's epsilon
// and clip (sa = max|x| * (1/127)).
//
// One unit is one phase of a persistent kernel (cudaLaunchCooperativeKernel),
// ended by a grid barrier (qtts_grid_sync).  Every block recomputes the
// unit's input vector and its reductions in its prologue, as K1's GEMV blocks
// do, then computes its rows.  What bounds it on the H100 (NVIDIA data sheet,
// SXM): the weight bytes, 1 MB per int8 unit (0.31 us at 3.35 TB/s; P1's 72
// MB stack is larger than the 50 MB L2, so each step streams it); the barrier
// per unit, about a microsecond, is of the same order, so the probe times
// transport and barrier together, as the TPU probe timed transport and step.
//
// Two kernels.  probe_kernel (the reference of both probes' ring kernel,
// qtts_unit_probe, run only by the checks): SM count x resident blocks per
// SM, each unit cut into 16-row groups dealt over the grid, the weights
// loaded with __ldg after the unit's barrier.
// ring_kernel (P1 and P2, qtts_unit_probe_ring): one block per SM, each owning a
// fixed range of every unit's rows (tools/unit_probe.py::probe_plan, in
// multiples of four rows); the block's stage sequence is the walk itself,
// stage i its rows of weight unit i % n_u and their scales, one TMA bulk
// copy each into a ring of n_slots shared-memory slots (qtts_stream.cuh's
// mbarrier and bulk-copy helpers).  The weights do not depend on the data, so
// thread 0 keeps n_slots stages in flight across the per-unit grid barrier.
// Each arm's arithmetic is probe_kernel's (the input prologue of the probe,
// its a8 quantisation, the lane order, the conversions, the warp reduction),
// so every output equals it bit for bit.  P2 (R = 1, NW = K) keeps its
// running input xe in the block's input area across the units, as
// probe_kernel's blocks do.

#include "qtts_stream.cuh"

namespace {

enum { ARM_CONV = 0, ARM_A8 = 1, ARM_BF16 = 2, ARM_W2048 = 3, ARM_M8 = 4 };

struct ProbeArgs {
  const void* w;    // [n_u, NW, K] rows: int8, or bf16 for ARM_BF16
  const float* s;   // [n_u, NW] column scales
  const float* x0;  // [R, K] the first unit's input
  float* y;         // [2, R, NW] unit outputs, alternating
  float* out;       // [R, K] P1: the last output normalised; P2: the last running input
  int32_t arm, probe, n_u, steps, R, K, NW;
};

constexpr int kThreads = QTTS_GEMV_THREADS;
constexpr int kMaxRows = 8;

__global__ void __launch_bounds__(kThreads) probe_kernel(const __grid_constant__ ProbeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, K = a.K, R = a.R, NW = a.NW, RK = R * K;
  float* xe = smem;                                     // [R, K] the unit's input
  float* xb = smem + RK;                                // [R, K] its bf16 rounding
  int8_t* qs = reinterpret_cast<int8_t*>(smem + 2 * RK);  // [K] its a8 quantisation
  const int warp = tid >> 5, lane = tid & 31;
  const int groups = (NW + QTTS_GEMV_ROWS - 1) / QTTS_GEMV_ROWS;
  const int units = a.steps * a.n_u;
  for (int i = 0;; ++i) {
    // prologue: the unit's input from the previous unit's output (all of it,
    // in every block)
    const float* yp = a.y + (size_t)((i + 1) & 1) * R * NW;
    __syncthreads();  // the previous unit is done with xb and qs
    float ss = 0.f;
    for (int e = tid; e < RK; e += blockDim.x) {
      float v;
      if (i == 0) {
        v = a.x0[e];
      } else if (a.probe == 2) {
        v = __fadd_rn(__fmul_rn(yp[e], 1e-3f), xe[e]);  // R = 1, NW = K
      } else {
        const float* row = yp + (size_t)(e / K) * NW;
        const int k = e % K;
        v = NW != K ? __fadd_rn(row[k], row[K + k]) : row[k];
      }
      xe[e] = v;
      ss += v * v;
    }
    if (a.probe == 1 && i > 0) {
      const float rn = rsqrtf(qtts_block_reduce(ss, QttsSumF()) / (float)RK + 1e-6f);
      for (int e = tid; e < RK; e += blockDim.x) xe[e] = xe[e] * rn;
    }
    __syncthreads();
    if (i == units) break;

    // the arm's transform of the input
    float sx = 1.f;
    if (a.arm == ARM_A8) {
      float amax = 0.f;
      for (int k = tid; k < K; k += blockDim.x) amax = fmaxf(amax, fabsf(xe[k]));
      amax = qtts_block_reduce(amax, QttsMaxF());
      sx = a.probe == 1 ? fmaxf(amax / 127.f, 1e-8f) : amax * (1.f / 127.f);
      const float inv = 1.f / sx;
      for (int k = tid; k < K; k += blockDim.x) {
        float q = rintf(xe[k] * inv);
        if (a.probe == 1) q = fminf(fmaxf(q, -127.f), 127.f);
        qs[k] = (int8_t)(int)q;
      }
    } else {
      for (int e = tid; e < RK; e += blockDim.x) xb[e] = qtts_bf16_round(xe[e]);
    }
    __syncthreads();

    // rows: QTTS_GEMV_RPW per warp, 16-byte weight chunks per lane
    const int u = i % a.n_u;
    const float* su = a.s + (size_t)u * NW;
    float* yo = a.y + (size_t)(i & 1) * R * NW;
    for (int g = blockIdx.x; g < groups; g += gridDim.x) {
      const int n0 = g * QTTS_GEMV_ROWS + warp * QTTS_GEMV_RPW;
      if (a.arm == ARM_A8) {
        const int8_t* W = static_cast<const int8_t*>(a.w) + (size_t)u * NW * K;
        int iacc[QTTS_GEMV_RPW] = {};
        for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
          const int4 xv = *reinterpret_cast<const int4*>(qs + k0);
#pragma unroll
          for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
            if (n0 + r < NW) {
              const int4 wv = __ldg(reinterpret_cast<const int4*>(W + (size_t)(n0 + r) * K + k0));
              iacc[r] = __dp4a(wv.x, xv.x, iacc[r]);
              iacc[r] = __dp4a(wv.y, xv.y, iacc[r]);
              iacc[r] = __dp4a(wv.z, xv.z, iacc[r]);
              iacc[r] = __dp4a(wv.w, xv.w, iacc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
          const int v = qtts_warp_reduce(iacc[r], QttsSumI());
          const int n = n0 + r;
          if (lane == 0 && n < NW) yo[n] = __fmul_rn((float)v, __fmul_rn(sx, su[n]));
        }
      } else if (a.arm == ARM_BF16) {
        const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(a.w) + (size_t)u * NW * K;
        float acc[QTTS_GEMV_RPW] = {};
        for (int k0 = lane * 8; k0 < K; k0 += 32 * 8) {
#pragma unroll
          for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
            if (n0 + r < NW) {
              const int4 wv = __ldg(reinterpret_cast<const int4*>(W + (size_t)(n0 + r) * K + k0));
              const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z,
                                         (uint32_t)wv.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[r] = fmaf(xb[k0 + 2 * q], __uint_as_float(words[q] << 16), acc[r]);
                acc[r] = fmaf(xb[k0 + 2 * q + 1], __uint_as_float(words[q] & 0xffff0000u),
                              acc[r]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
          const float v = qtts_warp_reduce(acc[r], QttsSumF());
          const int n = n0 + r;
          if (lane == 0 && n < NW) yo[n] = __fmul_rn(v, su[n]);
        }
      } else if (a.arm == ARM_M8) {
        const int8_t* W = static_cast<const int8_t*>(a.w) + (size_t)u * NW * K;
        // each lane converts its 16 weights of both rows once, then runs
        // them against every activation row (loaded as conv loads its one)
        float acc[QTTS_GEMV_RPW][kMaxRows] = {};
        for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
          float wf[QTTS_GEMV_RPW][16];
#pragma unroll
          for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
            int4 wv = make_int4(0, 0, 0, 0);
            if (n0 + r < NW) {
              wv = __ldg(reinterpret_cast<const int4*>(W + (size_t)(n0 + r) * K + k0));
            }
            const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z,
                                       (uint32_t)wv.w};
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              wf[r][e] = (float)(int8_t)(uint8_t)(words[e / 4] >> (8 * (e % 4)));
            }
          }
#pragma unroll
          for (int m = 0; m < kMaxRows; ++m) {
            if (m < R) {
              float hv[16];
#pragma unroll
              for (int i = 0; i < 16; i += 4) {
                const float4 t4 = *reinterpret_cast<const float4*>(xb + m * K + k0 + i);
                hv[i] = t4.x;
                hv[i + 1] = t4.y;
                hv[i + 2] = t4.z;
                hv[i + 3] = t4.w;
              }
#pragma unroll
              for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
#pragma unroll
                for (int e = 0; e < 16; ++e) acc[r][m] = fmaf(hv[e], wf[r][e], acc[r][m]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
#pragma unroll
          for (int m = 0; m < kMaxRows; ++m) {
            if (m < R) {
              const float v = qtts_warp_reduce(acc[r][m], QttsSumF());
              const int n = n0 + r;
              if (lane == 0 && n < NW) yo[(size_t)m * NW + n] = __fmul_rn(v, su[n]);
            }
          }
        }
      } else {  // ARM_CONV, ARM_W2048: K1's rows
        const int8_t* W = static_cast<const int8_t*>(a.w) + (size_t)u * NW * K;
        float acc[QTTS_GEMV_RPW];
        qtts_gemv_rows(W, xb, NW, K, n0, acc);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
            const int n = n0 + r;
            if (n < NW) yo[n] = __fmul_rn(acc[r], su[n]);
          }
        }
      }
    }
    qtts_grid_sync();
  }
  if (blockIdx.x == 0) {
    for (int e = tid; e < RK; e += blockDim.x) a.out[e] = xe[e];
  }
}

size_t probe_smem(int R, int K) { return (size_t)2 * R * K * sizeof(float) + K; }

// The ring kernel's argument and plan (tools/unit_probe.py::probe_plan).
// Shared memory, in order: the input area (in_bytes: the unit's input, its
// bf16 rounding, its a8 quantisation), n_slots mbarriers, n_slots scale
// areas of slot_rows floats, n_slots weight slots of slot_bytes.
struct RingArgs {
  const void* w;          // [n_u, NW, K] rows: int8, or bf16 for ARM_BF16
  const float* s;         // [n_u, NW] row scales
  const float* x0;        // [R, K] the first unit's input
  float* y;               // [2, R, NW] unit outputs, alternating
  float* out;             // [R, K] P1: the last output normalised; P2: the last running input
  const int32_t* bounds;  // [grid + 1]: block b owns rows [b], [b + 1]) of every unit
  int32_t arm, n_u, steps, R, K, NW;
  int32_t grid, n_slots, slot_bytes, slot_rows, in_bytes, smem_bytes;
  int32_t issue_stall_ns;  // checks only (0 on every path): see the stage's wait
};

// The plans' layout (qtts_plan_layout) with the input area as the union region.
static __host__ __device__ __forceinline__ QttsSmemLayout ring_layout(const RingArgs& a) {
  QttsPlan p{};
  p.union_bytes = a.in_bytes;
  p.n_slots = a.n_slots;
  p.slot_bytes = a.slot_bytes;
  p.slot_rows = a.slot_rows;
  return qtts_plan_layout(p);
}

// Thread 0: stage i of the block's walk (its rows of weight unit i % n_u and
// their scales) into slot i % n_slots, completed on the slot's mbarrier;
// nothing past the walk's end.
static __device__ __forceinline__ void ring_issue(const QttsRing& ring, const RingArgs& a, int i,
                                                  int r0, int rows) {
  if (i >= a.steps * a.n_u) return;
  const int u = i % a.n_u;
  const int esize = a.arm == ARM_BF16 ? 2 : 1;
  const int slot = i % ring.n_slots;
  uint64_t* bar = ring.full + slot;
  const uint32_t wbytes = (uint32_t)rows * a.K * esize;
  qtts_mbar_expect_tx(bar, wbytes + 4u * rows);
  qtts_bulk_load(ring.slots + (size_t)slot * ring.slot_bytes,
                 static_cast<const unsigned char*>(a.w) + ((size_t)u * a.NW + r0) * a.K * esize,
                 wbytes, bar);
  qtts_bulk_load(ring.scales + (size_t)slot * ring.slot_rows, a.s + (size_t)u * a.NW + r0,
                 4u * rows, bar);
}

// One output row of the unit from its weight row in shared memory (wr; sv
// its scale), by one warp in probe_kernel's lane order for the arm; lane 0
// stores yo[m * NW + n] for each activation row m.
static __device__ __forceinline__ void ring_row(const RingArgs& a, const unsigned char* wr,
                                                float sv, const float* xb, const int8_t* qs,
                                                float sx, float* yo, int n, int lane) {
  const int K = a.K, NW = a.NW;
  if (a.arm == ARM_A8) {
    int iacc = 0;
    for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
      const int4 xv = *reinterpret_cast<const int4*>(qs + k0);
      const int4 wv = *reinterpret_cast<const int4*>(wr + k0);
      iacc = __dp4a(wv.x, xv.x, iacc);
      iacc = __dp4a(wv.y, xv.y, iacc);
      iacc = __dp4a(wv.z, xv.z, iacc);
      iacc = __dp4a(wv.w, xv.w, iacc);
    }
    const int v = qtts_warp_reduce(iacc, QttsSumI());
    if (lane == 0) yo[n] = __fmul_rn((float)v, __fmul_rn(sx, sv));
  } else if (a.arm == ARM_BF16) {
    float acc = 0.f;
    for (int k0 = lane * 8; k0 < K; k0 += 32 * 8) {
      const int4 wv = *reinterpret_cast<const int4*>(wr + 2 * k0);
      const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc = fmaf(xb[k0 + 2 * q], __uint_as_float(words[q] << 16), acc);
        acc = fmaf(xb[k0 + 2 * q + 1], __uint_as_float(words[q] & 0xffff0000u), acc);
      }
    }
    const float v = qtts_warp_reduce(acc, QttsSumF());
    if (lane == 0) yo[n] = __fmul_rn(v, sv);
  } else if (a.arm == ARM_M8) {
    float acc[kMaxRows] = {};
    for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
      const int4 wv = *reinterpret_cast<const int4*>(wr + k0);
      const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
      float wf[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) wf[e] = (float)(int8_t)(uint8_t)(words[e / 4] >> (8 * (e % 4)));
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        if (m < a.R) {
          float hv[16];
#pragma unroll
          for (int i = 0; i < 16; i += 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(xb + m * K + k0 + i);
            hv[i] = t4.x;
            hv[i + 1] = t4.y;
            hv[i + 2] = t4.z;
            hv[i + 3] = t4.w;
          }
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[m] = fmaf(hv[e], wf[e], acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m) {
      if (m < a.R) {
        const float v = qtts_warp_reduce(acc[m], QttsSumF());
        if (lane == 0) yo[(size_t)m * NW + n] = __fmul_rn(v, sv);
      }
    }
  } else {  // ARM_CONV, ARM_W2048: qtts_gemv_rows' lane order
    float acc = 0.f;
    for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
      float hv[16];
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(xb + k0 + i);
        hv[i] = t4.x;
        hv[i + 1] = t4.y;
        hv[i + 2] = t4.z;
        hv[i + 3] = t4.w;
      }
      const int4 wv = *reinterpret_cast<const int4*>(wr + k0);
      const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float wf = (float)(int8_t)(uint8_t)(words[q] >> (8 * b));
          acc = fmaf(hv[q * 4 + b], wf, acc);
        }
      }
    }
    const float v = qtts_warp_reduce(acc, QttsSumF());
    if (lane == 0) yo[n] = __fmul_rn(v, sv);
  }
}

// PROBE (1 or 2) is a template argument: read from the arguments, it made
// P1's chain ~2% slower on an H100 (chip_ab.py --kernels)
template <int PROBE>
__global__ void __launch_bounds__(kThreads, 1) ring_kernel(const __grid_constant__ RingArgs a) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  unsigned char* smem = ring_smem;
  const QttsSmemLayout lay = ring_layout(a);
  const QttsRing ring{smem + lay.slots, reinterpret_cast<float*>(smem + lay.scales),
                      reinterpret_cast<uint64_t*>(smem + lay.bars), a.n_slots, a.slot_bytes,
                      a.slot_rows};
  const int tid = threadIdx.x, K = a.K, R = a.R, NW = a.NW, RK = R * K;
  float* xe = reinterpret_cast<float*>(smem);  // [R, K] the unit's input
  float* xb = xe + RK;                         // [R, K] its bf16 rounding
  int8_t* qs = reinterpret_cast<int8_t*>(xe + 2 * RK);  // [K] its a8 quantisation
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = a.bounds[blockIdx.x], rows = a.bounds[blockIdx.x + 1] - r0;
  const int units = a.steps * a.n_u;
  if (tid == 0) {
    for (int s = 0; s < ring.n_slots; ++s) qtts_mbar_init(ring.full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < ring.n_slots; ++s) ring_issue(ring, a, s, r0, rows);
  }
  for (int i = 0;; ++i) {
    // prologue: probe_kernel's, the unit's input from the previous unit's
    // output (all of it, in every block), the same expressions in the same
    // order (P1: the folded output, normalised; P2: y * 1e-3 + the running
    // input, R = 1 and NW = K); a thread's loads of PV values are issued
    // together (other blocks wrote them in this launch: read past L1)
    constexpr int PV = 4;
    const float* yp = a.y + (size_t)((i + 1) & 1) * R * NW;
    __syncthreads();  // the previous unit is done with xb and qs
    float ss = 0.f;
    for (int e0 = tid; e0 < RK; e0 += PV * kThreads) {
      float v[PV], w[PV];
#pragma unroll
      for (int j = 0; j < PV; ++j) {
        const int e = e0 + j * kThreads;
        v[j] = w[j] = 0.f;
        if (e < RK) {
          if (i == 0) {
            v[j] = __ldg(a.x0 + e);
          } else {
            const float* row = yp + (size_t)(e / K) * NW;
            const int k = e % K;
            v[j] = __ldcg(row + k);
            if (NW != K) w[j] = __ldcg(row + K + k);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PV; ++j) {
        const int e = e0 + j * kThreads;
        if (e < RK) {
          float x;
          if (i == 0) {
            x = v[j];
          } else if (PROBE == 2) {
            x = __fadd_rn(__fmul_rn(v[j], 1e-3f), xe[e]);
          } else {
            x = NW != K ? __fadd_rn(v[j], w[j]) : v[j];
          }
          xe[e] = x;
          ss += x * x;
        }
      }
    }
    if (PROBE == 1 && i > 0) {
      const float rn = rsqrtf(qtts_block_reduce(ss, QttsSumF()) / (float)RK + 1e-6f);
      for (int e = tid; e < RK; e += blockDim.x) xe[e] = xe[e] * rn;
    }
    __syncthreads();
    if (i == units) break;

    // the arm's transform of the input
    float sx = 1.f;
    if (a.arm == ARM_A8) {
      float amax = 0.f;
      for (int k = tid; k < K; k += blockDim.x) amax = fmaxf(amax, fabsf(xe[k]));
      amax = qtts_block_reduce(amax, QttsMaxF());
      sx = PROBE == 1 ? fmaxf(amax / 127.f, 1e-8f) : amax * (1.f / 127.f);
      const float inv = 1.f / sx;
      for (int k = tid; k < K; k += blockDim.x) {
        float q = rintf(xe[k] * inv);
        if (PROBE == 1) q = fminf(fmaxf(q, -127.f), 127.f);
        qs[k] = (int8_t)(int)q;
      }
    } else {
      for (int e = tid; e < RK; e += blockDim.x) xb[e] = qtts_bf16_round(xe[e]);
    }
    __syncthreads();

    // the block's rows of stage i, one row per warp at a time.  With
    // issue_stall_ns (a check's setting), stage i >= n_slots is issued only
    // here, that long after the other warps reach their wait: a warp that
    // read its stage before the wait would read the slot's previous stage
    const int slot = i % ring.n_slots;
    if (a.issue_stall_ns > 0 && tid == 0 && i >= ring.n_slots) {
      const uint64_t t0 = qtts_globaltimer();
      while (qtts_globaltimer() - t0 < (uint64_t)a.issue_stall_ns) {
      }
      ring_issue(ring, a, i, r0, rows);
    }
    qtts_mbar_wait(ring.full + slot, (uint32_t)(i / ring.n_slots) & 1u);
    const unsigned char* ws = ring.slots + (size_t)slot * ring.slot_bytes;
    const float* sc = ring.scales + (size_t)slot * ring.slot_rows;
    const size_t row_bytes = (size_t)K * (a.arm == ARM_BF16 ? 2 : 1);
    float* yo = a.y + (size_t)(i & 1) * R * NW;
    for (int r = warp; r < rows; r += kThreads / 32) {
      ring_row(a, ws + r * row_bytes, sc[r], xb, qs, sx, yo, r0 + r, lane);
    }
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && a.issue_stall_ns == 0) ring_issue(ring, a, i + ring.n_slots, r0, rows);
    qtts_grid_sync();
  }
  if (blockIdx.x == 0) {
    for (int e = tid; e < RK; e += blockDim.x) a.out[e] = xe[e];
  }
}

}  // namespace

extern "C" {

// The group kernel: one call of the chain (P1: probe 1, P2: probe 2), the
// reference the ring kernel is held to.
int qtts_unit_probe(const void* w, const float* s, const float* x0, float* y, float* out,
                    int arm, int probe, int n_u, int steps, int R, int K, int NW, void* stream) {
  if (K % 16 != 0 || R < 1 || R > kMaxRows || (R > 1) != (arm == ARM_M8) ||
      (probe == 2 && (R != 1 || NW != K || (arm != ARM_CONV && arm != ARM_A8))) || n_u < 1 ||
      steps < 1 || (probe != 1 && probe != 2) || arm < ARM_CONV || arm > ARM_M8 ||
      (arm == ARM_W2048) != (NW == 2 * K) || (arm != ARM_W2048 && NW != K)) {
    return (int)cudaErrorInvalidValue;
  }
  ProbeArgs a{w, s, x0, y, out, arm, probe, n_u, steps, R, K, NW};
  const size_t smem = probe_smem(R, K);
  static size_t cached_smem = 0;
  static int cached_grid = 0;
  if (cached_smem != smem) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    QTTS_TRY(cudaGetDevice(&dev));
    QTTS_TRY(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
    if (!coop) return (int)cudaErrorNotSupported;
    QTTS_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    QTTS_TRY(cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
    QTTS_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel, kThreads, smem));
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_smem = smem;
    cached_grid = sms * per_sm;
  }
  void* params[] = {&a};
  QTTS_TRY(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(probe_kernel),
                                       dim3(cached_grid), dim3(kThreads), params, smem,
                                       static_cast<cudaStream_t>(stream)));
  return (int)cudaGetLastError();
}

// The probes' entry: one call of the chain on the weight ring (P1: probe 1,
// P2: probe 2); bounds [grid + 1] and the ring's geometry from
// tools/unit_probe.py::probe_plan; issue_stall_ns is zero but in checks.
int qtts_unit_probe_ring(const void* w, const float* s, const float* x0, float* y, float* out,
                         const int32_t* bounds, int arm, int probe, int n_u, int steps, int R,
                         int K, int NW, int grid, int n_slots, int slot_bytes, int slot_rows,
                         int in_bytes, int smem_bytes, int issue_stall_ns, void* stream) {
  const int esize = arm == ARM_BF16 ? 2 : 1;
  if (K % 16 != 0 || R < 1 || R > kMaxRows || (R > 1) != (arm == ARM_M8) ||
      (probe == 2 && (R != 1 || NW != K || (arm != ARM_CONV && arm != ARM_A8))) || n_u < 1 ||
      steps < 1 || (probe != 1 && probe != 2) || issue_stall_ns < 0 || arm < ARM_CONV ||
      arm > ARM_M8 || (arm == ARM_W2048) != (NW == 2 * K) ||
      (arm != ARM_W2048 && NW != K) || NW % 4 != 0 || grid < 1 || n_slots < 1 ||
      slot_bytes % 16 != 0 || slot_rows % 4 != 0 || (size_t)slot_rows * K * esize > (size_t)slot_bytes ||
      in_bytes % 128 != 0 || (size_t)in_bytes < probe_smem(R, K) || bounds == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const RingArgs a{w, s, x0, y, out, bounds, arm, n_u, steps, R, K, NW,
                   grid, n_slots, slot_bytes, slot_rows, in_bytes, smem_bytes, issue_stall_ns};
  if (ring_layout(a).total != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return probe == 1 ? qtts_launch_persistent(ring_kernel<1>, a, grid, smem_bytes, st)
                    : qtts_launch_persistent(ring_kernel<2>, a, grid, smem_bytes, st);
}

}  // extern "C"
