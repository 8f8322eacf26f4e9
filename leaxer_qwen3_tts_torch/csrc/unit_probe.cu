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
// One unit is one phase of the persistent kernel (cudaLaunchCooperativeKernel,
// SM count x resident blocks per SM), ended by K7's grid barrier
// (qtts_grid_sync).  Every block recomputes the unit's input vector and its
// reductions in its prologue, as K1's GEMV blocks do, then computes its row
// groups.  What bounds it on the H100 (NVIDIA data sheet, SXM): the weight
// bytes, 1 MB per int8 unit (0.31 us at 3.35 TB/s; P1's 72 MB stack is larger
// than the 50 MB L2, so each step streams it); the barrier per unit, about a
// microsecond, is of the same order, so the probe times transport and barrier
// together, as the TPU probe timed transport and step.

#include "qtts_kernels.cuh"

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

}  // namespace

extern "C" {

// Probe entry: one call of the chain (P1: probe 1, P2: probe 2).
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

}  // extern "C"
