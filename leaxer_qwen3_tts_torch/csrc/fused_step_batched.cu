// Kernel K4: one decode step of B = 1..32 streams through every layer of a
// GQA transformer, each stream at its own position (the continuous pool's
// slots fill at different rates), with each weight row read once for all B,
// as ONE persistent cooperative launch (bstep_kernel).
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_step.py::fused_decode_step_batched
// (_make_kernel_batched, modes "bvmem" and "bwin").  Row b computes exactly
// what kernel K1 computes for it, op for op and in the same order, so a row
// of K4 equals K1 on that row bit for bit:
//   h = RMSNorm(x) * attn_norm;  qkv = (bf16(h) @ bf16(W)) * scale  (f32)
//   per-head QK-norm, RoPE at pos[b], K/V written at slot pos[b] of row b,
//   attention over slots 0..pos[b]; x += bf16(attn) @ Wo * scale;
//   h = RMSNorm(x) * mlp_norm; x += bf16(silu(gate) * up) @ Wd * scale.
// Positions come from a device array (clamped to T-1, as the JAX wrapper
// clamps them: an idle slot keeps stepping), so a pool chunk needs no host
// sync; the attention grid covers every split of the bucket and a split past
// a row's position exits at once.  The TPU's window alignment gate is not
// carried over: the split attention takes any bucket.
//
// The persistent step runs K1's transport (csrc/qtts_stream.cuh): the same
// plan rows per block, the same TMA weight ring and stage sequence, five
// grid barriers per layer.  What the batch changes: every block computes
// its rows' products for a group of batch rows, whose bf16 GEMV inputs it
// holds in shared memory (K1's prologue values, B rows' block reductions on
// one pair of barriers); a stage is cut into units of <= 4 weight rows x <= 8
// batch rows, so a lane holds at most 32 accumulators; attention items run
// over (row, kv head, split) with a ticket per (row, kv head) and each row's
// own split count.  Where B rows' inputs do not fit beside the ring (B x
// max(H, I) x 2 bytes: 192 KB at B = 32 and 0.6B, 384 KB at 1.7B) the plan
// splits the grid into groups, each taking every weight row for its share
// of the batch (ops/persistent.py).  Every (row, output) value is K1's
// arithmetic in K1's order, so row b equals K1 on row b bit for bit, and the
// launch-per-op sequence below (qtts_decode_step_batched_multi) bit for bit.
// bf16 units take K1's bf16 path per row (a half row of 8 weights is one
// 16-byte load), so a bf16 K4 row equals the bf16 K1 on it too; at the
// 1.7B widths (12 KB down rows) the plan takes 48 KB slots, four rows each.
// int4 units (fused_int4.cu instantiates them) take qtts_bstage_unit4, K1
// int4's group-scaled sum per (row, batch row), so an int4 K4 row equals
// the int4 K1 on it bit for bit.
//
// What bounds it on the H100: the int8 weight bytes, 440 MB per step of the
// 0.6B talker, shared by B streams (0.13 ms at the 3.35 TB/s of an H100 SXM,
// NVIDIA data sheet); at B = 32 the B x 440 M multiply-adds on CUDA cores
// (14.1 G FMA, ~0.42 ms at the data sheet's 67 TFLOPS float32), since
// tensor cores would sum in another order than K1.  What the design leaves:
// every block reads its group's inputs from L2 in every phase (the silu
// input is B x 2I floats), the grid barriers, and no CUDA graph.
//
// An int8 KV cache (the JAX kernel's bwin kvq mode) takes K1's int8-cache
// item per row (CT = int8_t, both unit types), so each row still equals K1
// on it bit for bit, values and scales.
//
// The launch-per-op sequence (nine launches per layer, kept for the checks
// and for K6's GEMV): a row kernel turns the GEMV input into bf16 once per
// row, and the batched GEMV stages it in shared memory 512 columns at a time.

// The build compiles this source as two objects (ops/_build.py PARTS): part
// 1 the batched step at bf16 units, part 0 everything else.  Unset, both.
#ifndef QTTS_PART
#define QTTS_PART -1
#endif
#define QTTS_HAS_PART(part) (QTTS_PART < 0 || QTTS_PART == (part))

#include "qtts_stream.cuh"

#if QTTS_HAS_PART(1)
int qtts_launch_bstep_bf16(const QttsBStepLaunch& a, int cache, cudaStream_t st) {
  if (a.w.unit_type != QTTS_UNIT_BF16) return (int)cudaErrorInvalidValue;
  return qtts_launch_bstep_cache<__nv_bfloat16>(a, cache, st);
}
#endif

#if QTTS_HAS_PART(0)
namespace {

constexpr int QTTS_BGEMV_KT = 512;  // input columns staged per tile: 32 lanes x 16

// Grid B, QTTS_GEMV_THREADS threads: out[b, :K] = bf16(transform(in[b])).
// The same block size and reduction as K1's prologue, hence the same values.
template <int IN_MODE>
__global__ void __launch_bounds__(QTTS_GEMV_THREADS)
prep_rows_kernel(const float* __restrict__ in, int ld_in, const float* __restrict__ norm_w,
                 float eps, int K, __nv_bfloat16* __restrict__ out) {
  in += (size_t)blockIdx.x * ld_in;
  out += (size_t)blockIdx.x * K;
  const float r = qtts_prep_scale<IN_MODE>(in, eps, K);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    out[k] = __float2bfloat16_rn(qtts_prep_value<IN_MODE>(in, norm_w, r, K, k));
  }
}

__device__ __forceinline__ void unpack_bf16x8(const int4 v, float* o) {
  const uint32_t words[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o[2 * q] = __uint_as_float(words[q] << 16);
    o[2 * q + 1] = __uint_as_float(words[q] & 0xffff0000u);
  }
}

// Grid ceil(N / QTTS_GEMV_ROWS), QTTS_GEMV_THREADS threads.  Warp w of block
// x owns output rows n0 = x*ROWS + w*RPW .. n0+RPW-1 for all B inputs; lane i
// takes columns k0 = i*16 + t*512 of tile t, in the order K1's
// qtts_gemv_rows takes them, so each (n, b) sum is K1's sum.
template <int BM, bool ACCUM>
__global__ void __launch_bounds__(QTTS_GEMV_THREADS)
gemv_rows_kernel(const __nv_bfloat16* __restrict__ in, const int8_t* __restrict__ W,
                 const float* __restrict__ scale, float* __restrict__ out, int ldo, int B,
                 int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 sh[BM * QTTS_BGEMV_KT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * QTTS_GEMV_ROWS + warp * QTTS_GEMV_RPW;
  float acc[QTTS_GEMV_RPW][BM];
#pragma unroll
  for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
#pragma unroll
    for (int b = 0; b < BM; ++b) acc[r][b] = 0.f;
  }
  for (int kt = 0; kt < K; kt += QTTS_BGEMV_KT) {
    const int k0 = kt + lane * 16;
    // the weight loads go out before the tile is staged
    int4 wv[QTTS_GEMV_RPW];
#pragma unroll
    for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
      const int n = n0 + r;
      wv[r] = (n < N && k0 < K) ? __ldg(reinterpret_cast<const int4*>(W + (size_t)n * K + k0))
                                : make_int4(0, 0, 0, 0);
    }
    const int chunks = min(QTTS_BGEMV_KT, K - kt) / 8;  // int4 = 8 bf16
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < B * chunks; i += blockDim.x) {
      const int b = i / chunks, c = i - b * chunks;
      *reinterpret_cast<int4*>(sh + b * QTTS_BGEMV_KT + c * 8) =
          *reinterpret_cast<const int4*>(in + (size_t)b * K + kt + c * 8);
    }
    __syncthreads();
    if (k0 >= K) continue;
#pragma unroll
    for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
      if (n0 + r >= N) continue;
      const uint32_t words[4] = {(uint32_t)wv[r].x, (uint32_t)wv[r].y, (uint32_t)wv[r].z,
                                 (uint32_t)wv[r].w};
      float wf[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) wf[q * 4 + e] = (float)(int8_t)(uint8_t)(words[q] >> (8 * e));
      }
#pragma unroll
      for (int b = 0; b < BM; ++b) {
        if (b < B) {
          const int4* hp = reinterpret_cast<const int4*>(sh + b * QTTS_BGEMV_KT + lane * 16);
          float hv[16];
          unpack_bf16x8(hp[0], hv);
          unpack_bf16x8(hp[1], hv + 8);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[r][b] = fmaf(hv[e], wf[e], acc[r][b]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < QTTS_GEMV_RPW; ++r) {
    const int n = n0 + r;
#pragma unroll
    for (int b = 0; b < BM; ++b) {
      if (b < B) {
        const float v = qtts_warp_reduce(acc[r][b], QttsSumF());
        if (lane == b && n < N) qtts_gemv_store<ACCUM>(out + (size_t)b * ldo + n, v, scale[n]);
      }
    }
  }
}

template <bool ACCUM>
cudaError_t launch_gemv_rows(const __nv_bfloat16* in, const int8_t* W, const float* scale,
                             float* out, int ldo, int B, int N, int K, cudaStream_t st) {
  const int grid = (N + QTTS_GEMV_ROWS - 1) / QTTS_GEMV_ROWS;
  if (B <= 4) {
    gemv_rows_kernel<4, ACCUM><<<grid, QTTS_GEMV_THREADS, 0, st>>>(in, W, scale, out, ldo, B, N, K);
  } else if (B <= 8) {
    gemv_rows_kernel<8, ACCUM><<<grid, QTTS_GEMV_THREADS, 0, st>>>(in, W, scale, out, ldo, B, N, K);
  } else if (B <= 16) {
    gemv_rows_kernel<16, ACCUM><<<grid, QTTS_GEMV_THREADS, 0, st>>>(in, W, scale, out, ldo, B, N,
                                                                    K);
  } else {
    gemv_rows_kernel<32, ACCUM><<<grid, QTTS_GEMV_THREADS, 0, st>>>(in, W, scale, out, ldo, B, N,
                                                                    K);
  }
  return cudaGetLastError();
}

}  // namespace

int qtts_launch_prep_rows(int in_mode, const float* in, int ld_in, const float* norm_w,
                          float eps, int K, __nv_bfloat16* out, int B, cudaStream_t st) {
  if (B < 1 || B > QTTS_MAX_BATCH) return (int)cudaErrorInvalidValue;
  if (in_mode == QTTS_IN_NORM) {
    prep_rows_kernel<QTTS_IN_NORM><<<B, QTTS_GEMV_THREADS, 0, st>>>(in, ld_in, norm_w, eps, K, out);
  } else if (in_mode == QTTS_IN_PLAIN) {
    prep_rows_kernel<QTTS_IN_PLAIN><<<B, QTTS_GEMV_THREADS, 0, st>>>(in, ld_in, norm_w, eps, K,
                                                                     out);
  } else {
    prep_rows_kernel<QTTS_IN_SILU><<<B, QTTS_GEMV_THREADS, 0, st>>>(in, ld_in, norm_w, eps, K, out);
  }
  return (int)cudaGetLastError();
}

int qtts_launch_gemv_rows(const __nv_bfloat16* in, const int8_t* W, const float* scale,
                          float* out, int ldo, int B, int N, int K, int accum, cudaStream_t st) {
  if (K % 16 != 0 || B < 1 || B > QTTS_MAX_BATCH) return (int)cudaErrorInvalidValue;
  return (int)(accum ? launch_gemv_rows<true>(in, W, scale, out, ldo, B, N, K, st)
                     : launch_gemv_rows<false>(in, W, scale, out, ldo, B, N, K, st));
}

int qtts_launch_decode_step_batched(const QttsStepWeights& w, const QttsBatchScratch& s,
                                    const float* x_in, float* x, void* k_cache, void* v_cache,
                                    int cache_bf16, int B, int T, const int64_t* pos_dev,
                                    int pos_host, cudaStream_t st) {
  if (w.unit_type != QTTS_UNIT_INT8 || w.D != QTTS_ATTN_D || w.nq % w.nk != 0 ||
      w.nq / w.nk > QTTS_ATTN_MAX_G) {
    return (int)cudaErrorInvalidValue;
  }
  if (B < 1 || B > QTTS_MAX_BATCH || T < 1) return (int)cudaErrorInvalidValue;
  if (pos_dev == nullptr && (pos_host < 0 || pos_host >= T)) return (int)cudaErrorInvalidValue;
  // device positions: every split of the bucket; a host position: its own
  const int n_splits = pos_dev ? (T + QTTS_ATTN_CHUNK - 1) / QTTS_ATTN_CHUNK
                               : pos_host / QTTS_ATTN_CHUNK + 1;
  if (n_splits > s.max_splits) return (int)cudaErrorInvalidValue;
  const int H = w.H, I = w.I, qd = w.nq * w.D, A = qd + 2 * w.nk * w.D;
  if (x_in != x) {
    QTTS_TRY(cudaMemcpyAsync(x, x_in, (size_t)B * H * sizeof(float), cudaMemcpyDeviceToDevice,
                             st));
  }
  for (int l = 0; l < w.L; ++l) {
    QTTS_TRY((cudaError_t)qtts_launch_prep_rows(QTTS_IN_NORM, x, H, w.attn_norm + (size_t)l * H,
                                                w.eps, H, s.hb, B, st));
    QTTS_TRY((cudaError_t)qtts_launch_gemv_rows(s.hb, w.wqkv + (size_t)l * A * H,
                                                w.sqkv + (size_t)l * A, s.qkv, A, B, A, H, 0,
                                                st));
    if (cache_bf16) {
      QTTS_TRY(qtts_launch_attention(w, l, s.qkv, s.part, s.max_splits, s.hb,
                                     static_cast<__nv_bfloat16*>(k_cache),
                                     static_cast<__nv_bfloat16*>(v_cache), B, 1, T, pos_dev,
                                     pos_host, n_splits, st));
    } else {
      QTTS_TRY(qtts_launch_attention(w, l, s.qkv, s.part, s.max_splits, s.hb,
                                     static_cast<float*>(k_cache), static_cast<float*>(v_cache),
                                     B, 1, T, pos_dev, pos_host, n_splits, st));
    }
    QTTS_TRY((cudaError_t)qtts_launch_gemv_rows(s.hb, w.wo + (size_t)l * H * qd,
                                                w.so + (size_t)l * H, x, H, B, H, qd, 1, st));
    QTTS_TRY((cudaError_t)qtts_launch_prep_rows(QTTS_IN_NORM, x, H, w.mlp_norm + (size_t)l * H,
                                                w.eps, H, s.hb, B, st));
    QTTS_TRY((cudaError_t)qtts_launch_gemv_rows(s.hb, w.wgu + (size_t)l * 2 * I * H,
                                                w.sgu + (size_t)l * 2 * I, s.gu, 2 * I, B,
                                                2 * I, H, 0, st));
    QTTS_TRY((cudaError_t)qtts_launch_prep_rows(QTTS_IN_SILU, s.gu, 2 * I, nullptr, 0.f, I,
                                                s.hb, B, st));
    QTTS_TRY((cudaError_t)qtts_launch_gemv_rows(s.hb, w.wd + (size_t)l * H * I,
                                                w.sd + (size_t)l * H, x, H, B, H, I, 1, st));
  }
  return (int)cudaSuccess;
}

extern "C" {

// Kernel K4 entry: x_out [B, H] = decode_step(x_in) with the caches updated in
// place; pos_dev [B] int64 on the device, or null for every row at pos_host.
// One cooperative launch on the plan's grid; int8, bf16 or int4 units
// (w->unit_type), each with a float32, bf16 or int8 cache.  The caches (and
// an int8 cache's scales) are [L, cache_rows, nk, T, D], of which the launch
// takes rows row0 .. row0 + B - 1: a call past QTTS_MAX_BATCH rows is split
// into launches of consecutive rows (ops/fused_step.py), each launch's row b
// on cache row row0 + b.
int qtts_decode_step_batched(const QttsStepWeights* w, const QttsBatchScratch* s,
                             const QttsPlan* p, const float* x_in, float* x_out, void* k_cache,
                             void* v_cache, float* k_scale, float* v_scale, int cache_bf16, int B,
                             int T, const int64_t* pos_dev, int pos_host, int cache_rows,
                             int row0, void* stream) {
  const bool i8 = k_scale != nullptr;
  const int qd = w->nq * w->D;
  const int n_splits = pos_dev ? (T + QTTS_ATTN_CHUNK - 1) / QTTS_ATTN_CHUNK
                               : pos_host / QTTS_ATTN_CHUNK + 1;
  if (w->unit_type < QTTS_UNIT_INT8 || w->unit_type > QTTS_UNIT_INT4 || w->D != QTTS_ATTN_D ||
      w->nq % w->nk != 0 || w->nq / w->nk > QTTS_ATTN_MAX_G ||
      w->H % 16 != 0 || qd % 16 != 0 || w->I % 16 != 0 || B < 1 || B > QTTS_MAX_BATCH ||
      T < 1 || (pos_dev == nullptr && (pos_host < 0 || pos_host >= T)) ||
      n_splits > s->max_splits || x_in == x_out || !qtts_plan_ok(*p, *w, 0, B) ||
      i8 != (v_scale != nullptr) || (i8 && (cache_bf16 || T % 128 != 0)) || row0 < 0 ||
      row0 + B > cache_rows) {
    return (int)cudaErrorInvalidValue;
  }
  const int cache = i8 ? 2 : cache_bf16 ? 1 : 0;
  // the launch's first cache row: row0 rows of layer 0 in (the layers' stride
  // stays cache_rows rows)
  const size_t first = (size_t)row0 * w->nk * T;
  const size_t esize = cache == 2 ? 1 : cache == 1 ? 2 : 4;
  void* kc = static_cast<char*>(k_cache) + first * w->D * esize;
  void* vc = static_cast<char*>(v_cache) + first * w->D * esize;
  float* ks = i8 ? k_scale + first : nullptr;
  float* vs = i8 ? v_scale + first : nullptr;
  const QttsBStepLaunch a{*w, *s, *p, x_in, x_out, kc, vc, ks, vs, pos_dev, B, T, pos_host,
                          cache_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w->unit_type) {
    case QTTS_UNIT_INT4: return qtts_launch_bstep_int4(a, cache, st);
    case QTTS_UNIT_BF16: return qtts_launch_bstep_bf16(a, cache, st);
    default: return qtts_launch_bstep_cache<int8_t>(a, cache, st);
  }
}

// The launch-per-op sequence K4 ran before it was persistent (nine launches
// per layer, int8 units only): the reference chip_smoke.py holds the persistent step to, bit
// for bit.  No wrapper calls it.
int qtts_decode_step_batched_multi(const QttsStepWeights* w, const QttsBatchScratch* s,
                                   const float* x_in, float* x_out, void* k_cache, void* v_cache,
                                   int cache_bf16, int B, int T, const int64_t* pos_dev,
                                   int pos_host, void* stream) {
  if (cache_bf16 != 0 && cache_bf16 != 1) return (int)cudaErrorInvalidValue;
  return qtts_launch_decode_step_batched(*w, *s, x_in, x_out, k_cache, v_cache, cache_bf16, B, T,
                                         pos_dev, pos_host, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

#endif  // QTTS_HAS_PART(0)
