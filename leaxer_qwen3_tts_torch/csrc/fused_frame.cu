// Kernel K7: one whole B=1 12 Hz frame in one persistent kernel launch.
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_frame.py::fused_frame_step
// (_make_frame_kernel).  The same function, in the JAX kernel's order:
//   code0:  logits0 = last_logits + suppress (+ -1e30 at CODEC_EOS when
//           forbidden), drawn by gumbel_topk_topp_sample on the full row;
//   c0e:    codec_embed[code0] as float32;
//   chain:  K2's whole chain, prefix included, at the MTP cache dtype;
//   x:      c0e + sub_sum + drip in float32, with no cast (the multi-dispatch
//           path rounds it to the embedding dtype first; the JAX kernel does
//           not, and neither does this one);
//   talker: K1's step through the talker layers at pos;
//   head:   hidden = RMSNorm(x) * final_norm (float32, returned) and
//           logits = bf16(hidden) @ bf16(lm rows) * scale.
//
// The TPU kernel walks the talker's (L,) grid on one core with the chain in
// the l == 0 prologue.  On Hopper the frame is one cooperative launch of
// the persistent transport K1 and K2 run on (qtts_stream.cuh): a plan of two
// weight sets (ops/persistent.py: the MTP trunk with its heads, then the
// talker with its lm_head) whose stages form one sequence through a TMA
// weight ring, so the talker's first stages load while the chain's last
// sub-code is drawn.  Its phases are, in order: block 0's code0 draw (K2's
// register sampler at 12 values a thread), while the chain's first stages
// load; K2's chain body (qtts_chain_phases), whose last gather also forms
// the next input; K1's step phases on the talker weights; and the final
// norm with the lm_head as one more ring GEMV, whose prologue writes the
// float32 normed hidden.  Every value keeps the op sequence of the kernels it
// is built from, so K7 equals, bit for bit, both the launch-per-op frame
// kernel it replaced (qtts_frame_step_multi, below) and the composition
// K2 -> float32 next input -> K1 -> K1's GEMV body on the final norm
// (qtts_norm_head); chip_smoke.py holds it to both.
//
// What bounds it on the H100 (NVIDIA data sheet, SXM, 3.35 TB/s): the int8
// weights read once -- the 440 MB talker, the 82 MB trunk, 30 MB of heads, the
// 3 MB lm_head -- about 554 MB, 0.165 ms; the trunk is larger than the 50 MB
// L2, so each of its 16 passes streams it again (1.31 GB, 0.39 ms).  At one
// token the frame is bound by latency instead: ~650 grid barriers (five per
// layer, two per chain step), the 16 draws on one block, and each block's
// stages of a phase; the card measured, its power limit and the per-phase
// trace are in PERF.md.

// An int8 talker KV cache (the JAX kernel's kvq mode): the talker step runs
// K1's int8-cache phases (frame_kernel<bf16, int8_t, ...>: the chain keeps a
// bf16 cache, the talker step gets a call site of its own), so K7 still
// equals the composition K2 -> float32 x -> K1 (int8 cache) -> norm + head
// bit for bit.  The launch-per-op frame takes no int8 cache.
//
// Unit mixes (qtts_frame.cuh): the kernel is a template over the trunk's and
// the talker's unit types.  This source instantiates the int8 talker beside
// the int8 trunk and, as a part of its own (QTTS_PART 1, ops/_build.py
// PARTS), the bf16 talker (bf16 heads and lm_head) beside it; fused_int4.cu
// the mixes with int4 units.  The launch-per-op frame takes int8 units only.

// The build compiles this source as two objects (ops/_build.py PARTS): part
// 0 everything but the bf16-talker frame, part 1 that frame.  Unset, both.
#ifndef QTTS_PART
#define QTTS_PART -1
#endif
#define QTTS_FRAME_HAS(part) (QTTS_PART < 0 || QTTS_PART == (part))

#include "qtts_frame.cuh"

#if QTTS_FRAME_HAS(1)
int qtts_launch_frame_bf16_i8(const QttsFrameLaunch& f, cudaStream_t st) {
  if (f.a.tw.unit_type != QTTS_UNIT_BF16 || f.a.mw.unit_type != QTTS_UNIT_INT8) {
    return (int)cudaErrorInvalidValue;
  }
  return qtts_launch_frame_caches<int8_t, __nv_bfloat16>(f, st);
}
#endif

#if QTTS_FRAME_HAS(0)

namespace {

// ---------------------------------------------------------------------------
// The launch-per-op frame K7 ran before it was persistent
// ---------------------------------------------------------------------------
//
// A cooperative grid of SM count x resident blocks per SM whose phases are
// the launches K1 and K2's launch-per-op sequences make, separated by grid
// barriers: each phase deals its work items to the blocks round-robin and
// runs them through the device bodies those launches run (qtts_kernels.cuh),
// with their thread counts and reduction orders -- a GEMV row group or the
// sampler on a whole 256-thread block, an attention item on one 128-thread
// half.  Kept as the reference chip_smoke.py holds the persistent K7 to.

constexpr int kThreads = QTTS_GEMV_THREADS;  // 256: two attention items per block

// Every row group of one GEMV, dealt to the blocks round-robin.
template <int IN_MODE, bool ACCUM>
__device__ __forceinline__ void gemv_phase(const float* in, const float* norm_w, float eps,
                                           const int8_t* W, const float* scale, float* out, int N,
                                           int K, float* sh, float* raw = nullptr) {
  const int groups = (N + QTTS_GEMV_ROWS - 1) / QTTS_GEMV_ROWS;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    __syncthreads();  // the previous group's rows are done with sh
    qtts_gemv_i8_body<IN_MODE, ACCUM>(in, norm_w, eps, W, scale, out, N, K, g, sh, raw);
  }
}

// One K1 step through every layer of w at position pos: the phases of
// qtts_launch_decode_step, each ended by a grid barrier.  x_in is read by
// layer 0's qkv product and copied to x there (x_in == x: no copy).
template <typename CT>
__device__ void frame_step(const QttsStepWeights& w, const QttsStepScratch& s, const float* x_in,
                           float* x, CT* kc, CT* vc, int T, int pos, float* sh,
                           QttsAttnSmem* am) {
  const int H = w.H, I = w.I, qd = w.nq * w.D, A = qd + 2 * w.nk * w.D;
  const int n_splits = pos / QTTS_ATTN_CHUNK + 1;
  const int half = threadIdx.x / QTTS_ATTN_D, t = threadIdx.x % QTTS_ATTN_D;
  const QttsNamedSync hsync{1 + half};
  const int lane0 = 2 * blockIdx.x + half, lanes = 2 * gridDim.x;  // attention item dealing
  const size_t row = (size_t)w.nk * T * w.D;
  for (int l = 0; l < w.L; ++l) {
    gemv_phase<QTTS_IN_NORM, false>(l == 0 ? x_in : x, w.attn_norm + (size_t)l * H, w.eps,
                                    w.wqkv + (size_t)l * A * H, w.sqkv + (size_t)l * A, s.qkv,
                                    A, H, sh);
    if (l == 0 && x_in != x) {
      for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < H; k += gridDim.x * blockDim.x) {
        x[k] = x_in[k];
      }
    }
    qtts_grid_sync();
    for (int it = lane0; it < w.nk * n_splits; it += lanes) {
      hsync();  // the half's previous item is done with its shared memory
      qtts_attn_split_body<CT, false>(am[half], hsync, t, it % w.nk, it / w.nk, 0, s.qkv, A,
                                      w.q_norm + (size_t)l * w.D, w.k_norm + (size_t)l * w.D,
                                      w.inv_freq, kc + l * row, vc + l * row, row, s.part, w.nq,
                                      w.nk, T, nullptr, pos, 1, s.max_splits, w.eps,
                                      w.attn_scale);
    }
    qtts_grid_sync();
    for (int it = lane0; it < w.nq; it += lanes) {
      qtts_attn_combine_body<float>(t, it, 0, s.part, s.attn, w.nq, s.max_splits, T, nullptr,
                                    pos, 1);
    }
    qtts_grid_sync();
    gemv_phase<QTTS_IN_PLAIN, true>(s.attn, nullptr, 0.f, w.wo + (size_t)l * H * qd,
                                    w.so + (size_t)l * H, x, H, qd, sh);
    qtts_grid_sync();
    gemv_phase<QTTS_IN_NORM, false>(x, w.mlp_norm + (size_t)l * H, w.eps,
                                    w.wgu + (size_t)l * 2 * I * H, w.sgu + (size_t)l * 2 * I,
                                    s.gu, 2 * I, H, sh);
    qtts_grid_sync();
    gemv_phase<QTTS_IN_SILU, true>(s.gu, nullptr, 0.f, w.wd + (size_t)l * H * I,
                                   w.sd + (size_t)l * H, x, H, I, sh);
    qtts_grid_sync();
  }
}

template <typename CT>
__global__ void __launch_bounds__(kThreads)
frame_kernel_multi(const __grid_constant__ QttsFrameArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sh = reinterpret_cast<float*>(smem);  // GEMV input / sampler rows
  QttsAttnSmem* am = reinterpret_cast<QttsAttnSmem*>(smem);  // two attention items
  const QttsChainArgs& c = a.mc;
  const int H = a.tw.H, n = c.n, V = c.V;
  const int tid = threadIdx.x;

  // --- code0: suppress + EOS gate + draw, then its codec row (block 0);
  // every block loads its share of the trunk's first input ---
  if (blockIdx.x == 0) {
    float* lg = sh;
    float* pr = sh + a.Vc;
    for (int v = tid; v < a.Vc; v += blockDim.x) {
      const float add = (v == a.eos && a.forbid_eos) ? QTTS_NEG_INF : 0.f;
      lg[v] = __fadd_rn(__fadd_rn(a.last_logits[v], a.suppress[v]), add);
    }
    __syncthreads();
    const int c0 = qtts_sample_index(lg, pr, a.Vc, a.g0, c.temperature, c.top_k, c.top_p,
                                     c.greedy);
    if (tid == 0) a.codes[0] = c0;
    for (int k = tid; k < H; k += blockDim.x) {
      a.c0e[k] = __bfloat162float(a.codec[(size_t)c0 * H + k]);
    }
  }
  for (int k = blockIdx.x * blockDim.x + tid; k < H; k += gridDim.x * blockDim.x) {
    c.x[k] = load_in(a.last_hidden, a.lh_bf16, k);
  }
  qtts_grid_sync();

  // --- the chain (qtts_run_mtp_chain's order) ---
  CT* mkc = static_cast<CT*>(c.k_cache);
  CT* mvc = static_cast<CT*>(c.v_cache);
  const int Tm = n + 2;
  frame_step<CT>(a.mw, a.ms, c.x, c.x, mkc, mvc, Tm, 0, sh, am);
  frame_step<CT>(a.mw, a.ms, a.c0e, c.x, mkc, mvc, Tm, 1, sh, am);
  for (int j = 0; j < n; ++j) {
    QttsHeadStep p;
    p.x = c.x;
    p.final_norm = c.final_norm;
    p.eps = a.mw.eps;
    p.W = c.heads + (size_t)j * V * H;
    p.scale = c.head_scales + (size_t)j * V;
    p.gumbel = c.greedy ? nullptr : c.gumbel + (size_t)j * V;
    p.table = c.tables + (size_t)j * c.Vt * H;
    p.logits = c.logits;
    p.counter = nullptr;
    p.subcodes = c.subcodes;
    p.sub_sum = c.sub_sum;
    p.x_next = c.x_in;
    p.j = j;
    p.V = V;
    p.H = H;
    p.temperature = c.temperature;
    p.top_k = c.top_k;
    p.top_p = c.top_p;
    p.greedy = c.greedy;
    gemv_phase<QTTS_IN_NORM, false>(p.x, p.final_norm, p.eps, p.W, p.scale, p.logits, V, H, sh);
    qtts_grid_sync();
    if (blockIdx.x == 0) {
      __syncthreads();
      qtts_head_pick(p, sh);
      if (j == n - 1) {
        // the next talker input: codec sum + text drip, in float32 (this
        // thread wrote sub_sum[k] just above and c0e[k] in the code0 phase)
        for (int k = tid; k < H; k += blockDim.x) {
          a.x[k] = __fadd_rn(__fadd_rn(a.c0e[k], c.sub_sum[k]), load_in(a.drip, a.drip_bf16, k));
        }
      }
    }
    if (j + 1 < n) {
      qtts_grid_sync();  // the next trunk pass reads the sampled embedding
      frame_step<CT>(a.mw, a.ms, c.x_in, c.x, mkc, mvc, Tm, 2 + j, sh, am);
    }
  }
  qtts_grid_sync();  // the talker's first layer reads x

  // --- the talker step ---
  frame_step<CT>(a.tw, a.ts, a.x, a.x, static_cast<CT*>(a.k_cache),
                 static_cast<CT*>(a.v_cache), a.T, a.pos, sh, am);

  // --- final norm + lm_head: K1's GEMV body, row group 0 writing the float32
  // normed values (before the bf16 rounding) as hidden ---
  gemv_phase<QTTS_IN_NORM, false>(a.x, a.talker_norm, a.tw.eps, a.lm, a.lm_scale, a.logits,
                                  a.Vc, H, sh, a.hidden);
}

bool step_ok(const QttsStepWeights& w, const QttsStepScratch& s, int T, int pos) {
  const int qd = w.nq * w.D;
  return w.D == QTTS_ATTN_D && w.nq % w.nk == 0 && w.nq / w.nk <= QTTS_ATTN_MAX_G &&
         w.H % 16 == 0 && qd % 16 == 0 && w.I % 16 == 0 && pos >= 0 && pos < T &&
         pos / QTTS_ATTN_CHUNK + 1 <= s.max_splits;
}

// The frame's scalar constraints; the units: a talker of int8, int4 or bf16
// units beside an int8 or int4 trunk, its heads and lm_head bf16 exactly
// where the talker is (the JAX gate refuses bf16 trunks).
bool frame_ok(const QttsFrameArgs& a) {
  const QttsChainArgs& c = a.mc;
  const bool units = a.tw.unit_type >= QTTS_UNIT_INT8 && a.tw.unit_type <= QTTS_UNIT_INT4 &&
                     (a.mw.unit_type == QTTS_UNIT_INT8 || a.mw.unit_type == QTTS_UNIT_INT4) &&
                     c.heads_bf16 == (a.tw.unit_type == QTTS_UNIT_BF16);
  // the talker cache: the chain's dtype, or int8 with its scales beside a
  // bf16 chain cache on JAX's buckets (128-aligned; beyond 512 slots
  // 512-aligned)
  const bool i8 = a.k_scale != nullptr;
  const bool caches = i8 ? a.v_scale != nullptr && c.cache_bf16 && !a.cache_bf16 &&
                               a.T % 128 == 0 && (a.T <= 512 || a.T % 512 == 0)
                         : a.v_scale == nullptr && c.cache_bf16 == a.cache_bf16;
  return units && step_ok(a.tw, a.ts, a.T, a.pos) && step_ok(a.mw, a.ms, c.n + 2, c.n) &&
         a.mw.H == a.tw.H && c.n >= 1 && c.V <= c.Vt && a.Vc >= 1 && caches;
}

size_t frame_smem_multi(const QttsFrameArgs& a) {
  size_t f = (size_t)2 * a.Vc;  // the code0 sampler's rows
  const size_t widths[] = {(size_t)2 * a.mc.V, (size_t)a.tw.H, (size_t)a.tw.nq * a.tw.D,
                           (size_t)a.tw.I, (size_t)a.mw.nq * a.mw.D, (size_t)a.mw.I};
  for (size_t v : widths) f = v > f ? v : f;
  const size_t bytes = f * sizeof(float);
  const size_t attn = 2 * sizeof(QttsAttnSmem);
  return bytes > attn ? bytes : attn;
}

// The launch-per-op frame on a grid of SM count x the blocks per SM that
// fit, found once per (instantiation, shared memory size).
template <typename CT>
int launch_frame_multi(const QttsFrameArgs& a, cudaStream_t st) {
  static size_t cached_smem = 0;
  static int cached_grid = 0;
  const size_t smem = frame_smem_multi(a);
  if (cached_grid == 0 || cached_smem != smem) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    QTTS_TRY(cudaGetDevice(&dev));
    QTTS_TRY(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
    if (!coop) return (int)cudaErrorNotSupported;
    QTTS_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    QTTS_TRY(cudaFuncSetAttribute(frame_kernel_multi<CT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    QTTS_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frame_kernel_multi<CT>,
                                                           kThreads, smem));
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_smem = smem;
    cached_grid = sms * per_sm;
  }
  void* params[] = {const_cast<QttsFrameArgs*>(&a)};
  QTTS_TRY(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(frame_kernel_multi<CT>),
                                       dim3(cached_grid), dim3(kThreads), params, smem, st));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel K7 entry: one frame; codes [1 + n], logits [Vc] and hidden [H] out,
// the talker caches updated in place, in one cooperative launch on the
// plan's grid (the plan's set 0: the MTP trunk with n heads of V rows; set
// 1: the talker with the Vc lm_head rows).
int qtts_frame_step(const QttsFrameArgs* a, const QttsPlan* p, void* stream) {
  if (!frame_ok(*a) || a->Vc > QTTS_P_THREADS * kCode0Vpt ||
      a->mc.V > QTTS_P_THREADS * QTTS_SAMPLE_VPT ||
      !qtts_plan_ok(*p, a->mw, a->mc.V, 0, &a->tw, a->Vc, a->mc.heads_bf16 ? 2 : 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const QttsFrameLaunch f{*a, *p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool m4 = a->mw.unit_type == QTTS_UNIT_INT4;
  switch (a->tw.unit_type) {
    case QTTS_UNIT_INT4:
      return m4 ? qtts_launch_frame_i4_i4(f, st) : qtts_launch_frame_i4_i8(f, st);
    case QTTS_UNIT_BF16:
      return m4 ? qtts_launch_frame_bf16_i4(f, st) : qtts_launch_frame_bf16_i8(f, st);
    default:
      return m4 ? qtts_launch_frame_i8_i4(f, st) : qtts_launch_frame_caches<int8_t, int8_t>(f, st);
  }
}

// The launch-per-op frame kernel K7 ran before it was persistent: the
// reference chip_smoke.py holds the persistent frame to, bit for bit; no
// wrapper calls it.
int qtts_frame_step_multi(const QttsFrameArgs* a, void* stream) {
  if (!frame_ok(*a) || a->k_scale != nullptr || a->tw.unit_type != QTTS_UNIT_INT8 ||
      a->mw.unit_type != QTTS_UNIT_INT8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a->cache_bf16 ? launch_frame_multi<__nv_bfloat16>(*a, st)
                       : launch_frame_multi<float>(*a, st);
}

// sizeof(QttsFrameArgs), for the wrapper's check of its ctypes mirror.
int qtts_frame_args_size() { return (int)sizeof(QttsFrameArgs); }

}  // extern "C"

#endif  // QTTS_FRAME_HAS(0)
