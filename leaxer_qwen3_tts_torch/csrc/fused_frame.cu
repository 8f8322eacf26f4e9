// Kernel K7: one whole B=1 12 Hz frame in one persistent kernel launch.
//
// Replaces leaxer_qwen3_tts_tpu/ops/fused_frame.py::fused_frame_step
// (_make_frame_kernel).  The same function, in the JAX kernel's order:
//   code0:  logits0 = last_logits + suppress (+ -1e30 at CODEC_EOS when
//           forbidden), drawn by gumbel_topk_topp_sample on the full row
//           (qtts_sample_index, K2's sampler);
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
// the l == 0 prologue.  On Hopper one launch per frame means a persistent
// cooperative kernel: a grid of SM count x resident blocks per SM
// (cudaLaunchCooperativeKernel; a grid that cannot be co-resident fails the
// launch, and the wrapper raises), whose phases are the launches K1 and K2
// would make, separated by grid-wide barriers (qtts_grid_sync).  Each phase
// deals its work items to the blocks round-robin and runs them through the
// device bodies K1 and K2 launch (qtts_kernels.cuh), with the thread count and
// the reduction order each has there: a GEMV row group or the sampler on a
// whole 256-thread block, an attention item on 128 threads -- each block runs
// two at once, one per half, each half on its own named barrier.  So every
// value K7 computes equals, bit for bit, what K2 -> float32 next input -> K1
// -> K1's GEMV on the final norm computes on the same inputs; chip_smoke.py
// holds it to that.
//
// What bounds it on the H100 (NVIDIA data sheet, SXM, 3.35 TB/s): the int8
// weights read once -- the 440 MB talker, the 82 MB trunk, 30 MB of heads, the
// 3 MB lm_head -- about 554 MB, 0.165 ms; the trunk is larger than the 50 MB
// L2, so each of its 16 passes streams it again (1.31 GB, 0.39 ms).  What this
// simple design leaves on the table: ~780 grid barriers per frame (six per
// layer, two per chain step), GEMV phases of 64 row groups on a grid of
// hundreds of blocks, K1's GEMV with no cp.async / TMA weight pipeline, and
// the samplers on one block while the rest of the grid waits.

#include "qtts_kernels.cuh"

namespace {

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

__device__ __forceinline__ float load_in(const void* p, int bf16, int k) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[k])
              : static_cast<const float*>(p)[k];
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
__global__ void __launch_bounds__(kThreads) frame_kernel(const __grid_constant__ QttsFrameArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sh = reinterpret_cast<float*>(smem);  // GEMV input / sampler rows
  QttsAttnSmem* am = reinterpret_cast<QttsAttnSmem*>(smem);  // two attention items
  const int H = a.tw.H, n = a.n, V = a.V;
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
    const int c0 = qtts_sample_index(lg, pr, a.Vc, a.g0, a.temperature, a.top_k, a.top_p,
                                     a.greedy);
    if (tid == 0) a.codes[0] = c0;
    for (int k = tid; k < H; k += blockDim.x) {
      a.c0e[k] = __bfloat162float(a.codec[(size_t)c0 * H + k]);
    }
  }
  for (int k = blockIdx.x * blockDim.x + tid; k < H; k += gridDim.x * blockDim.x) {
    a.mx[k] = load_in(a.last_hidden, a.lh_bf16, k);
  }
  qtts_grid_sync();

  // --- the chain (qtts_run_mtp_chain's order) ---
  CT* mkc = static_cast<CT*>(a.mk_cache);
  CT* mvc = static_cast<CT*>(a.mv_cache);
  const int Tm = n + 2;
  frame_step<CT>(a.mw, a.ms, a.mx, a.mx, mkc, mvc, Tm, 0, sh, am);
  frame_step<CT>(a.mw, a.ms, a.c0e, a.mx, mkc, mvc, Tm, 1, sh, am);
  for (int j = 0; j < n; ++j) {
    QttsHeadStep p;
    p.x = a.mx;
    p.final_norm = a.mtp_norm;
    p.eps = a.mw.eps;
    p.W = a.heads + (size_t)j * V * H;
    p.scale = a.head_scales + (size_t)j * V;
    p.gumbel = a.greedy ? nullptr : a.gumbel + (size_t)j * V;
    p.table = a.tables + (size_t)j * a.Vt * H;
    p.logits = a.head_logits;
    p.counter = nullptr;
    p.subcodes = a.codes + 1;
    p.sub_sum = a.sub_sum;
    p.x_next = a.mx_in;
    p.j = j;
    p.V = V;
    p.H = H;
    p.temperature = a.temperature;
    p.top_k = a.top_k;
    p.top_p = a.top_p;
    p.greedy = a.greedy;
    gemv_phase<QTTS_IN_NORM, false>(p.x, p.final_norm, p.eps, p.W, p.scale, p.logits, V, H, sh);
    qtts_grid_sync();
    if (blockIdx.x == 0) {
      __syncthreads();
      qtts_head_pick(p, sh);
      if (j == n - 1) {
        // the next talker input: codec sum + text drip, in float32 (this
        // thread wrote sub_sum[k] just above and c0e[k] in the code0 phase)
        for (int k = tid; k < H; k += blockDim.x) {
          a.x[k] = __fadd_rn(__fadd_rn(a.c0e[k], a.sub_sum[k]), load_in(a.drip, a.drip_bf16, k));
        }
      }
    }
    if (j + 1 < n) {
      qtts_grid_sync();  // the next trunk pass reads the sampled embedding
      frame_step<CT>(a.mw, a.ms, a.mx_in, a.mx, mkc, mvc, Tm, 2 + j, sh, am);
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

size_t frame_smem(const QttsFrameArgs& a) {
  size_t f = (size_t)2 * a.Vc;  // the code0 sampler's rows
  const size_t widths[] = {(size_t)2 * a.V, (size_t)a.tw.H, (size_t)a.tw.nq * a.tw.D,
                           (size_t)a.tw.I, (size_t)a.mw.nq * a.mw.D, (size_t)a.mw.I};
  for (size_t v : widths) f = v > f ? v : f;
  const size_t bytes = f * sizeof(float);
  const size_t attn = 2 * sizeof(QttsAttnSmem);
  return bytes > attn ? bytes : attn;
}

// The grid of the launch: SM count x the blocks per SM that fit, once per
// (instantiation, shared memory size); 0 with the error in *err.
template <typename CT>
int frame_grid(size_t smem, cudaError_t* err) {
  static size_t cached_smem = 0;
  static int cached_grid = 0;
  *err = cudaSuccess;
  if (cached_grid > 0 && cached_smem == smem) return cached_grid;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) {
    return 0;
  }
  if (!coop) {
    *err = cudaErrorNotSupported;
    return 0;
  }
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return 0;
  }
  if ((*err = cudaFuncSetAttribute(frame_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem)) != cudaSuccess) {
    return 0;
  }
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frame_kernel<CT>, kThreads,
                                                            smem)) != cudaSuccess) {
    return 0;
  }
  if (per_sm < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  cached_smem = smem;
  cached_grid = sms * per_sm;
  return cached_grid;
}

template <typename CT>
int launch_frame(const QttsFrameArgs& a, cudaStream_t st) {
  const size_t smem = frame_smem(a);
  cudaError_t err;
  const int grid = frame_grid<CT>(smem, &err);
  if (!grid) return (int)err;
  void* params[] = {const_cast<QttsFrameArgs*>(&a)};
  QTTS_TRY(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(frame_kernel<CT>), dim3(grid),
                                       dim3(kThreads), params, smem, st));
  return (int)cudaGetLastError();
}

bool frame_ok(const QttsFrameArgs& a) {
  return step_ok(a.tw, a.ts, a.T, a.pos) && step_ok(a.mw, a.ms, a.n + 2, a.n) &&
         a.mw.H == a.tw.H && a.n >= 1 && a.V <= a.Vt && a.Vc >= 1;
}

}  // namespace

extern "C" {

// Kernel K7 entry: one frame; codes [1 + n], logits [Vc] and hidden [H] out,
// the talker caches updated in place.
int qtts_frame_step(const QttsFrameArgs* a, void* stream) {
  if (!frame_ok(*a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a->cache_bf16 ? launch_frame<__nv_bfloat16>(*a, st) : launch_frame<float>(*a, st);
}

// sizeof(QttsFrameArgs), for the wrapper's check of its ctypes mirror.
int qtts_frame_args_size() { return (int)sizeof(QttsFrameArgs); }

// The grid K7 launches with for these arguments (0 on an error).
int qtts_frame_grid(const QttsFrameArgs* a) {
  cudaError_t err;
  const size_t smem = frame_smem(*a);
  return a->cache_bf16 ? frame_grid<__nv_bfloat16>(smem, &err) : frame_grid<float>(smem, &err);
}

}  // extern "C"
