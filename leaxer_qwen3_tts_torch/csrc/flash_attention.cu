// Kernel K8: GQA flash attention with a float32 online softmax and a mask.
//
// Replaces leaxer_qwen3_tts_tpu/ops/flash_attention.py::flash_attend
// (_flash_kernel), the attention of the prefill under attn_impl="pallas".
// Same function: out[b, s, h] = sum_t p_t v[b, h / g, t] / sum_t p_t over the
// keys t the mask allows, with
//   * q scaled by 1/sqrt(D), scores and P.V in float32, the weights never
//     rounded to bf16;
//   * a masked score of -1e30 (finite), so a row masked everywhere ends with
//     l = Tp (the JAX kernel's padded key count) and the sum of V: its output
//     is sum_{t<T} v_t / Tp, as the JAX kernel's is;
//   * out = acc / max(l, 1e-30), cast to the dtype of q.
//
// What bounds it on the H100 (NVIDIA data sheet, SXM): at the 1.7B prefill
// (B=1, S=57, T=256, nq=16, nk=8, D=128, bf16) the bytes it must move (q, the
// out rows, the mask, and the k and v rows some query attends) are ~0.7 MB,
// ~0.2 us at 3.35 TB/s, against ~0.01 us of bf16 tensor-core operations.  At
// that size a call is latency: a launch, a mask scan, one or two rounds of
// copies, a few dozen MMAs per warp.
//
// Design.  A block is one (batch row, kv head, tile of qt query positions):
// the g = nq / nk q heads of its kv head are stacked with the positions as
// its rows (row r: position s0 + r / g, head kvh * g + r % g; g * qt <= 16,
// one m16 tile), so each K/V tile is read once for all g heads.  qt comes from
// the wrapper (ops/flash_attention.py::query_tile): 16 / g positions when that
// gives every SM a block, else 8 / g, half an m16 tile and twice the blocks
// (the 1.7B prefill: ceil(57 / 4) x 8 = 120 blocks on 132 SMs, not 64).
// Before its loop a block reads its positions' mask bytes into bit words in
// shared memory, and from them the first and last key tile in which any of
// its rows allows a key, and which positions allow no key; it visits only that
// range (key_schedule in the Python module is the same schedule).  Exact: in
// a tile past a row's last allowed key its m is finite, so p = exp(-1e30 - m)
// = 0 and alpha = 1; the terms a row adds before its first allowed key are
// wiped by alpha = exp(-1e30 - m) = 0 there.  Rows that allow no key take the
// closed form sum_{t<T} v_t / Tp in float32, summed only in blocks that have
// such a row.
//
// bf16 inputs (the talker's prefill): one warp per block.  Q, and each
// 64-key tile of K and V, are copied to shared memory as bf16 with cp.async,
// in rows padded to 136 values (ldmatrix reads 8 rows at one column without
// bank conflicts), two tiles in flight: tile j + 1 loads while tile j is
// multiplied.  Scores: mma.sync m16n8k16 bf16 x bf16 -> float32 on the
// unscaled q and k (each product exact in float32), then times sm_scale.  The
// online max and sum stay per row in registers (quad shuffles).  P.V: P is
// split into hi = bf16(P) and lo = bf16(P - hi), two MMAs against bf16 V, so
// the weights keep ~16 bits (a single bf16 P would not be this function).
// float32 inputs (only the checks run them on the card): CUDA-core
// arithmetic as the first K8 (TF32 would miss its float32 tolerance), 32-key
// tiles staged as float32, a lane per key, four rows per warp, with the
// stacked rows, the key range and the closed form above.  The card measured
// and its power limit are in PERF.md.

#include "qtts_kernels.cuh"

namespace {

constexpr int FA_D = 128;
constexpr int FA_ROWS = 16;  // stacked rows per block: one m16 tile
// bf16 kernel
constexpr int TC_THREADS = 32;
constexpr int TC_KT = 64;         // keys per tile
constexpr int TC_LD = FA_D + 8;   // shared row of bf16 values: 272 bytes
// float32 kernel
constexpr int F32_THREADS = 128;
constexpr int F32_RPW = FA_ROWS / (F32_THREADS / 32);  // rows per warp
constexpr int F32_KT = 32;                            // keys per tile: one per lane

struct FaScan {
  int first, last;  // the first and last key any of the block's positions allows (last < 0: none)
  uint32_t alive;   // bit p: position s0 + p allows a key
};

// Shared memory after the kernel's tiles: the closed form's sum [D], the
// scan's result, and the mask bits [qt][nw] (bit j of word w of position p:
// mask[s0 + p][32 w + j]; zero past T and past S).
struct FaTail {
  float* vsum;
  FaScan* scan;
  uint32_t* words;
};

__host__ __device__ constexpr size_t fa_tail_bytes(int qt, int nw) {
  return FA_D * sizeof(float) + 16 + (size_t)qt * nw * sizeof(uint32_t);
}

__device__ __forceinline__ FaTail fa_tail(unsigned char* p) {
  FaTail t;
  t.vsum = reinterpret_cast<float*>(p);
  t.scan = reinterpret_cast<FaScan*>(p + FA_D * sizeof(float));
  t.words = reinterpret_cast<uint32_t*>(p + FA_D * sizeof(float) + 16);
  return t;
}

// The block's mask rows (mb: [np, T] of them) as bit words, and from them
// FaScan; every thread of the block calls it, and it ends on a block barrier.
__device__ void fa_scan_mask(const uint8_t* __restrict__ mb, int np, int qt, int T, int nw,
                             const FaTail& tl) {
  // words per warp per round: their byte loads are issued together (the
  // 1.7B prefill's block, 4 positions x 8 words, takes two rounds)
  constexpr int U = 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) *tl.scan = FaScan{0x7fffffff, -1, 0u};
  __syncthreads();
  int first = 0x7fffffff, last = -1;
  uint32_t alive = 0;
  const int n = qt * nw;
  for (int i0 = warp; i0 < n; i0 += U * nwarps) {
    bool on[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * nwarps, p = idx / nw, t = 32 * (idx % nw) + lane;
      on[u] = idx < n && p < np && t < T && mb[(size_t)p * T + t] != 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * nwarps;
      if (idx >= n) break;  // warp-uniform
      const uint32_t bits = __ballot_sync(0xffffffffu, on[u]);
      if (lane == 0) tl.words[idx] = bits;
      if (bits) {
        const int w = idx % nw;
        first = min(first, 32 * w + __ffs(bits) - 1);
        last = max(last, 32 * w + 31 - __clz(bits));
        alive |= 1u << (idx / nw);
      }
    }
  }
  if (lane == 0 && last >= 0) {
    atomicMin(&tl.scan->first, first);
    atomicMax(&tl.scan->last, last);
    atomicOr(&tl.scan->alive, alive);
  }
  __syncthreads();
}

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// vsum[c] = sum_{t<T} v[t, c] in float32, in key order (the closed form of a
// row that allows no key); ends on a block barrier.
template <typename DT>
__device__ void fa_vsum(const DT* __restrict__ vb, int T, float* vsum) {
  for (int c = threadIdx.x; c < FA_D; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += fa_load(vb + (size_t)t * FA_D + c);
    vsum[c] = s;
  }
  __syncthreads();
}

// ---- bf16: tensor cores ----

__device__ __forceinline__ uint32_t fa_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled where !pred (then src is not read)
__device__ __forceinline__ void fa_cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fa_smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void fa_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fa_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fa_ldm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fa_smem_addr(p)));
}
__device__ __forceinline__ void fa_ldm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fa_smem_addr(p)));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), float32 accumulators
__device__ __forceinline__ void fa_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t fa_pack(__nv_bfloat16 lo16, __nv_bfloat16 hi16) {
  return (uint32_t)__bfloat16_as_ushort(lo16) | ((uint32_t)__bfloat16_as_ushort(hi16) << 16);
}

// P's pair (x, y) as bf16 hi = bf16(P) and lo = bf16(P - hi), packed for the A operand
__device__ __forceinline__ void fa_split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = fa_pack(hx, hy);
  lo = fa_pack(__float2bfloat16_rn(x - __bfloat162float(hx)),
               __float2bfloat16_rn(y - __bfloat162float(hy)));
}

__device__ __forceinline__ float fa_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float fa_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

size_t fa_tc_smem(int qt, int nw) {
  return (size_t)(FA_ROWS + 4 * TC_KT) * TC_LD * sizeof(__nv_bfloat16) + fa_tail_bytes(qt, nw);
}

__global__ void __launch_bounds__(TC_THREADS)
fa_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int S, int nq, int nk, int T, int Tp, int qt,
             int nw, float sm_scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(fa_smem);  // [FA_ROWS][TC_LD]
  __nv_bfloat16* k_s = q_s + FA_ROWS * TC_LD;                      // [2][TC_KT][TC_LD]
  __nv_bfloat16* v_s = k_s + 2 * TC_KT * TC_LD;                    // [2][TC_KT][TC_LD]
  const FaTail tl = fa_tail(reinterpret_cast<unsigned char*>(v_s + 2 * TC_KT * TC_LD));
  const int g = nq / nk, kvh = blockIdx.y, b = blockIdx.z;
  const int s0 = blockIdx.x * qt, np = min(qt, S - s0), R = g * qt;
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;

  // the block's q rows (zero past its rows and past S)
  for (int c = lane; c < FA_ROWS * (FA_D / 8); c += TC_THREADS) {
    const int r = c / (FA_D / 8), col = (c % (FA_D / 8)) * 8, p = r / g;
    const bool ok = r < R && p < np;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * S + s0 + p) * nq + kvh * g + r % g) * FA_D + col : q;
    fa_cp16(q_s + r * TC_LD + col, src, ok);
  }
  fa_cp_commit();
  fa_scan_mask(mask + ((size_t)b * S + s0) * T, np, qt, T, nw, tl);
  const FaScan sc = *tl.scan;
  const int lo = sc.last >= 0 ? sc.first / TC_KT : 0;
  const int hi = sc.last >= 0 ? sc.last / TC_KT : -1;
  const __nv_bfloat16* kb = k + ((size_t)b * nk + kvh) * T * FA_D;
  const __nv_bfloat16* vb = v + ((size_t)b * nk + kvh) * T * FA_D;

  // key tile j into buffer buf (keys past T zero-filled)
  auto load_tile = [&](int j, int buf) {
    __nv_bfloat16* kd = k_s + buf * TC_KT * TC_LD;
    __nv_bfloat16* vd = v_s + buf * TC_KT * TC_LD;
    for (int c = lane; c < TC_KT * (FA_D / 8); c += TC_THREADS) {
      const int key = c / (FA_D / 8), col = (c % (FA_D / 8)) * 8, t = j * TC_KT + key;
      const bool ok = t < T;
      const size_t off = ok ? (size_t)t * FA_D + col : 0;
      fa_cp16(kd + key * TC_LD + col, kb + off, ok);
      fa_cp16(vd + key * TC_LD + col, vb + off, ok);
    }
    fa_cp_commit();
  };
  if (lo <= hi) load_tile(lo, 0);

  // this thread's rows: gid (h = 0) and gid + 8 (h = 1) of the m16 tile
  int pos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gid + 8 * h;
    pos[h] = r / g;
    row_ok[h] = r < R && pos[h] < np;
  }
  float m[2] = {QTTS_NEG_INF, QTTS_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[FA_D / 8][4];
#pragma unroll
  for (int dn = 0; dn < FA_D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  uint32_t qa[FA_D / 16][4];
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row

  for (int j = lo; j <= hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j < hi) {
      load_tile(j + 1, buf ^ 1);  // the buffer tile j - 1 was read from
      fa_cp_wait<1>();
    } else {
      fa_cp_wait<0>();
    }
    __syncthreads();  // every lane's copies of q and tile j have landed
    if (j == lo) {
#pragma unroll
      for (int ks = 0; ks < FA_D / 16; ++ks) {
        fa_ldm_x4(qa[ks], q_s + ((mi & 1) * 8 + mr) * TC_LD + 16 * ks + (mi >> 1) * 8);
      }
    }
    const __nv_bfloat16* kt = k_s + buf * TC_KT * TC_LD;
    const __nv_bfloat16* vt = v_s + buf * TC_KT * TC_LD;

    // scores: S = q k^T over the tile's 64 keys (n-tile nt: keys 8 nt .. 8 nt + 7)
    float s[TC_KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < TC_KT / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < FA_D / 16; ++ks) {
#pragma unroll
      for (int n2 = 0; n2 < TC_KT / 16; ++n2) {
        uint32_t bk[4];
        fa_ldm_x4(bk, kt + (16 * n2 + (mi >> 1) * 8 + mr) * TC_LD + 16 * ks + (mi & 1) * 8);
        fa_mma(s[2 * n2], qa[ks], bk[0], bk[1]);
        fa_mma(s[2 * n2 + 1], qa[ks], bk[2], bk[3]);
      }
    }
    // scale, mask, and the online softmax per row
    uint64_t bits[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* w = tl.words + (size_t)pos[h] * nw + 2 * j;
      bits[h] = row_ok[h] ? ((uint64_t)w[1] << 32) | w[0] : 0ull;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < TC_KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = 8 * nt + 2 * tig + (e & 1);
        s[nt][e] = (bits[h] >> key) & 1ull ? s[nt][e] * sm_scale : QTTS_NEG_INF;
        mx[h] = fmaxf(mx[h], s[nt][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fa_quad_max(mx[h]);
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < TC_KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + fa_quad_sum(rs[h]);
#pragma unroll
    for (int dn = 0; dn < FA_D / 8; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];
    }
    // P.V: the C fragments of key n-tiles 2 kk and 2 kk + 1 are the A fragment
    // of k-step kk; P as hi + lo
#pragma unroll
    for (int kk = 0; kk < TC_KT / 16; ++kk) {
      uint32_t ph[4], pl[4];
      fa_split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      fa_split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      fa_split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      fa_split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < FA_D / 16; ++dp) {
        uint32_t bv[4];
        fa_ldm_x4_t(bv, vt + (16 * kk + (mi & 1) * 8 + mr) * TC_LD + 16 * dp + (mi >> 1) * 8);
        fa_mma(acc[2 * dp], ph, bv[0], bv[1]);
        fa_mma(acc[2 * dp + 1], ph, bv[2], bv[3]);
        fa_mma(acc[2 * dp], pl, bv[0], bv[1]);
        fa_mma(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every lane is done with buffer buf before tile j + 2 refills it
  }
  fa_cp_wait<0>();  // q's copy, where no tile was visited

  const uint32_t dead = (np >= 32 ? 0xffffffffu : (1u << np) - 1u) & ~sc.alive;
  if (dead) fa_vsum(vb, T, tl.vsum);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int r = gid + 8 * h;
    const bool alive = (sc.alive >> pos[h]) & 1u;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * S + s0 + pos[h]) * nq + kvh * g + r % g) * FA_D;
#pragma unroll
    for (int dn = 0; dn < FA_D / 8; ++dn) {
      const int d = 8 * dn + 2 * tig;
      const float o0 = alive ? acc[dn][2 * h] / denom : tl.vsum[d] / (float)Tp;
      const float o1 = alive ? acc[dn][2 * h + 1] / denom : tl.vsum[d + 1] / (float)Tp;
      *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(o0, o1);
    }
  }
}

// ---- float32: CUDA cores ----

size_t fa_f32_smem(int qt, int nw) {
  return ((size_t)FA_ROWS * FA_D + F32_KT * (FA_D + 1) + F32_KT * FA_D) * sizeof(float) +
         fa_tail_bytes(qt, nw);
}

__global__ void __launch_bounds__(F32_THREADS)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ mask,
              float* __restrict__ out, int S, int nq, int nk, int T, int Tp, int qt, int nw,
              float sm_scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* q_s = reinterpret_cast<float*>(fa_smem);  // [FA_ROWS][FA_D], scaled
  float* k_s = q_s + FA_ROWS * FA_D;               // [F32_KT][FA_D + 1]
  float* v_s = k_s + F32_KT * (FA_D + 1);          // [F32_KT][FA_D]
  const FaTail tl = fa_tail(reinterpret_cast<unsigned char*>(v_s + F32_KT * FA_D));
  const int g = nq / nk, kvh = blockIdx.y, b = blockIdx.z;
  const int s0 = blockIdx.x * qt, np = min(qt, S - s0), R = g * qt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < FA_ROWS * FA_D; i += F32_THREADS) {
    const int r = i / FA_D, c = i % FA_D, p = r / g;
    q_s[i] = r < R && p < np
                 ? q[(((size_t)b * S + s0 + p) * nq + kvh * g + r % g) * FA_D + c] * sm_scale
                 : 0.f;
  }
  fa_scan_mask(mask + ((size_t)b * S + s0) * T, np, qt, T, nw, tl);
  const FaScan sc = *tl.scan;
  const int t_lo = sc.last >= 0 ? sc.first / F32_KT * F32_KT : 0;
  const int t_end = sc.last >= 0 ? sc.last / F32_KT * F32_KT + F32_KT : 0;
  const float* kb = k + ((size_t)b * nk + kvh) * T * FA_D;
  const float* vb = v + ((size_t)b * nk + kvh) * T * FA_D;

  float m[F32_RPW], l[F32_RPW], acc[F32_RPW][FA_D / 32];
#pragma unroll
  for (int rr = 0; rr < F32_RPW; ++rr) {
    m[rr] = QTTS_NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < FA_D / 32; ++e) acc[rr][e] = 0.f;
  }
  for (int t0 = t_lo; t0 < t_end; t0 += F32_KT) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < F32_KT * FA_D; i += F32_THREADS) {
      const int j = i / FA_D, c = i % FA_D, t = t0 + j;
      k_s[j * (FA_D + 1) + c] = t < T ? kb[(size_t)t * FA_D + c] : 0.f;
      v_s[j * FA_D + c] = t < T ? vb[(size_t)t * FA_D + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < F32_RPW; ++rr) {
      const int r = warp * F32_RPW + rr, p = r / g;
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < FA_D; ++c) dot = fmaf(q_s[r * FA_D + c], k_s[lane * (FA_D + 1) + c], dot);
      const bool keep =
          r < R && p < np && ((tl.words[(size_t)p * nw + t0 / 32] >> lane) & 1u) != 0;
      const float sc_ = keep ? dot : QTTS_NEG_INF;
      const float mn = fmaxf(m[rr], qtts_warp_reduce(sc_, QttsMaxF()));
      const float pr = expf(sc_ - mn);
      const float alpha = expf(m[rr] - mn);
      l[rr] = l[rr] * alpha + qtts_warp_reduce(pr, QttsSumF());
      float pv[FA_D / 32];
#pragma unroll
      for (int e = 0; e < FA_D / 32; ++e) pv[e] = 0.f;
      for (int jj = 0; jj < F32_KT; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pr, jj);
#pragma unroll
        for (int e = 0; e < FA_D / 32; ++e) pv[e] = fmaf(pj, v_s[jj * FA_D + lane + 32 * e], pv[e]);
      }
#pragma unroll
      for (int e = 0; e < FA_D / 32; ++e) acc[rr][e] = acc[rr][e] * alpha + pv[e];
      m[rr] = mn;
    }
  }
  const uint32_t dead = (np >= 32 ? 0xffffffffu : (1u << np) - 1u) & ~sc.alive;
  if (dead) fa_vsum(vb, T, tl.vsum);
#pragma unroll
  for (int rr = 0; rr < F32_RPW; ++rr) {
    const int r = warp * F32_RPW + rr, p = r / g;
    if (r >= R || p >= np) continue;
    const bool alive = (sc.alive >> p) & 1u;
    const float denom = fmaxf(l[rr], 1e-30f);
    float* o = out + (((size_t)b * S + s0 + p) * nq + kvh * g + r % g) * FA_D;
#pragma unroll
    for (int e = 0; e < FA_D / 32; ++e) {
      const int d = lane + 32 * e;
      o[d] = alive ? acc[rr][e] / denom : tl.vsum[d] / (float)Tp;
    }
  }
}

}  // namespace

extern "C" {

// Kernel K8 entry: out [B, S, nq, 128] = flash attention of q [B, S, nq, 128]
// over k, v [B, nk, T, 128] (head-major) under mask [B, S, T] (bytes, 0 or
// 1), every tensor bf16 (bf16 = 1: tensor cores) or float32; Tp >= T is the
// JAX kernel's padded key count (the closed form's divisor), qt the query
// positions per block (ops/flash_attention.py::query_tile; g * qt <= 16).
int qtts_flash_attend(const void* q, const void* k, const void* v, const uint8_t* mask,
                      void* out, int B, int S, int nq, int nk, int T, int Tp, int qt, int bf16,
                      void* stream) {
  if (B < 1 || S < 1 || T < 1 || Tp < T || nk < 1 || nq % nk != 0 || qt < 1 ||
      (nq / nk) * qt > FA_ROWS) {
    return (int)cudaErrorInvalidValue;
  }
  const int nw = 2 * ((T + TC_KT - 1) / TC_KT);  // 32-key mask words per position
  const size_t smem = bf16 ? fa_tc_smem(qt, nw) : fa_f32_smem(qt, nw);
  static int max_smem = 0;  // the opt-in limit, set once for both kernels
  if (max_smem == 0) {
    int dev = 0, limit = 0;
    QTTS_TRY(cudaGetDevice(&dev));
    QTTS_TRY(cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    QTTS_TRY(cudaFuncSetAttribute(fa_tc_kernel, attr, limit));
    QTTS_TRY(cudaFuncSetAttribute(fa_f32_kernel, attr, limit));
    max_smem = limit;
  }
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + qt - 1) / qt, nk, B);
  const float sm_scale = (float)(1.0 / sqrt((double)FA_D));
  if (bf16) {
    fa_tc_kernel<<<grid, TC_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), S, nq, nk,
        T, Tp, qt, nw, sm_scale);
  } else {
    fa_f32_kernel<<<grid, F32_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        mask, static_cast<float*>(out), S, nq, nk, T, Tp, qt, nw, sm_scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
