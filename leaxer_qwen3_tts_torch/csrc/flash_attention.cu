// Kernel K8: GQA flash attention with a float32 online softmax and a mask.
//
// Replaces leaxer_qwen3_tts_tpu/ops/flash_attention.py::flash_attend
// (_flash_kernel), the attention of the prefill under attn_impl="pallas".
// Same function: out[b, s, h] = sum_t p_t v[b, h / g, t] / sum_t p_t over the
// keys t the mask allows, with
//   * q scaled by 1/sqrt(D) of the true head_dim D, scores and P.V in
//     float32, the weights never rounded to bf16;
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
// Design.  A block is one (batch row, kv head, group of at most 16 of its q
// heads, tile of qt query positions): the block's gb q heads are stacked with
// the positions as its rows (row r: position s0 + r / gb, head kvh * g + h0 +
// r % gb; gb * qt <= 16, one m16 tile), so each K/V tile is read once for all
// of them.  gb = min(g, 16): a kv head of more than 16 q heads (g = 32) spreads
// them over ceil(g / 16) blocks, each reading the kv head's tiles.  qt comes
// from the wrapper (ops/flash_attention.py::query_tile): 16 / gb positions
// when that gives every SM a block, else 8 / gb, half an m16 tile and twice
// the blocks (the 1.7B prefill: ceil(57 / 4) x 8 = 120 blocks on 132 SMs, not
// 64).
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
// Head dims.  Each kernel is instantiated at a padded width DP of 64, 128 or
// 256 values and takes any head_dim D <= DP: the columns D .. DP - 1 of q, k
// and v are zero in the shared tiles (zero-filled copies), so they add exact
// zeros to every dot product, and the output writes columns below D only.  D
// a multiple of 8 copies 16-byte runs (cp.async); any other D copies value by
// value.  D = 80 and 96 run at DP = 128.  The presets' case (D = 128, at
// most 16 q heads per kv head) runs fa_tc_kernel_d128, the same function
// with every size a constant.
//
// bf16 inputs (the talker's prefill): one warp per 128 columns of the
// output (DP = 256: two warps).  Q, and each 64-key tile of K and V, are
// copied to shared memory as bf16 with cp.async by the block's threads, in
// rows padded to DP + 8 values (ldmatrix reads 8 rows at one column without
// bank conflicts), two tiles in flight: tile j + 1 loads while tile j is
// multiplied.  Scores: mma.sync m16n8k16 bf16 x bf16 -> float32 on the
// unscaled q and k (each product exact in float32), then times sm_scale;
// every warp forms the whole score tile (the same sums in the same order, so
// the same m and l), and multiplies P by its own 128 columns of V, so that
// no warp holds more than 64 accumulators (one warp of 256 columns would
// hold 128 beside its scores).  The q fragments stay in registers in
// one-warp blocks and are read from shared memory per k-step in two-warp
// ones.  The online max and sum stay per row in registers (quad shuffles).
// P.V: P is split into hi = bf16(P) and lo = bf16(P - hi), two MMAs against
// bf16 V, so the weights keep ~16 bits (a single bf16 P would not be this
// function).
// float32 inputs (only the checks run them on the card): CUDA-core
// arithmetic as the first K8 (TF32 would miss its float32 tolerance), 32-key
// tiles staged as float32, a lane per key, four rows per warp, with the
// stacked rows, the key range and the closed form above.  The card measured
// and its power limit are in PERF.md.

#include "qtts_kernels.cuh"

namespace {

constexpr int FA_ROWS = 16;  // stacked rows per block: one m16 tile
constexpr int FA_DMAX = 256;  // the widest padded head_dim
// bf16 kernel
constexpr int TC_DW = 128;  // output columns per warp
constexpr int TC_KT = 64;   // keys per tile
// float32 kernel
constexpr int F32_THREADS = 128;
constexpr int F32_RPW = FA_ROWS / (F32_THREADS / 32);  // rows per warp
constexpr int F32_KT = 32;                            // keys per tile: one per lane

struct FaScan {
  int first, last;  // the first and last key any of the block's positions allows (last < 0: none)
  uint32_t alive;   // bit p: position s0 + p allows a key
};

// Shared memory after the kernel's tiles: the closed form's sum [DP], the
// scan's result, and the mask bits [qt][nw] (bit j of word w of position p:
// mask[s0 + p][32 w + j]; zero past T and past S).
struct FaTail {
  float* vsum;
  FaScan* scan;
  uint32_t* words;
};

__host__ __device__ constexpr size_t fa_tail_bytes(int dp, int qt, int nw) {
  return dp * sizeof(float) + 16 + (size_t)qt * nw * sizeof(uint32_t);
}

__device__ __forceinline__ FaTail fa_tail(unsigned char* p, int dp) {
  FaTail t;
  t.vsum = reinterpret_cast<float*>(p);
  t.scan = reinterpret_cast<FaScan*>(p + dp * sizeof(float));
  t.words = reinterpret_cast<uint32_t*>(p + dp * sizeof(float) + 16);
  return t;
}

// The block's stacked rows: gb q heads of kv head kvh from head h0 on, at qt
// positions from s0 (gb = min(g, 16), h0 = (blockIdx.y % hsplit) * gb).
struct FaRows {
  int g, gb, h0, kvh;
  // row r's position offset, and whether it is a real (position, head) pair
  __device__ __forceinline__ int pos(int r) const { return r / gb; }
  __device__ __forceinline__ bool ok(int r, int qt, int np) const {
    return r < gb * qt && r / gb < np && h0 + r % gb < g;
  }
  __device__ __forceinline__ int head(int r) const { return kvh * g + h0 + r % gb; }
};

// a kv head of more than 16 q heads spreads them over blocks
__device__ __forceinline__ FaRows fa_rows(int nq, int nk) {
  FaRows f;
  f.g = nq / nk;
  f.gb = min(f.g, FA_ROWS);
  const int hsplit = (f.g + f.gb - 1) / f.gb;
  f.kvh = blockIdx.y / hsplit;
  f.h0 = (blockIdx.y % hsplit) * f.gb;
  return f;
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

// vsum[c] = sum_{t<T} v[t, c] in float32 over the D columns, in key order
// (the closed form of a row that allows no key); ends on a block barrier.
template <typename DT>
__device__ void fa_vsum(const DT* __restrict__ vb, int T, int D, float* vsum) {
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += fa_load(vb + (size_t)t * D + c);
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

// Columns col .. col + 7 of a bf16 row (row: its first value; D values) into
// shared memory, zero past D and where !ok: one 16-byte cp.async where D is a
// multiple of 8, else value by value.
__device__ __forceinline__ void fa_row8(__nv_bfloat16* dst, const __nv_bfloat16* row, int col,
                                        int D, bool ok) {
  if ((D & 7) == 0) {
    const bool in = ok && col < D;
    fa_cp16(dst, in ? row + col : row, in);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dst[e] = ok && col + e < D ? row[col + e] : __float2bfloat16_rn(0.f);
    }
  }
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

template <int DP>
size_t fa_tc_smem(int qt, int nw) {
  return (size_t)(FA_ROWS + 4 * TC_KT) * (DP + 8) * sizeof(__nv_bfloat16) +
         fa_tail_bytes(DP, qt, nw);
}

template <int DP>
__host__ __device__ constexpr int fa_tc_warps() {
  return DP > TC_DW ? DP / TC_DW : 1;
}

// Any head_dim D <= DP and any q-per-kv group (the presets' case, D = 128
// with at most 16 q heads per kv head, runs fa_tc_kernel_d128 below)
template <int DP>
__global__ void __launch_bounds__(32 * fa_tc_warps<DP>())
fa_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int S, int nq, int nk, int T, int Tp, int qt,
             int nw, int D, float sm_scale) {
  constexpr int LD = DP + 8;                 // shared row of bf16 values
  constexpr int NW = fa_tc_warps<DP>();      // warps: one per TC_DW output columns
  constexpr int DW = DP / NW;                // this warp's output columns
  constexpr bool QREG = NW == 1;             // q's fragments kept in registers
  extern __shared__ __align__(128) unsigned char fa_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(fa_smem);  // [FA_ROWS][LD]
  __nv_bfloat16* k_s = q_s + FA_ROWS * LD;                         // [2][TC_KT][LD]
  __nv_bfloat16* v_s = k_s + 2 * TC_KT * LD;                       // [2][TC_KT][LD]
  const FaTail tl = fa_tail(reinterpret_cast<unsigned char*>(v_s + 2 * TC_KT * LD), DP);
  const FaRows fr = fa_rows(nq, nk);
  const int b = blockIdx.z;
  const int s0 = blockIdx.x * qt, np = min(qt, S - s0);
  const int tid = threadIdx.x, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int c0 = NW == 1 ? 0 : (tid >> 5) * DW;  // this warp's first output column

  // the block's q rows (zero past its rows, past S and past D)
  for (int c = tid; c < FA_ROWS * (DP / 8); c += 32 * NW) {
    const int r = c / (DP / 8), col = (c % (DP / 8)) * 8;
    const bool ok = fr.ok(r, qt, np);
    const __nv_bfloat16* row = ok ? q + (((size_t)b * S + s0 + fr.pos(r)) * nq + fr.head(r)) * D : q;
    fa_row8(q_s + r * LD + col, row, col, D, ok);
  }
  fa_cp_commit();
  fa_scan_mask(mask + ((size_t)b * S + s0) * T, np, qt, T, nw, tl);
  const FaScan sc = *tl.scan;
  const int lo = sc.last >= 0 ? sc.first / TC_KT : 0;
  const int hi = sc.last >= 0 ? sc.last / TC_KT : -1;
  const __nv_bfloat16* kb = k + ((size_t)b * nk + fr.kvh) * T * D;
  const __nv_bfloat16* vb = v + ((size_t)b * nk + fr.kvh) * T * D;

  // key tile j into buffer buf (keys past T and columns past D zero-filled)
  auto load_tile = [&](int j, int buf) {
    __nv_bfloat16* kd = k_s + buf * TC_KT * LD;
    __nv_bfloat16* vd = v_s + buf * TC_KT * LD;
    for (int c = tid; c < TC_KT * (DP / 8); c += 32 * NW) {
      const int key = c / (DP / 8), col = (c % (DP / 8)) * 8, t = j * TC_KT + key;
      const bool ok = t < T;
      const size_t off = ok ? (size_t)t * D : 0;
      fa_row8(kd + key * LD + col, kb + off, col, D, ok);
      fa_row8(vd + key * LD + col, vb + off, col, D, ok);
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
    pos[h] = fr.pos(r);
    row_ok[h] = fr.ok(r, qt, np);
  }
  float m[2] = {QTTS_NEG_INF, QTTS_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DW / 8][4];
#pragma unroll
  for (int dn = 0; dn < DW / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  uint32_t qa[QREG ? DP / 16 : 1][4];
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const __nv_bfloat16* q_frag = q_s + ((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;

  for (int j = lo; j <= hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j < hi) {
      load_tile(j + 1, buf ^ 1);  // the buffer tile j - 1 was read from
      fa_cp_wait<1>();
    } else {
      fa_cp_wait<0>();
    }
    __syncthreads();  // every thread's copies of q and tile j have landed
    if constexpr (QREG) {
      if (j == lo) {
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) fa_ldm_x4(qa[ks], q_frag + 16 * ks);
      }
    }
    const __nv_bfloat16* kt = k_s + buf * TC_KT * LD;
    const __nv_bfloat16* vt = v_s + buf * TC_KT * LD;

    // scores: S = q k^T over the tile's 64 keys (n-tile nt: keys 8 nt .. 8 nt + 7)
    float s[TC_KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < TC_KT / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t qf[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[ks][e];
      } else {
        fa_ldm_x4(qf, q_frag + 16 * ks);
      }
#pragma unroll
      for (int n2 = 0; n2 < TC_KT / 16; ++n2) {
        uint32_t bk[4];
        fa_ldm_x4(bk, kt + (16 * n2 + (mi >> 1) * 8 + mr) * LD + 16 * ks + (mi & 1) * 8);
        fa_mma(s[2 * n2], qf, bk[0], bk[1]);
        fa_mma(s[2 * n2 + 1], qf, bk[2], bk[3]);
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
    for (int dn = 0; dn < DW / 8; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];
    }
    // P.V over this warp's columns: the C fragments of key n-tiles 2 kk and
    // 2 kk + 1 are the A fragment of k-step kk; P as hi + lo
#pragma unroll
    for (int kk = 0; kk < TC_KT / 16; ++kk) {
      uint32_t ph[4], pl[4];
      fa_split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      fa_split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      fa_split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      fa_split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp) {
        uint32_t bv[4];
        fa_ldm_x4_t(bv, vt + (16 * kk + (mi & 1) * 8 + mr) * LD + c0 + 16 * dp + (mi >> 1) * 8);
        fa_mma(acc[2 * dp], ph, bv[0], bv[1]);
        fa_mma(acc[2 * dp + 1], ph, bv[2], bv[3]);
        fa_mma(acc[2 * dp], pl, bv[0], bv[1]);
        fa_mma(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before tile j + 2 refills it
  }
  fa_cp_wait<0>();  // q's copy, where no tile was visited

  const uint32_t dead = (np >= 32 ? 0xffffffffu : (1u << np) - 1u) & ~sc.alive;
  if (dead) fa_vsum(vb, T, D, tl.vsum);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int r = gid + 8 * h;
    const bool alive = (sc.alive >> pos[h]) & 1u;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * S + s0 + pos[h]) * nq + fr.head(r)) * D;
#pragma unroll
    for (int dn = 0; dn < DW / 8; ++dn) {
      const int d = c0 + 8 * dn + 2 * tig;
      if (d >= D) continue;
      const float o0 = alive ? acc[dn][2 * h] / denom : tl.vsum[d] / (float)Tp;
      if ((D & 1) == 0) {
        const float o1 = alive ? acc[dn][2 * h + 1] / denom : tl.vsum[d + 1] / (float)Tp;
        *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(o0, o1);
      } else {
        o[d] = __float2bfloat16_rn(o0);
        if (d + 1 < D) {
          o[d + 1] = __float2bfloat16_rn(alive ? acc[dn][2 * h + 1] / denom
                                               : tl.vsum[d + 1] / (float)Tp);
        }
      }
    }
  }
}

// The presets' case: D = 128 and at most 16 q heads per kv head (a block
// holds all g of them; blockIdx.y is the kv head), every size a constant.
// The generic kernel at DP = 128 ran this case ~10% slower, so it keeps a
// body of its own.
constexpr int FA_D = 128;
constexpr int TC_THREADS = 32;
constexpr int TC_LD = FA_D + 8;  // shared row of bf16 values: 272 bytes

size_t fa_tc_d128_smem(int qt, int nw) {
  return (size_t)(FA_ROWS + 4 * TC_KT) * TC_LD * sizeof(__nv_bfloat16) +
         fa_tail_bytes(FA_D, qt, nw);
}

__global__ void __launch_bounds__(TC_THREADS)
fa_tc_kernel_d128(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int S, int nq, int nk, int T, int Tp, int qt,
             int nw, float sm_scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(fa_smem);  // [FA_ROWS][TC_LD]
  __nv_bfloat16* k_s = q_s + FA_ROWS * TC_LD;                      // [2][TC_KT][TC_LD]
  __nv_bfloat16* v_s = k_s + 2 * TC_KT * TC_LD;                    // [2][TC_KT][TC_LD]
  const FaTail tl = fa_tail(reinterpret_cast<unsigned char*>(v_s + 2 * TC_KT * TC_LD), FA_D);
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
  if (dead) fa_vsum(vb, T, FA_D, tl.vsum);
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

template <int DP>
size_t fa_f32_smem(int qt, int nw) {
  return ((size_t)FA_ROWS * DP + F32_KT * (DP + 1) + F32_KT * DP) * sizeof(float) +
         fa_tail_bytes(DP, qt, nw);
}

template <int DP>
__global__ void __launch_bounds__(F32_THREADS)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ mask,
              float* __restrict__ out, int S, int nq, int nk, int T, int Tp, int qt, int nw,
              int D, float sm_scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* q_s = reinterpret_cast<float*>(fa_smem);  // [FA_ROWS][DP], scaled
  float* k_s = q_s + FA_ROWS * DP;                 // [F32_KT][DP + 1]
  float* v_s = k_s + F32_KT * (DP + 1);            // [F32_KT][DP]
  const FaTail tl = fa_tail(reinterpret_cast<unsigned char*>(v_s + F32_KT * DP), DP);
  const FaRows fr = fa_rows(nq, nk);
  const int b = blockIdx.z;
  const int s0 = blockIdx.x * qt, np = min(qt, S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < FA_ROWS * DP; i += F32_THREADS) {
    const int r = i / DP, c = i % DP;
    q_s[i] = fr.ok(r, qt, np) && c < D
                 ? q[(((size_t)b * S + s0 + fr.pos(r)) * nq + fr.head(r)) * D + c] * sm_scale
                 : 0.f;
  }
  fa_scan_mask(mask + ((size_t)b * S + s0) * T, np, qt, T, nw, tl);
  const FaScan sc = *tl.scan;
  const int t_lo = sc.last >= 0 ? sc.first / F32_KT * F32_KT : 0;
  const int t_end = sc.last >= 0 ? sc.last / F32_KT * F32_KT + F32_KT : 0;
  const float* kb = k + ((size_t)b * nk + fr.kvh) * T * D;
  const float* vb = v + ((size_t)b * nk + fr.kvh) * T * D;

  float m[F32_RPW], l[F32_RPW], acc[F32_RPW][DP / 32];
#pragma unroll
  for (int rr = 0; rr < F32_RPW; ++rr) {
    m[rr] = QTTS_NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < DP / 32; ++e) acc[rr][e] = 0.f;
  }
  for (int t0 = t_lo; t0 < t_end; t0 += F32_KT) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < F32_KT * DP; i += F32_THREADS) {
      const int j = i / DP, c = i % DP, t = t0 + j;
      const bool in = t < T && c < D;
      k_s[j * (DP + 1) + c] = in ? kb[(size_t)t * D + c] : 0.f;
      v_s[j * DP + c] = in ? vb[(size_t)t * D + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < F32_RPW; ++rr) {
      const int r = warp * F32_RPW + rr, p = fr.pos(r);
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < DP; ++c) dot = fmaf(q_s[r * DP + c], k_s[lane * (DP + 1) + c], dot);
      const bool keep =
          fr.ok(r, qt, np) && ((tl.words[(size_t)p * nw + t0 / 32] >> lane) & 1u) != 0;
      const float sc_ = keep ? dot : QTTS_NEG_INF;
      const float mn = fmaxf(m[rr], qtts_warp_reduce(sc_, QttsMaxF()));
      const float pr = expf(sc_ - mn);
      const float alpha = expf(m[rr] - mn);
      l[rr] = l[rr] * alpha + qtts_warp_reduce(pr, QttsSumF());
      float pv[DP / 32];
#pragma unroll
      for (int e = 0; e < DP / 32; ++e) pv[e] = 0.f;
      for (int jj = 0; jj < F32_KT; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pr, jj);
#pragma unroll
        for (int e = 0; e < DP / 32; ++e) pv[e] = fmaf(pj, v_s[jj * DP + lane + 32 * e], pv[e]);
      }
#pragma unroll
      for (int e = 0; e < DP / 32; ++e) acc[rr][e] = acc[rr][e] * alpha + pv[e];
      m[rr] = mn;
    }
  }
  const uint32_t dead = (np >= 32 ? 0xffffffffu : (1u << np) - 1u) & ~sc.alive;
  if (dead) fa_vsum(vb, T, D, tl.vsum);
#pragma unroll
  for (int rr = 0; rr < F32_RPW; ++rr) {
    const int r = warp * F32_RPW + rr, p = fr.pos(r);
    if (!fr.ok(r, qt, np)) continue;
    const bool alive = (sc.alive >> p) & 1u;
    const float denom = fmaxf(l[rr], 1e-30f);
    float* o = out + (((size_t)b * S + s0 + p) * nq + fr.head(r)) * D;
#pragma unroll
    for (int e = 0; e < DP / 32; ++e) {
      const int d = lane + 32 * e;
      if (d < D) o[d] = alive ? acc[rr][e] / denom : tl.vsum[d] / (float)Tp;
    }
  }
}

using FaTcFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                        const uint8_t*, __nv_bfloat16*, int, int, int, int, int, int, int, int,
                        float);
using FaF32Fn = void (*)(const float*, const float*, const float*, const uint8_t*, float*, int,
                         int, int, int, int, int, int, int, float);

}  // namespace

extern "C" {

// Kernel K8 entry: out [B, S, nq, D] = flash attention of q [B, S, nq, D]
// over k, v [B, nk, T, D] (head-major) under mask [B, S, T] (bytes, 0 or
// 1), every tensor bf16 (bf16 = 1: tensor cores) or float32, 1 <= D <= 256
// (run at a padded width of 64, 128 or 256); Tp >= T is the JAX kernel's
// padded key count (the closed form's divisor), qt the query positions per
// block (ops/flash_attention.py::query_tile; min(nq / nk, 16) * qt <= 16).
int qtts_flash_attend(const void* q, const void* k, const void* v, const uint8_t* mask,
                      void* out, int B, int S, int nq, int nk, int T, int Tp, int qt, int D,
                      int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Tp < T || nk < 1 || nq % nk != 0 || qt < 1 || D < 1 ||
      D > FA_DMAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int g = nq / nk, gb = g < FA_ROWS ? g : FA_ROWS, hsplit = (g + gb - 1) / gb;
  if (gb * qt > FA_ROWS) return (int)cudaErrorInvalidValue;
  const int nw = 2 * ((T + TC_KT - 1) / TC_KT);  // 32-key mask words per position
  const int w = D <= 64 ? 0 : D <= 128 ? 1 : 2;  // the padded width: 64, 128 or 256
  const bool d128 = D == FA_D && g <= FA_ROWS;    // the presets' case
  static const FaTcFn tc[3] = {fa_tc_kernel<64>, fa_tc_kernel<128>, fa_tc_kernel<256>};
  static const FaF32Fn f32[3] = {fa_f32_kernel<64>, fa_f32_kernel<128>, fa_f32_kernel<256>};
  const size_t smem = bf16 ? (d128 ? fa_tc_d128_smem(qt, nw)
                              : w == 0 ? fa_tc_smem<64>(qt, nw)
                              : w == 1 ? fa_tc_smem<128>(qt, nw) : fa_tc_smem<256>(qt, nw))
                           : (w == 0 ? fa_f32_smem<64>(qt, nw)
                              : w == 1 ? fa_f32_smem<128>(qt, nw) : fa_f32_smem<256>(qt, nw));
  static int max_smem = 0;  // the opt-in limit, set once for every kernel
  if (max_smem == 0) {
    int dev = 0, limit = 0;
    QTTS_TRY(cudaGetDevice(&dev));
    QTTS_TRY(cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    QTTS_TRY(cudaFuncSetAttribute(fa_tc_kernel_d128, attr, limit));
    for (int i = 0; i < 3; ++i) {
      QTTS_TRY(cudaFuncSetAttribute(tc[i], attr, limit));
      QTTS_TRY(cudaFuncSetAttribute(f32[i], attr, limit));
    }
    max_smem = limit;
  }
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + qt - 1) / qt, nk * hsplit, B);
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  if (bf16 && d128) {
    fa_tc_kernel_d128<<<grid, TC_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), S, nq, nk,
        T, Tp, qt, nw, sm_scale);
  } else if (bf16) {
    const int threads = 32 * (w == 2 ? fa_tc_warps<256>() : 1);
    tc[w]<<<grid, threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), S, nq, nk,
        T, Tp, qt, nw, D, sm_scale);
  } else {
    f32[w]<<<grid, F32_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        mask, static_cast<float*>(out), S, nq, nk, T, Tp, qt, nw, D, sm_scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
