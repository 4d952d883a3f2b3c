// Attention over key and query tiles streamed through shared memory on the
// CUDA cores, in fp32 FMA: the forward with an online softmax (K4's SIMT
// route) and the three passes of the attention backward (K5's SIMT route, and
// stages (3)-(5) of K3's SIMT chain).
//
//   attn_rows<kFwd>    o_i = T(sum_j T(p~_ij) v_j / l_i), p~ = exp(s - m_run),
//                      m and l carried across key tiles (online softmax).
//   attn_rows<kStats>  per query row: m_i, l_i and D_i = dO_i . o_i with
//                      unrounded fp32 p; D_i = sum_j p_ij dp_ij of the reference.
//   attn_rows<kDq>     p_ij = exp(s_ij - m_i) / l_i recomputed per key tile;
//                      dp = dO_i . v_j; ds = p (dp - D_i) scale; dq_i = sum ds k_j.
//                      With ROUND (K3): ds and p rounded to T, and the merged
//                      heads T(sum_j T(p_ij) v_j) written beside dq.
//   attn_cols          per key row j over query tiles: dv_j = sum_i p_ij dO_i,
//                      dk_j = sum_i ds_ij q_i (ROUND as above).
// Logits are (q . k) * scale in fp32; masked (causal) keys carry p == 0.
//
// What bounds them on the H100: fp32 on the tensor cores would be TF32, so
// every product runs as fp32 FMA on the CUDA cores, 2 T^2 dh operations a
// product and a head at 67 TFLOP/s, against 4-7 T dh floats moved: at T = 257
// about 30 operations a byte, so the FMA rate bounds them (36 us for the
// forward at [9, 16, 257, 64]). An SM's shared memory hands its threads 32
// floats a clock against 128 FMAs, so a pass that loads a 4-byte operand for
// each FMA (a lane a key, a whole dh-long dot product each) cannot pass ~1/8
// of that rate. What the design does about it:
//   - one block of 8 warps owns 64 query rows (attn_rows) or 64 key rows
//     (attn_cols) and streams the other side in 64-row tiles; each thread holds
//     a 4 x 4 register micro-tile of the [64, 64] panel of s (and of dp),
//     rows ty + 16 i, keys tx + 16 j, fed by 16-byte shared loads along the
//     head width: 2 FMAs for each float loaded, where the earlier passes did
//     half of one; key groups past a tile's last valid key are skipped;
//   - p (or ds) goes through a [64, 64] panel in shared memory to the output
//     product, where each thread owns a micro-tile of the 64 x dh output (4 x 4
//     at dh <= 64, 2 x 12 at dh <= 96, 4 x 8 at dh <= 128: OutTile) with 16-byte
//     loads of p along the keys and of v (k, q, dO) along the head width;
//   - rows are padded to an odd number of 16-byte chunks (tile_stride) so that
//     the 8 rows of a quarter-warp's 16-byte loads hit 32 distinct banks;
//   - the streamed tiles are copied by cp.async (16-byte copies, zeros past T;
//     the statistics by 4-byte copies) while other products compute: kFwd and
//     kStats through a ring of two (k, v) stages, kDq and attn_cols, which also
//     keep a second operand of their own rows, through one slot for each
//     streamed operand, refilled as soon as its tile is consumed (two blocks
//     of 88-105 KB an SM at dh = 64). Where a row is not 16-byte aligned or the
//     input is bf16 (widened to fp32 in shared memory), the threads copy the
//     same tiles with plain loads;
//   - warps whose rows all lie past T skip the products.
//
// The outputs are bit-equal to the earlier one-key-a-lane passes (a warp a
// row): each s and dp is one fmaf chain over c = 0 .. dh-1 from 0; each output
// one fmaf chain over the keys (queries) that its row takes, in order, a tile
// at a time; the row sum l adds p in the XOR-butterfly order of a warp whose
// lane L held keys L and L + 32, which the 16 threads of a panel row
// reproduce (a thread's keys tx, tx + 16, tx + 32, tx + 48 are those of lanes
// tx and tx + 16); D_i is a warp's lane-strided sum over c, as before. The
// arithmetic that the earlier code left to the compiler's contraction is
// written out (fmaf where a product fed an add in one expression, __fmul_rn,
// __fsub_rn and __fadd_rn where it did not), so the bits do not hang on how
// this code is laid out.
#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cct {

// Element (b, h, t, c) lives at base + b * sb + h * sh + t * st + c: one
// description for [B, T, 3D] qkv with heads at column offsets, [B, T, D]
// merged heads, and [B, H, T, dh] per-head arrays.
struct HeadView {
  long long sb, sh, st;
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // dO (kStats, kDq, cols)
  void* out;         // kFwd: o; kDq: dq; cols: dk
  void* out2;        // kDq with ROUND: merged; cols: dv
  float* m;          // per (b*H + h) * T + row statistics
  float* l;
  float* dsum;
  HeadView in, dov, ov, o2v;
  int n_heads, t_len, dh, causal;
  float scale;
  int vec;  // set by launch_tiles: fp32 rows copied in 16-byte chunks
};

constexpr int kTileThreads = 256;  // 8 warps
constexpr int kTile = 64;          // rows a block owns, and rows a streamed tile holds
constexpr int kMaxDh = 128;
constexpr int kRingStages = 2;     // ring stages of kFwd and kStats
constexpr int kPanel = kTile + 4;  // row stride of the [64, 64] p and ds panels

enum RowMode : int { kFwd = 0, kStats = 1, kDq = 2 };

// Row stride (floats) of a staged [64, dh] tile: an odd number of 16-byte chunks.
__host__ __device__ constexpr int tile_stride(int dh) { return (dh + 7) / 8 * 8 + 4; }

// The output micro-tile a thread owns by head-width class W: kRows rows (rg +
// (64 / kRows) i) by kChunks 16-byte column chunks (cg + kColThreads u).
template <int W>
struct OutTile;
template <>
struct OutTile<64> {
  static constexpr int kRows = 4, kChunks = 1;
};
template <>
struct OutTile<96> {
  static constexpr int kRows = 2, kChunks = 3;
};
template <>
struct OutTile<128> {
  static constexpr int kRows = 4, kChunks = 2;
};

inline int tile_width(int dh) { return dh <= 64 ? 64 : dh <= 96 ? 96 : 128; }

__device__ __forceinline__ long long head_base(const HeadView& v, int b, int h) {
  return (long long)b * v.sb + (long long)h * v.sh;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + 63 of one head (src: its base, rows st apart) into a tile of
// stride ks, widened to fp32, zeros past T. vec: 16-byte cp.async copies (fp32
// rows of 16-byte-aligned chunks), which the caller commits; else plain loads,
// zeros also past dh up to the next multiple of 4.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long st, int r0,
                                           int t_len, int dh, int ks, bool vec) {
  if constexpr (std::is_same_v<T, float>) {
    if (vec) {
      const int nc = dh >> 2;
      for (int e = threadIdx.x; e < kTile * nc; e += kTileThreads) {
        const int r = e / nc, c = (e - r * nc) << 2, row = r0 + r;
        const bool ok = row < t_len;
        cp_async16(dst + r * ks + c, src + (ok ? row * st + c : 0), ok);
      }
      return;
    }
  }
  const int dp = (dh + 3) & ~3;
  for (int e = threadIdx.x; e < kTile * dp; e += kTileThreads) {
    const int r = e / dp, c = e - r * dp, row = r0 + r;
    dst[r * ks + c] = row < t_len && c < dh ? to_f(src[row * st + c]) : 0.f;
  }
}

// acc[i][j] = one fmaf chain over c = 0 .. dh-1 of a[ty + 16 i][c] b[tx + 16 j][c],
// continuing from acc (0 for a fresh product), for the key groups j < NJ.
template <int NJ>
__device__ __forceinline__ void panel_product(float (&acc)[4][4], const float* a, const float* b,
                                              int ks, int dh, int tx, int ty) {
  const float* ar = a + ty * ks;
  const float* br = b + tx * ks;
  const int d4 = dh & ~3;
#pragma unroll 2
  for (int c = 0; c < d4; c += 4) {
    float4 av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(ar + 16 * i * ks + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = *reinterpret_cast<const float4*>(br + 16 * j * ks + c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = fmaf(f32_lane(av[i], e), f32_lane(bv[j], e), acc[i][j]);
  }
  for (int c = d4; c < dh; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = fmaf(ar[16 * i * ks + c], br[16 * j * ks + c], acc[i][j]);
  }
}

// The panel product over the first n keys (queries) of a streamed tile: the
// key groups j that hold one of them (the last tile of ViT-L/14's T = 257
// holds one key); the others stay 0 and are masked by the caller.
__device__ __forceinline__ void panel_product_n(float (&acc)[4][4], const float* a,
                                                const float* b, int ks, int dh, int tx, int ty,
                                                int n) {
  if (n > 48)
    panel_product<4>(acc, a, b, ks, dh, tx, ty);
  else if (n > 32)
    panel_product<3>(acc, a, b, ks, dh, tx, ty);
  else if (n > 16)
    panel_product<2>(acc, a, b, ks, dh, tx, ty);
  else
    panel_product<1>(acc, a, b, ks, dh, tx, ty);
}

// acc[i][u][e] += pan[row_i][jj] b[jj][4 chunk_u + e] as one fmaf chain over jj
// = 0 .. n-1 in order, rows rg + (64 / R) i, chunks cg + 4 R u below nch.
// EDGE: n at run time, and row i's chain stops at nt[i] (keys past its causal
// limit or past T add nothing); else all 64.
template <int R, int C, bool EDGE>
__device__ __forceinline__ void out_product(float (&acc)[R][C][4], const float* pan,
                                            const float* b, int ks, int n, const int (&nt)[R],
                                            int rg, int cg, int nch) {
  constexpr int kColThreads = 4 * R, kRowStep = kTile / R;
  const float* pr = pan + rg * kPanel;
  if (!EDGE) n = kTile;
#pragma unroll 2
  for (int j4 = 0; j4 < n; j4 += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      pv[i] = *reinterpret_cast<const float4*>(pr + i * kRowStep * kPanel + j4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = j4 + e;
      if (EDGE && jj >= n) break;
      const float* br = b + jj * ks + 4 * cg;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        if (cg + kColThreads * u >= nch) continue;
        const float4 bv = *reinterpret_cast<const float4*>(br + 4 * kColThreads * u);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (EDGE && jj >= nt[i]) continue;
          const float p = f32_lane(pv[i], e);
          acc[i][u][0] = fmaf(p, bv.x, acc[i][u][0]);
          acc[i][u][1] = fmaf(p, bv.y, acc[i][u][1]);
          acc[i][u][2] = fmaf(p, bv.z, acc[i][u][2]);
          acc[i][u][3] = fmaf(p, bv.w, acc[i][u][3]);
        }
      }
    }
  }
}

// The largest of v over the 16 threads of a panel row (lanes tx of one half-warp).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The row sum of p as a warp of the earlier passes summed it: lane L held
// p[L] + p[L + 32], then XOR steps 16, 8, 4, 2, 1. Here p[j] is key tx + 16 j,
// so lanes tx and tx + 16 live in one thread, and the steps 8 .. 1 run over tx.
__device__ __forceinline__ float row_sum16(const float (&p)[4]) {
  float v = __fadd_rn(__fadd_rn(p[0], p[2]), __fadd_rn(p[1], p[3]));
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (B*H, ceil(T / 64)): one block a (batch, head) and 64 query rows.
// kFwd and kStats stream k and v through a ring of two stages, the next tile's
// copies in flight while this one computes. kDq keeps q and dO as well, so it
// holds one slot for k and one for v, each refilled as soon as its tile is
// consumed (the other operand's products hide the copy): 88 KB at dh = 64, two
// blocks an SM.
template <typename T, int MODE, bool ROUND, int W>
__global__ void __launch_bounds__(kTileThreads, W == 64 ? 2 : 1) attn_rows_tile(AttnArgs a) {
  using O = OutTile<W>;
  constexpr int R = O::kRows, C = O::kChunks, kColThreads = 4 * R, kRowStep = kTile / R;
  constexpr bool kMerged = MODE == kDq && ROUND;
  extern __shared__ float4 attn_tile_smem[];
  float* sm = reinterpret_cast<float*>(attn_tile_smem);
  const int dh = a.dh, ks = tile_stride(dh), tile = kTile * ks, t_len = a.t_len;
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane & 15, ty = (tid >> 5) * 2 + (lane >> 4);  // panel micro-tile
  const int cg = tid % kColThreads, rg = tid / kColThreads;    // output micro-tile
  const int nch = (dh + 3) >> 2, row0 = blockIdx.y * kTile;
  const bool vec = a.vec;
  // warps whose rows all lie past T skip the products (the last block of
  // ViT-L/14's T = 257 holds one row); they still meet every barrier
  const bool panel_live = row0 + (tid >> 5) * 2 < t_len;
  const bool out_live = row0 + (tid & ~31) / kColThreads < t_len;

  float* q_s = sm;
  float* do_s = q_s + tile;                            // kDq
  float* ring = q_s + (MODE == kDq ? 2 : 1) * tile;    // kDq: the k and v slots
  float* pan = ring + (MODE == kDq ? 2 : 2 * kRingStages) * tile;   // p, or ds (kDq)
  float* pan2 = pan + kTile * kPanel;                  // p of merged (kDq with ROUND)
  float* row_corr = pan + (kMerged ? 2 : 1) * kTile * kPanel;
  float* row_m = row_corr + kTile;
  float* row_l = row_m + kTile;

  const T* q = static_cast<const T*>(a.q) + head_base(a.in, b, h);
  const T* k = static_cast<const T*>(a.k) + head_base(a.in, b, h);
  const T* v = static_cast<const T*>(a.v) + head_base(a.in, b, h);
  const T* dout = static_cast<const T*>(a.dout) + head_base(a.dov, b, h);

  // the panel rows' state: row ty + 16 i sees keys below lim (none past T)
  float m[4], l[4], dsum[4];
  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    lim[i] = row < t_len ? (a.causal ? row + 1 : t_len) : 0;
    m[i] = -FLT_MAX;
    l[i] = 0.f;
    dsum[i] = 0.f;
    if (MODE == kDq && row < t_len) {
      const size_t s = (size_t)bh * t_len + row;
      m[i] = a.m[s];
      l[i] = a.l[s];
      dsum[i] = a.dsum[s];
    }
  }
  float acc[R][C][4], acc2[R][C][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int u = 0; u < C; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][u][e] = acc2[i][u][e] = 0.f;

  const int last_row = min(t_len, row0 + kTile);
  const int n_keys = a.causal ? last_row : t_len;
  const int n_tiles = (n_keys + kTile - 1) / kTile;

  // the output rows' chains over keys j0 .. j0 + 63 of acc (pan x b_s)
  auto out_tile = [&](float (&dst)[R][C][4], const float* pn, const float* b_s, int j0) {
    if (!out_live) return;
    const bool edge = j0 + kTile > t_len || (a.causal && j0 + kTile > row0 + 1);
    if (!edge) {
      int all[R];
#pragma unroll
      for (int i = 0; i < R; ++i) all[i] = kTile;
      out_product<R, C, false>(dst, pn, b_s, ks, kTile, all, rg, cg, nch);
      return;
    }
    int nt[R];  // a row's keys in this tile: up to its causal limit, none past T
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + rg + kRowStep * i;
      const int lim_o = row < t_len ? (a.causal ? row + 1 : t_len) : 0;
      nt[i] = max(0, min(kTile, lim_o - j0));
    }
    out_product<R, C, true>(dst, pn, b_s, ks, min(kTile, n_keys - j0), nt, rg, cg, nch);
  };

  if constexpr (MODE != kDq) {
    stage_rows(q_s, q, a.in.st, row0, t_len, dh, ks, vec);
    stage_rows(ring, k, a.in.st, 0, t_len, dh, ks, vec);
    stage_rows(ring + tile, v, a.in.st, 0, t_len, dh, ks, vec);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * kTile;
      float* k_s = ring + (t % kRingStages) * 2 * tile;
      float* v_s = k_s + tile;
      cp_async_wait<0>();
      __syncthreads();  // tile t is in; every thread is done with tile t - 1
      if (t + 1 < n_tiles) {
        float* nk = ring + ((t + 1) % kRingStages) * 2 * tile;
        stage_rows(nk, k, a.in.st, j0 + kTile, t_len, dh, ks, vec);
        stage_rows(nk + tile, v, a.in.st, j0 + kTile, t_len, dh, ks, vec);
        cp_async_commit();
      }
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      if (panel_live) panel_product_n(s, q_s, k_s, ks, dh, tx, ty, n_keys - j0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float mx = -FLT_MAX;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = j0 + tx + 16 * j < lim[i] ? __fmul_rn(s[i][j], a.scale) : -FLT_MAX;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], row_max16(mx));
        const float corr = expf(__fsub_rn(m[i], m_new));
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = j0 + tx + 16 * j < lim[i] ? expf(__fsub_rn(s[i][j], m_new)) : 0.f;
        l[i] = fmaf(l[i], corr, row_sum16(p));
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pan[r * kPanel + tx + 16 * j] = MODE == kFwd ? round_to<T>(p[j]) : p[j];
        if (tx == 0) row_corr[r] = corr;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float corr = row_corr[rg + kRowStep * i];
#pragma unroll
        for (int u = 0; u < C; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][u][e] = __fmul_rn(acc[i][u][e], corr);
      }
      out_tile(acc, pan, v_s, j0);
    }
  } else {
    // Each slot is refilled once its tile is consumed, in an order that gives
    // every copy a product to hide behind: without ROUND dp (v) comes first and
    // v's slot refills behind s and dq; with ROUND s and dq (k) come first and
    // k's slot refills behind merged (v). The first operand's copies are the
    // older group at the top of a tile, so wait_group 1 waits for them alone.
    float* k_s = ring;
    float* v_s = ring + tile;
    float* first = ROUND ? k_s : v_s;
    float* second = ROUND ? v_s : k_s;
    const T* first_src = ROUND ? k : v;
    const T* second_src = ROUND ? v : k;
    stage_rows(q_s, q, a.in.st, row0, t_len, dh, ks, vec);
    stage_rows(do_s, dout, a.dov.st, row0, t_len, dh, ks, vec);
    stage_rows(first, first_src, a.in.st, 0, t_len, dh, ks, vec);
    cp_async_commit();
    stage_rows(second, second_src, a.in.st, 0, t_len, dh, ks, vec);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * kTile;
      const bool more = t + 1 < n_tiles;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      cp_async_wait<1>();
      __syncthreads();  // the first operand's tile is in
      if (panel_live) {
        if (ROUND)
          panel_product_n(s, q_s, k_s, ks, dh, tx, ty, n_keys - j0);
        else
          panel_product_n(dp, do_s, v_s, ks, dh, tx, ty, n_keys - j0);
      }
      cp_async_wait<0>();
      __syncthreads();  // the second is in; v's slot is free without ROUND
      if (!ROUND && more) {
        stage_rows(v_s, v, a.in.st, j0 + kTile, t_len, dh, ks, vec);
        cp_async_commit();
      }
      if (panel_live) {
        if (ROUND)
          panel_product_n(dp, do_s, v_s, ks, dh, tx, ty, n_keys - j0);
        else
          panel_product_n(s, q_s, k_s, ks, dh, tx, ty, n_keys - j0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (j0 + key < lim[i]) {
            p = expf(__fsub_rn(__fmul_rn(s[i][j], a.scale), m[i])) / l[i];
            ds = p * (dp[i][j] - dsum[i]) * a.scale;
            if (ROUND) {
              ds = round_to<T>(ds);
              p = round_to<T>(p);
            }
          }
          pan[r * kPanel + key] = ds;
          if (kMerged) pan2[r * kPanel + key] = p;
        }
      }
      __syncthreads();
      out_tile(acc, pan, k_s, j0);  // dq
      if (more) {
        __syncthreads();
        stage_rows(k_s, k, a.in.st, j0 + kTile, t_len, dh, ks, vec);
        cp_async_commit();
      }
      if constexpr (kMerged) {
        out_tile(acc2, pan2, v_s, j0);
        if (more) {
          __syncthreads();
          stage_rows(v_s, v, a.in.st, j0 + kTile, t_len, dh, ks, vec);
          cp_async_commit();
        }
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      row_m[ty + 16 * i] = m[i];
      row_l[ty + 16 * i] = l[i];
    }
  }
  __syncthreads();

  if constexpr (MODE == kStats) {
    // D_i = dO_i . (acc_i / l_i): o through shared memory, then a warp a row
    // sums lanes c = L, L + 32, ... as the earlier passes did.
    float* o_s = ring;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rg + kRowStep * i;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int c = 4 * (cg + kColThreads * u);
        if (c >= dh) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) o_s[r * ks + c + e] = acc[i][u][e] / row_l[r];
      }
    }
    __syncthreads();
    for (int r = tid >> 5; r < kTile; r += kTileThreads / 32) {
      const int row = row0 + r;
      if (row >= t_len) break;
      float dd = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxDh / 32; ++u) {
        const int c = lane + 32 * u;
        if (c < dh) dd = fmaf(to_f(dout[row * a.dov.st + c]), o_s[r * ks + c], dd);
      }
      dd = warp_sum(dd);
      if (lane == 0) {
        const size_t s = (size_t)bh * t_len + row;
        a.m[s] = row_m[r];
        a.l[s] = row_l[r];
        a.dsum[s] = dd;
      }
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = rg + kRowStep * i, row = row0 + r;
    if (row >= t_len) continue;
    T* o = static_cast<T*>(a.out) + head_base(a.ov, b, h) + row * a.ov.st;
    T* o2 = static_cast<T*>(a.out2) + head_base(a.o2v, b, h) + row * a.o2v.st;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int c0 = 4 * (cg + kColThreads * u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c0 + e >= dh) continue;
        if (MODE == kFwd) {
          o[c0 + e] = from_f<T>(acc[i][u][e] / row_l[r]);
        } else {
          o[c0 + e] = from_f<T>(acc[i][u][e]);
          if (kMerged) o2[c0 + e] = from_f<T>(acc2[i][u][e]);
        }
      }
    }
  }
}

// grid (B*H, ceil(T / 64)): one block a (batch, head) and 64 key rows, over
// the query tiles from the block's first key on (causal) or from 0. q (with the
// tile's statistics) and dO each have one slot, refilled as in attn_rows<kDq,
// ROUND>: q's behind dv, dO's behind the next tile's s.
template <typename T, bool ROUND, int W>
__global__ void __launch_bounds__(kTileThreads, W == 64 ? 2 : 1) attn_cols_tile(AttnArgs a) {
  using O = OutTile<W>;
  constexpr int R = O::kRows, C = O::kChunks, kColThreads = 4 * R;
  extern __shared__ float4 attn_tile_smem[];
  float* sm = reinterpret_cast<float*>(attn_tile_smem);
  const int dh = a.dh, ks = tile_stride(dh), tile = kTile * ks, t_len = a.t_len;
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane & 15, ty = (tid >> 5) * 2 + (lane >> 4);
  const int cg = tid % kColThreads, rg = tid / kColThreads;
  const int nch = (dh + 3) >> 2, col0 = blockIdx.y * kTile;
  const bool vec = a.vec;
  const bool panel_live = col0 + (tid >> 5) * 2 < t_len;
  const bool out_live = col0 + (tid & ~31) / kColThreads < t_len;

  float* k_s = sm;
  float* v_s = k_s + tile;
  float* q_s = v_s + tile;           // q's slot, then m, l, D of its 64 queries
  float* st_m = q_s + tile;
  float* st_l = st_m + kTile;
  float* st_d = st_l + kTile;
  float* do_s = st_d + kTile;        // dO's slot
  float* pan = do_s + tile;          // p [key][query]
  float* pan2 = pan + kTile * kPanel;  // ds

  const T* q = static_cast<const T*>(a.q) + head_base(a.in, b, h);
  const T* k = static_cast<const T*>(a.k) + head_base(a.in, b, h);
  const T* v = static_cast<const T*>(a.v) + head_base(a.in, b, h);
  const T* dout = static_cast<const T*>(a.dout) + head_base(a.dov, b, h);
  const size_t st0 = (size_t)bh * t_len;

  auto stage_queries = [&](int i0) {
    stage_rows(q_s, q, a.in.st, i0, t_len, dh, ks, vec);
    for (int e = tid; e < 3 * kTile; e += kTileThreads) {
      const int which = e / kTile, ii = e - which * kTile, i = i0 + ii;
      const float* src = which == 0 ? a.m : which == 1 ? a.l : a.dsum;
      cp_async4(st_m + e, src + (i < t_len ? st0 + i : 0), i < t_len);
    }
    cp_async_commit();
  };

  float dk[R][C][4], dv[R][C][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int u = 0; u < C; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][u][e] = dv[i][u][e] = 0.f;

  // causal: queries before the block's first key see none of its keys
  const int i_start = a.causal ? col0 : 0;
  const int n_tiles = (t_len - i_start + kTile - 1) / kTile;
  stage_rows(k_s, k, a.in.st, col0, t_len, dh, ks, vec);
  stage_rows(v_s, v, a.in.st, col0, t_len, dh, ks, vec);
  stage_queries(i_start);
  stage_rows(do_s, dout, a.dov.st, i_start, t_len, dh, ks, vec);
  cp_async_commit();
  int none[R];
#pragma unroll
  for (int i = 0; i < R; ++i) none[i] = kTile;

  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = i_start + t * kTile;
    const bool more = t + 1 < n_tiles;
    const int nt = min(kTile, t_len - i0);
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    cp_async_wait<1>();
    __syncthreads();  // q's tile and its statistics are in
    if (panel_live) panel_product_n(s, k_s, q_s, ks, dh, tx, ty, nt);
    cp_async_wait<0>();
    __syncthreads();  // dO's tile is in
    if (panel_live) panel_product_n(dp, v_s, do_s, ks, dh, tx, ty, nt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, key = col0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ii = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (ii < nt && (!a.causal || i0 + ii >= key)) {
          p = expf(fmaf(s[i][j], a.scale, -st_m[ii])) / st_l[ii];
          ds = p * (dp[i][j] - st_d[ii]) * a.scale;
          if (ROUND) {
            ds = round_to<T>(ds);
            p = round_to<T>(p);
          }
        }
        pan[r * kPanel + ii] = p;
        pan2[r * kPanel + ii] = ds;
      }
    }
    __syncthreads();

    // every query of the tile joins the chains, the causally masked ones with
    // p == ds == 0, as in the earlier passes
    if (out_live) {
      if (nt < kTile)
        out_product<R, C, true>(dk, pan2, q_s, ks, nt, none, rg, cg, nch);
      else
        out_product<R, C, false>(dk, pan2, q_s, ks, nt, none, rg, cg, nch);
    }
    if (more) {
      __syncthreads();
      stage_queries(i0 + kTile);
    }
    if (out_live) {
      if (nt < kTile)
        out_product<R, C, true>(dv, pan, do_s, ks, nt, none, rg, cg, nch);
      else
        out_product<R, C, false>(dv, pan, do_s, ks, nt, none, rg, cg, nch);
    }
    if (more) {
      __syncthreads();
      stage_rows(do_s, dout, a.dov.st, i0 + kTile, t_len, dh, ks, vec);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = col0 + rg + (kTile / R) * i;
    if (j >= t_len) continue;
    T* dk_o = static_cast<T*>(a.out) + head_base(a.ov, b, h) + j * a.ov.st;
    T* dv_o = static_cast<T*>(a.out2) + head_base(a.o2v, b, h) + j * a.o2v.st;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int c0 = 4 * (cg + kColThreads * u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c0 + e >= dh) continue;
        dk_o[c0 + e] = from_f<T>(dk[i][u][e]);
        dv_o[c0 + e] = from_f<T>(dv[i][u][e]);
      }
    }
  }
}

// The passes as the callers name them: attn_rows<T, MODE, ROUND> and
// attn_cols<T, ROUND>, launched by launch_tiles, which picks the kernel of the
// head width's class, the copy path and the stages.
template <typename T, int MODE, bool ROUND>
struct RowsPass {};
template <typename T, bool ROUND>
struct ColsPass {};
template <typename T, int MODE, bool ROUND>
constexpr RowsPass<T, MODE, ROUND> attn_rows{};
template <typename T, bool ROUND>
constexpr ColsPass<T, ROUND> attn_cols{};

inline bool tile_view_vec(const HeadView& v) {
  return v.sb % 4 == 0 && v.sh % 4 == 0 && v.st % 4 == 0;
}

// fp32 rows whose 16-byte chunks cp.async can copy: dh a multiple of 4, every
// base 16-byte aligned and every stride a multiple of 4 floats.
template <typename T>
bool tile_vec(const AttnArgs& a) {
  return std::is_same_v<T, float> && a.dh % 4 == 0 && aligned16(a.q) &&
         aligned16(a.k) && aligned16(a.v) && tile_view_vec(a.in) &&
         (a.dout == nullptr || (aligned16(a.dout) && tile_view_vec(a.dov)));
}

// Shared memory of a pass: `tiles` [64, dh] tiles, `panels` [64, 64]
// panels and `extra` floats.
inline size_t tile_smem_bytes(int dh, int tiles, int panels, int extra) {
  return sizeof(float) * ((size_t)tiles * kTile * tile_stride(dh) +
                          (size_t)panels * kTile * kPanel + extra);
}

template <typename Kernel>
cudaError_t launch_tile_kernel(Kernel kernel, const AttnArgs& a, size_t smem, int batch,
                               cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.n_heads, (a.t_len + kTile - 1) / kTile);
  kernel<<<grid, kTileThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline bool tile_args_ok(const AttnArgs& a, int batch) {
  return a.dh > 0 && a.dh <= kMaxDh && a.t_len > 0 && a.n_heads > 0 && batch > 0;
}

// kFwd, kStats: q and the ring's 2 x 2 tiles, one panel; kDq: q, dO and the
// k and v slots, one panel (two with ROUND); all three row statistics.
template <typename T, int MODE, bool ROUND>
cudaError_t launch_tiles(RowsPass<T, MODE, ROUND>, const AttnArgs& args, int batch,
                         cudaStream_t stream) {
  if (!tile_args_ok(args, batch)) return cudaErrorInvalidValue;
  AttnArgs a = args;
  a.vec = tile_vec<T>(a);
  const size_t smem = MODE == kDq ? tile_smem_bytes(a.dh, 4, ROUND ? 2 : 1, 3 * kTile)
                                  : tile_smem_bytes(a.dh, 1 + 2 * kRingStages, 1, 3 * kTile);
  switch (tile_width(a.dh)) {
    case 64:
      return launch_tile_kernel(attn_rows_tile<T, MODE, ROUND, 64>, a, smem, batch, stream);
    case 96:
      return launch_tile_kernel(attn_rows_tile<T, MODE, ROUND, 96>, a, smem, batch, stream);
    default:
      return launch_tile_kernel(attn_rows_tile<T, MODE, ROUND, 128>, a, smem, batch, stream);
  }
}

// k, v, the q and dO slots and the statistics, two panels.
template <typename T, bool ROUND>
cudaError_t launch_tiles(ColsPass<T, ROUND>, const AttnArgs& args, int batch,
                         cudaStream_t stream) {
  if (!tile_args_ok(args, batch)) return cudaErrorInvalidValue;
  AttnArgs a = args;
  a.vec = tile_vec<T>(a);
  const size_t smem = tile_smem_bytes(a.dh, 4, 2, 3 * kTile);
  switch (tile_width(a.dh)) {
    case 64:
      return launch_tile_kernel(attn_cols_tile<T, ROUND, 64>, a, smem, batch, stream);
    case 96:
      return launch_tile_kernel(attn_cols_tile<T, ROUND, 96>, a, smem, batch, stream);
    default:
      return launch_tile_kernel(attn_cols_tile<T, ROUND, 128>, a, smem, batch, stream);
  }
}

}  // namespace cct
