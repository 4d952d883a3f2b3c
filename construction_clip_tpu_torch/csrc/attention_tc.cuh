// The tensor-core attention passes (bf16) shared by K4/K5
// (csrc/flash_attention.cu, heads in [B*H, T, 64] arrays) and the fused
// block's tensor-core routes, K1 (csrc/attention_block.cu) and K3
// (csrc/attention_block_bwd.cu), whose heads sit at column offsets of the
// [B, T, 3D] qkv and of the [B, T, D] output gradient. Each pass is a
// template over the head width DH: 64 (K4/K5, K7, and K1/K3 at dh 64) or 96
// (K1/K3 at GPT-2's transformer mapper, 768 in 8 heads):
//
//   tc_stats      per query row m (base 2), l and D = rowsum(dp p);
//   tc_dq         dq = sum over key tiles of bf16(ds) k, and with MERGED (K3)
//                 the merged heads bf16(sum bf16(p) v) from the same p;
//   tc_dkv        dv = sum over query tiles of bf16(p^T) dO, dk = bf16(ds^T) q;
//   tc_block_fwd  K1's and K7's attention: merged = sum bf16(p) v / l, stored
//                 as bf16 (K1) or fp32 (K7), p rounded relative to the row's
//                 max (T <= 256).
//
// Every product is wgmma (bf16 in, fp32 accumulators): one warpgroup owns 64
// rows; TMA streams 64-row head tiles (HeadTile: zeros past T) into a
// two-stage ring on mbarriers; the [64, 64] panels s, p, dp and ds stay in the
// accumulator registers and p and ds, rounded to bf16, become the register A
// operand of the next product. Products over the head width (s = q k^T,
// dp = dO v^T) are DH / 16 k-steps of m64n64k16; products into it (p v, ds k,
// ds^T q, p^T dO) are m64nDHk16 with B MN-major. Fixed-order sums and no
// atomics: a run is deterministic.
//
// Where a head lives (TcGeom): every map is 3-D with coordinates (column, row,
// z); head bh is z = bh / heads and columns col[m] + DH (bh % heads) of map m.
// [B*H, T, 64] arrays take heads = 1 and col = 0; K3's [B, T, 3D] qkv takes
// heads = H and col = 0, D, 2D for q, k, v.
#pragma once

#include <cfloat>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace cct {
namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kTcThreads = 128;  // one warpgroup: 64 rows, 16 a warp
constexpr int kTcDh = 64;        // K4/K5's and K7's head width
constexpr int kStages = 2;  // streamed tiles in flight (3 or 4 measured no faster)
constexpr int kStatFloats = 3 * kBoxRows;  // m, l, D of a streamed tile's 64 query rows

// A head's 64-row tile in shared memory at head width DH: kBoxes TMA boxes of
// 64 rows x kCols columns, kBoxSize bytes apart. dh 64: one box of 128-byte
// rows with the 128-byte swizzle. dh 96: a 192-byte row is wider than a
// 128-byte-swizzled box may be, so three boxes of 32 columns (64-byte rows,
// 64-byte swizzle); each box is one swizzle atom, so that one m64n96k16
// descriptor spans the three with the box stride as its leading byte offset.
template <int DH>
struct HeadTile {
  static_assert(DH == 64 || DH == 96, "head widths of the tensor-core passes");
  static constexpr int kCols = DH == 64 ? 64 : 32;
  static constexpr int kBoxes = DH / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr uint32_t kBoxSize = kBoxRows * kRowBytes;
  static constexpr uint32_t kSize = kBoxes * kBoxSize;  // 8 KB or 12 KB
  static constexpr int kAcc = DH / 2;  // a thread's elements of a [64, DH] accumulator
};

// The head widths of the fused block's tensor-core routes (K1, K3).
__host__ __device__ constexpr bool tc_block_dh(int dh) { return dh == 64 || dh == 96; }

enum TcMap : int { kMapQ = 0, kMapK = 1, kMapV = 2, kMapG = 3 };

struct TcGeom {
  int heads;   // heads per z index of the maps
  int col[4];  // column of head 0 in the q, k, v and dO maps
};

// An output of type O (bf16; K7's merged heads fp32): row r of head bh at
// p + (bh / heads) z + DH (bh % heads) + r row.
template <typename O>
struct TcOutOf {
  O* p;
  long long z;
  int row;
  template <int DH>
  __device__ __forceinline__ O* head(int bh, int heads) const {
    return p + (long long)(bh / heads) * z + (long long)(bh % heads) * DH;
  }
};
using TcOut = TcOutOf<bf16>;

// Shared memory of a block: `fixed` head tiles loaded once (a; b when fixed is
// 2), a ring of kStages stages of two streamed tiles (x, y), for the dk/dv
// pass each stage's query statistics, then mbarrier 0 for the fixed tiles and
// 1 + s for stage s.
template <int DH = kTcDh>
struct TcSmem {
  static constexpr uint32_t kTile = HeadTile<DH>::kSize;
  bf16* a;
  bf16* b;
  uint8_t* ring;
  float* stat_base;
  uint64_t* bar;
  __device__ __forceinline__ bf16* x(int st) const {
    return reinterpret_cast<bf16*>(ring + 2 * st * kTile);
  }
  __device__ __forceinline__ bf16* y(int st) const {
    return reinterpret_cast<bf16*>(ring + (2 * st + 1) * kTile);
  }
  __device__ __forceinline__ float* stats(int st) const { return stat_base + st * kStatFloats; }
};

template <int DH = kTcDh>
constexpr size_t tc_smem_bytes(int fixed, bool stats) {
  return 1024 + (fixed + 2 * kStages) * HeadTile<DH>::kSize +
         (stats ? kStages * kStatFloats * sizeof(float) : 0) + (1 + kStages) * sizeof(uint64_t);
}

template <int DH = kTcDh>
__device__ __forceinline__ TcSmem<DH> tc_smem(uint8_t* raw, int fixed, bool stats) {
  constexpr uint32_t tile = HeadTile<DH>::kSize;
  uint8_t* p = align_1024(raw);
  TcSmem<DH> s;
  s.a = reinterpret_cast<bf16*>(p);
  s.b = reinterpret_cast<bf16*>(p + tile);
  s.ring = p + fixed * tile;
  s.stat_base = reinterpret_cast<float*>(s.ring + 2 * kStages * tile);
  s.bar = reinterpret_cast<uint64_t*>(s.stat_base + (stats ? kStages * kStatFloats : 0));
  return s;
}

__host__ __device__ __forceinline__ int n_tiles(int t) { return (t + kBoxRows - 1) / kBoxRows; }

// The row tile a query-tile block owns: causal blocks launch heaviest (most
// key tiles) first.
__device__ __forceinline__ int query_tile(int causal) {
  return causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
}

// k-steps of 16 that hold rows of a tile starting at row0 (the rest are past
// T: zeros that the reduction may skip).
__device__ __forceinline__ int live_ksteps(int row0, int t_len) {
  return min(kBoxRows, t_len - row0 + 15) / 16;
}

// The maps of one launch: a and b load once at row a_row (b when mb is
// given), x and y stream from row (first + i) * 64 for i = 0 .. n - 1; each
// map's tile of this head starts at its column `col` of depth index z.
struct TcLoads {
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  const CUtensorMap* mx;
  const CUtensorMap* my;
  int a_row, first, n, bh;
  int col_a, col_b, col_x, col_y, z;
};

// The loads of head bh: maps (ia, ib, ix, iy) of the geometry at a, b, x, y.
template <int DH>
__device__ __forceinline__ TcLoads tc_loads(const CUtensorMap* const (&maps)[4],
                                            const TcGeom& geo, int ia, int ib, int ix, int iy,
                                            bool with_b, int a_row, int first, int n, int bh) {
  const int hc = (bh % geo.heads) * DH;
  return TcLoads{maps[ia], with_b ? maps[ib] : nullptr, maps[ix], maps[iy], a_row, first, n, bh,
                 geo.col[ia] + hc, geo.col[ib] + hc, geo.col[ix] + hc, geo.col[iy] + hc,
                 bh / geo.heads};
}

// The head tile of `map` at (col, row, z) into dst: its boxes side by side.
template <int DH>
__device__ __forceinline__ void tma_load_head(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int col, int row, int z) {
  using H = HeadTile<DH>;
#pragma unroll
  for (int j = 0; j < H::kBoxes; ++j)
    tma_load_3d(static_cast<uint8_t*>(dst) + j * H::kBoxSize, map, bar, col + j * H::kCols, row,
                z);
}

// Thread 0: streamed tile i into stage i % kStages.
template <int DH>
__device__ __forceinline__ void tc_issue(const TcSmem<DH>& sm, const TcLoads& ld, int i) {
  const int st = i % kStages, row = (ld.first + i) * kBoxRows;
  mbar_expect_tx(&sm.bar[1 + st], 2 * HeadTile<DH>::kSize);
  tma_load_head<DH>(sm.x(st), ld.mx, &sm.bar[1 + st], ld.col_x, row, ld.z);
  tma_load_head<DH>(sm.y(st), ld.my, &sm.bar[1 + st], ld.col_y, row, ld.z);
}

// Sets up the barriers and starts the loads of the fixed tiles and of the
// first kStages streamed tiles; every thread returns once the fixed tiles are in.
template <int DH>
__device__ __forceinline__ void tc_start(const TcSmem<DH>& sm, const TcLoads& ld) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&sm.bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.bar[0], (ld.mb ? 2 : 1) * HeadTile<DH>::kSize);
    tma_load_head<DH>(sm.a, ld.ma, &sm.bar[0], ld.col_a, ld.a_row, ld.z);
    if (ld.mb) tma_load_head<DH>(sm.b, ld.mb, &sm.bar[0], ld.col_b, ld.a_row, ld.z);
    for (int i = 0; i < kStages && i < ld.n; ++i) tc_issue(sm, ld, i);
  }
  mbar_wait(&sm.bar[0], 0);
}

// Streamed tile i has landed.
template <int DH>
__device__ __forceinline__ void tc_wait(const TcSmem<DH>& sm, int i) {
  mbar_wait(&sm.bar[1 + i % kStages], (i / kStages) & 1);
}

// After tile i: once every warp is done with its stage, thread 0 refills it
// with tile i + kStages.
template <int DH>
__device__ __forceinline__ void tc_release(const TcSmem<DH>& sm, const TcLoads& ld, int i) {
  __syncthreads();
  if (threadIdx.x == 0 && i + kStages < ld.n) tc_issue(sm, ld, i + kStages);
}

// Stores a [64, 2N] fp32 accumulator (times `mul` per row half) as bf16 rows
// row0 + r < t_len of a head whose rows are `row_stride` elements apart.
template <int N>
__device__ __forceinline__ void store_rows(const float (&d)[N], const float (&mul)[2], bf16* out,
                                           int row0, int t_len, int row_stride) {
#pragma unroll
  for (int k = 0; k < N; k += 2) {
    const int row = row0 + acc_row(k);
    if (row < t_len) {
      const float f = mul[(k >> 1) & 1];
      *reinterpret_cast<uint32_t*>(out + (size_t)row * row_stride + acc_col(k)) =
          pack_bf16(d[k] * f, d[k + 1] * f);
    }
  }
}

template <int DH>
__device__ __forceinline__ void store_head(const float (&d)[DH / 2], const TcOut& out, int bh,
                                           int heads, int row0, int t_len) {
  const float one[2] = {1.f, 1.f};
  store_rows(d, one, out.template head<DH>(bh, heads), row0, t_len, out.row);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) d[k] = 0.f;
}

// d = A . B^T over a reduction of DH: A and B K-major head tiles, DH / 16
// k-steps (dh 96: two in each 64-byte-row box).
template <int DH>
__device__ __forceinline__ void head_abt(float (&d)[32], const void* a, const void* b) {
  using H = HeadTile<DH>;
  if constexpr (H::kBoxes == 1) {
    mma_abt(d, a, b);
  } else {
    constexpr int per_box = H::kCols / 16;
    const uint64_t da = desc_k_major_sw64(a), db = desc_k_major_sw64(b);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint64_t at = (kk / per_box) * (H::kBoxSize >> 4) + 2 * (kk % per_box);
      wgmma_m64n64k16_ss<0>(d, da + at, db + at, kk);
    }
  }
}

// d += A . B over the first 16 `ksteps` rows of a reduction of 64: A from
// pack_a, B an MN-major head tile (N = DH; dh 96: one m64n96k16 a k-step over
// the three boxes). ksteps is the same in every thread.
template <int DH>
__device__ __forceinline__ void head_rb(float (&d)[DH / 2], const uint32_t (&a)[16],
                                        const void* b, int ksteps) {
  using H = HeadTile<DH>;
  if constexpr (H::kBoxes == 1) {
    mma_rb(d, a, b, ksteps);
  } else {
    const uint64_t db = desc_mn_major_sw64(b, H::kBoxSize);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < ksteps) wgmma_m64n96k16_rs<1>(d, &a[4 * kk], db + (16 * H::kRowBytes >> 4) * kk, 1);
    }
  }
}

// Logits in base-2 units: t = s log2(e), so that exp(s - m) = 2^(t - m_2) is
// one ex2 (the statistics' m is kept in these units; l and D are unchanged).
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Whether a key tile needs masking for the query tile at q0: it reaches past T,
// or (causal) it is the diagonal tile.
__device__ __forceinline__ bool key_edge(int key0, int q0, int t_len, int causal) {
  return key0 + kBoxRows > t_len || (causal && key0 == q0);
}

// s = A . X^T and dp = B . Y^T for streamed stage st (both K-major).
template <int DH>
__device__ __forceinline__ void tc_two_products(float (&s)[32], float (&dp)[32],
                                                const TcSmem<DH>& sm, int st) {
  zero(s);
  zero(dp);
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  head_abt<DH>(s, sm.a, sm.x(st));
  head_abt<DH>(dp, sm.b, sm.y(st));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// Pass 1: grid (B*H, T/64 query tiles). a, b = q, dO; x, y = k, v. Per row:
// m (base 2), l and D = D_u / l (D_u carried with l's rescale).
template <int DH>
__global__ void __launch_bounds__(kTcThreads)
    tc_stats(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
             TcGeom geo, float* m_out, float* l_out, float* d_out, int t_len, int causal,
             float scale) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem<DH> sm = tc_smem<DH>(smem_raw, 2, false);
  const int bh = blockIdx.x, qt = query_tile(causal), q0 = qt * kBoxRows;
  const CUtensorMap* const maps[4] = {&mq, &mk, &mv, &mg};
  const TcLoads ld = tc_loads<DH>(maps, geo, kMapQ, kMapG, kMapK, kMapV, true, q0, 0,
                                  causal ? qt + 1 : n_tiles(t_len), bh);
  const float c = scale * kLog2e;
  tc_start(sm, ld);

  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
  for (int i = 0; i < ld.n; ++i) {
    const int st = i % kStages, key0 = i * kBoxRows;
    tc_wait(sm, i);
    float s[32], dp[32];
    tc_two_products(s, dp, sm, st);
    tc_release(sm, ld, i);

#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] *= c;
    if (key_edge(key0, q0, t_len, causal)) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int row = q0 + acc_row(k), col = key0 + acc_col(k);
        if (col >= t_len || (causal && col > row)) s[k] = -INFINITY;
      }
    }
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int k = 0; k < 32; ++k) mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], s[k]);
    float corr[2], psum[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float p = ex2(s[k] - m[(k >> 1) & 1]);
      psum[(k >> 1) & 1] += p;
      pdp[(k >> 1) & 1] += p * dp[k];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * corr[r] + quad_sum(psum[r]);
      du[r] = du[r] * corr[r] + quad_sum(pdp[r]);
    }
  }
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + acc_row(2 * r);
      if (row < t_len) {
        const size_t at = (size_t)bh * t_len + row;
        m_out[at] = m[r];
        l_out[at] = l[r];
        d_out[at] = du[r] / l[r];
      }
    }
  }
}

// Pass 2: grid (B*H, T/64 query tiles). a, b = q, dO; x, y = k, v.
// dq = sum over key tiles of bf16(ds) k, ds = 2^(t - m) (scale / l) (dp - D).
// MERGED (K3): p = 2^(t - m) / l, ds = p (dp - D) scale, and the merged heads
// sum over key tiles of bf16(p) v as a second output.
template <bool MERGED, int DH>
__global__ void __launch_bounds__(kTcThreads)
    tc_dq(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
          TcGeom geo, const float* m_in, const float* l_in, const float* d_in, TcOut dq,
          TcOut merged, int t_len, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem<DH> sm = tc_smem<DH>(smem_raw, 2, false);
  const int bh = blockIdx.x, qt = query_tile(causal), q0 = qt * kBoxRows;
  const CUtensorMap* const maps[4] = {&mq, &mk, &mv, &mg};
  const TcLoads ld = tc_loads<DH>(maps, geo, kMapQ, kMapG, kMapK, kMapV, true, q0, 0,
                                  causal ? qt + 1 : n_tiles(t_len), bh);
  const float c = scale * kLog2e;
  float m[2], cl[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(2 * r);
    const size_t at = (size_t)bh * t_len + row;
    m[r] = row < t_len ? m_in[at] : 0.f;
    // MERGED: 1 / l (p itself is an output's operand); else scale / l
    cl[r] = row < t_len ? (MERGED ? 1.f : scale) / l_in[at] : 0.f;
    dsum[r] = row < t_len ? d_in[at] : 0.f;
  }
  tc_start(sm, ld);

  constexpr int kAcc = HeadTile<DH>::kAcc;
  float acc[kAcc], acc_m[MERGED ? kAcc : 1];
  zero(acc);
  if constexpr (MERGED) zero(acc_m);
  for (int i = 0; i < ld.n; ++i) {
    const int st = i % kStages, key0 = i * kBoxRows;
    tc_wait(sm, i);
    float s[32], dp[32];
    tc_two_products(s, dp, sm, st);
    const bool edge = key_edge(key0, q0, t_len, causal);
    uint32_t pa[16];  // MERGED: bf16(p), the A operand of the merged heads' product
    if constexpr (MERGED) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int r = (k >> 1) & 1;
        const float p = ex2(fmaf(s[k], c, -m[r])) * cl[r];
        s[k] = p * (dp[k] - dsum[r]) * scale;
        dp[k] = p;
      }
      if (edge) {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int row = q0 + acc_row(k), col = key0 + acc_col(k);
          if (col >= t_len || (causal && col > row)) s[k] = dp[k] = 0.f;
        }
      }
      pack_a(dp, pa);
    } else {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int r = (k >> 1) & 1;
        s[k] = ex2(fmaf(s[k], c, -m[r])) * cl[r] * (dp[k] - dsum[r]);
      }
      if (edge) {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int row = q0 + acc_row(k), col = key0 + acc_col(k);
          if (col >= t_len || (causal && col > row)) s[k] = 0.f;
        }
      }
    }
    uint32_t da[16];
    pack_a(s, da);
    const int live = live_ksteps(key0, t_len);
    fence_regs(acc);
    if constexpr (MERGED) fence_regs(acc_m);
    wgmma_fence();
    head_rb<DH>(acc, da, sm.x(st), live);
    if constexpr (MERGED) head_rb<DH>(acc_m, pa, sm.y(st), live);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (MERGED) fence_regs(acc_m);
    tc_release(sm, ld, i);
  }
  store_head<DH>(acc, dq, bh, geo.heads, q0, t_len);
  if constexpr (MERGED) store_head<DH>(acc_m, merged, bh, geo.heads, q0, t_len);
}

// Thread t < 64: the statistics of streamed query tile i as (m, 1/l, D), with
// 1/l = 0 for rows past T so that their p is 0.
template <int DH>
__device__ __forceinline__ void load_stats(const TcSmem<DH>& sm, const TcLoads& ld, int i,
                                           const float* m_in, const float* l_in,
                                           const float* d_in, int t_len) {
  const int t = threadIdx.x;
  if (t < kBoxRows && i < ld.n) {
    const int row = (ld.first + i) * kBoxRows + t;
    const size_t at = (size_t)ld.bh * t_len + row;
    float* st = sm.stats(i % kStages);
    st[t] = row < t_len ? m_in[at] : 0.f;
    st[kBoxRows + t] = row < t_len ? 1.f / l_in[at] : 0.f;
    st[2 * kBoxRows + t] = row < t_len ? d_in[at] : 0.f;
  }
}

// Pass 3: grid (B*H, T/64 key tiles). a, b = k, v; x, y = q, dO tiles from
// (causal ? the diagonal : 0). s^T = k q^T, dp^T = v dO^T, then
// dv += bf16(p^T) dO and dk += bf16(ds^T) q.
template <int DH>
__global__ void __launch_bounds__(kTcThreads)
    tc_dkv(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
           TcGeom geo, const float* m_in, const float* l_in, const float* d_in, TcOut dk,
           TcOut dv, int t_len, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem<DH> sm = tc_smem<DH>(smem_raw, 2, true);
  const int bh = blockIdx.x, k0 = blockIdx.y * kBoxRows;
  const int first = causal ? (int)blockIdx.y : 0;
  const CUtensorMap* const maps[4] = {&mq, &mk, &mv, &mg};
  const TcLoads ld = tc_loads<DH>(maps, geo, kMapK, kMapV, kMapQ, kMapG, true, k0, first,
                                  n_tiles(t_len) - first, bh);
  const float c = scale * kLog2e;
  for (int i = 0; i < kStages; ++i) load_stats(sm, ld, i, m_in, l_in, d_in, t_len);
  tc_start(sm, ld);  // its __syncthreads publishes the statistics

  float acc_k[HeadTile<DH>::kAcc], acc_v[HeadTile<DH>::kAcc];
  zero(acc_k);
  zero(acc_v);
  for (int i = 0; i < ld.n; ++i) {
    const int st = i % kStages, q0 = (first + i) * kBoxRows;
    tc_wait(sm, i);
    float s[32], dp[32];
    tc_two_products(s, dp, sm, st);
    const float* stat = sm.stats(st);
#pragma unroll
    for (int k = 0; k < 32; k += 2) {  // columns 2q + 8 (k / 4) and the next: one float2
      const int col = acc_col(k);
      const float2 mm = *reinterpret_cast<const float2*>(stat + col);
      const float2 il = *reinterpret_cast<const float2*>(stat + kBoxRows + col);
      const float2 dd = *reinterpret_cast<const float2*>(stat + 2 * kBoxRows + col);
      const float p0 = ex2(fmaf(s[k], c, -mm.x)) * il.x;
      const float p1 = ex2(fmaf(s[k + 1], c, -mm.y)) * il.y;
      s[k] = p0;
      s[k + 1] = p1;
      dp[k] = p0 * (dp[k] - dd.x) * scale;
      dp[k + 1] = p1 * (dp[k + 1] - dd.y) * scale;
    }
    if (causal && q0 == k0) {  // the diagonal tile: queries before the key see none of it
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (acc_col(k) < acc_row(k)) s[k] = dp[k] = 0.f;
      }
    }
    uint32_t pa[16], da[16];
    pack_a(s, pa);
    pack_a(dp, da);
    const int live = live_ksteps(q0, t_len);
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
    head_rb<DH>(acc_v, pa, sm.y(st), live);
    head_rb<DH>(acc_k, da, sm.x(st), live);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    tc_release(sm, ld, i);  // every warp is done with stage st and its statistics
    load_stats(sm, ld, i + kStages, m_in, l_in, d_in, t_len);  // published by the next release
  }
  store_head<DH>(acc_k, dk, bh, geo.heads, k0, t_len);
  store_head<DH>(acc_v, dv, bh, geo.heads, k0, t_len);
}

template <typename Kernel, typename... Args>
cudaError_t tc_launch(Kernel kernel, size_t smem, int heads, int t, cudaStream_t stream,
                      Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, n_tiles(t)), kTcThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The three backward passes over maps q, k, v, dO of geometry geo: statistics
// into m, l, d (fp32, heads x t each), then dq (and with MERGED the merged
// heads), then dk and dv, at head width DH.
template <bool MERGED, int DH>
cudaError_t tc_attention_bwd(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                             const CUtensorMap& mg, const TcGeom& geo, float* m, float* l,
                             float* d, const TcOut& dq, const TcOut& merged, const TcOut& dk,
                             const TcOut& dv, int heads, int t, int causal, float scale,
                             cudaStream_t s) {
  const float *mc = m, *lc = l, *dc = d;
  cudaError_t err = tc_launch(tc_stats<DH>, tc_smem_bytes<DH>(2, false), heads, t, s, mq, mk,
                              mv, mg, geo, m, l, d, t, causal, scale);
  if (err != cudaSuccess) return err;
  err = tc_launch(tc_dq<MERGED, DH>, tc_smem_bytes<DH>(2, false), heads, t, s, mq, mk, mv, mg,
                  geo, mc, lc, dc, dq, merged, t, causal, scale);
  if (err != cudaSuccess) return err;
  return tc_launch(tc_dkv<DH>, tc_smem_bytes<DH>(2, true), heads, t, s, mq, mk, mv, mg, geo, mc,
                   lc, dc, dk, dv, t, causal, scale);
}

// ---- K1's and K7's forward attention (T <= 256) ----------------------------

constexpr int kBlockMaxTiles = 4;  // key tiles of a head at T <= 256

// Shared memory of tc_block_fwd at T = t: the query tile, then n_tiles(t) key
// and n_tiles(t) value tiles, then two mbarriers (query and keys; values).
// At dh 96 and T = 256: 1 KB + 9 x 12 KB, under the 227 KB a block may have.
template <int DH>
size_t tc_block_smem_bytes(int t) {
  return 1024 + (1 + 2 * (size_t)n_tiles(t)) * HeadTile<DH>::kSize + 2 * sizeof(uint64_t);
}

// s = (q . k^T) c for the key tile at key0, -inf past T and (causal) above the
// diagonal: the logits in base-2 units.
template <int DH>
__device__ __forceinline__ void tc_logits(float (&s)[32], const void* q_tile,
                                          const void* k_tile, float c, int q0, int key0,
                                          int t_len, int causal) {
  zero(s);
  fence_regs(s);
  wgmma_fence();
  head_abt<DH>(s, q_tile, k_tile);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int k = 0; k < 32; ++k) s[k] *= c;
  if (key_edge(key0, q0, t_len, causal)) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int row = q0 + acc_row(k), col = key0 + acc_col(k);
      if (col >= t_len || (causal && col > row)) s[k] = -INFINITY;
    }
  }
}

// Grid (B*H, T/64 query tiles), one warpgroup. A head's key and value tiles
// (at most kBlockMaxTiles each; causal: those up to the diagonal) are staged
// whole, the values on a barrier of their own so that they land during sweep
// 1. Sweep 1: s = q k^T per key tile, for the row's max m. Sweep 2: s again,
// p = 2^(t - m) summed in fp32 into l, bf16(p) the register A operand of
// o += p v. The store divides o by l and rounds once. The Pallas kernel's
// rounding points: p rounded relative to the row's max (K4 rounds it relative
// to the running max and rescales o, which differs from T = 65 on). O is the
// output's type: bf16 for K1, fp32 for K7 (whose out-projection quantizes the
// merged rows unrounded), the same quotient either way. DH is the head width
// (K7: 64).
template <typename O, int DH>
__global__ void __launch_bounds__(kTcThreads)
    tc_block_fwd(const __grid_constant__ CUtensorMap mqkv, TcGeom geo, TcOutOf<O> merged,
                 int t_len, int causal, float scale) {
  constexpr uint32_t tile = HeadTile<DH>::kSize;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const int bh = blockIdx.x, qt = query_tile(causal), q0 = qt * kBoxRows;
  const int nt = n_tiles(t_len), nk = causal ? qt + 1 : nt;
  const int hc = (bh % geo.heads) * DH, z = bh / geo.heads;
  const uint8_t* q = base;
  uint8_t* keys = base + tile;
  uint8_t* vals = keys + nt * tile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vals + nt * tile);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], (1 + nk) * tile);
    tma_load_head<DH>(base, &mqkv, &bar[0], geo.col[kMapQ] + hc, q0, z);
    for (int j = 0; j < nk; ++j)
      tma_load_head<DH>(keys + j * tile, &mqkv, &bar[0], geo.col[kMapK] + hc, j * kBoxRows, z);
    mbar_expect_tx(&bar[1], nk * tile);
    for (int j = 0; j < nk; ++j)
      tma_load_head<DH>(vals + j * tile, &mqkv, &bar[1], geo.col[kMapV] + hc, j * kBoxRows, z);
  }
  const float c = scale * kLog2e;
  mbar_wait(&bar[0], 0);

  float m[2] = {-FLT_MAX, -FLT_MAX};
  for (int j = 0; j < nk; ++j) {
    float s[32];
    tc_logits<DH>(s, q, keys + j * tile, c, q0, j * kBoxRows, t_len, causal);
#pragma unroll
    for (int k = 0; k < 32; ++k) m[(k >> 1) & 1] = fmaxf(m[(k >> 1) & 1], s[k]);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  mbar_wait(&bar[1], 0);

  float o[HeadTile<DH>::kAcc], l[2] = {0.f, 0.f};
  zero(o);
  for (int j = 0; j < nk; ++j) {
    float s[32];
    tc_logits<DH>(s, q, keys + j * tile, c, q0, j * kBoxRows, t_len, causal);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      s[k] = ex2(s[k] - m[(k >> 1) & 1]);
      l[(k >> 1) & 1] += s[k];
    }
    uint32_t pa[16];
    pack_a(s, pa);  // p rounded to bf16 relative to the row's max
    fence_regs(o);
    wgmma_fence();
    head_rb<DH>(o, pa, vals + j * tile, live_ksteps(j * kBoxRows, t_len));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  O* out = merged.template head<DH>(bh, geo.heads);
#pragma unroll
  for (int k = 0; k < HeadTile<DH>::kAcc; k += 2) {
    const int row = q0 + acc_row(k), r = (k >> 1) & 1;
    if (row >= t_len) continue;
    O* dst = out + (size_t)row * merged.row + acc_col(k);
    const float v0 = __fdiv_rn(o[k], l[r]), v1 = __fdiv_rn(o[k + 1], l[r]);
    if constexpr (std::is_same_v<O, float>)
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);  // acc_col is even
    else
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
  }
}

// The map of a bf16 [depth, rows, cols] array whose heads of width DH the
// passes read: HeadTile<DH>'s boxes, 64 rows each, zeros past `rows`.
template <int DH>
cudaError_t head_map(CUtensorMap* map, const void* base, int depth, int rows, int cols) {
  return hopper::tile_map(map, base, depth, rows, cols, kBoxRows,
                          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, HeadTile<DH>::kRowBytes);
}

}  // namespace
}  // namespace cct
