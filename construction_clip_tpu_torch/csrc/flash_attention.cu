// K4 and K5: attention over [B, H, T, dh] without a [T, T] panel in device
// memory, forward and backward, on two routes chosen by
// ops/flash_attention.py:route (a launch on a route never retries the other):
//
//   tensor cores (bf16, dh = 64): cct_flash_attention_fwd_tc / _bwd_tc below;
//   SIMT (fp32, and bf16 at other head widths): cct_flash_attention_fwd / _bwd,
//     the fp32 FMA tiles of attention_tiles.cuh (fp32 on the tensor cores would
//     be TF32, three decimal digits).
//
// K4 replaces construction_clip_tpu/ops/pallas_attention.py:_attn_kernel (:61,
// launched by _forward's pl.pallas_call at :346): o = softmax(q k^T scale,
// causal) v, with p = exp(s - m) rounded to the input type for p . v and the
// sum normalised by the fp32 row sum of p afterwards. Keys stream in 64-row
// tiles with an online softmax (m and l carried across tiles, the partial sum
// rescaled), so p is rounded relative to the running max.
//
// K5 replaces pallas_attention.py:_bwd_kernel (:206, launched by _bwd_pallas's
// pl.pallas_call at :303): p recomputed from q and k in fp32, then dv = p^T dO,
// dp = dO v^T, ds = p (dp - rowsum(dp p)) scale, dq = ds k, dk = ds^T q, summed
// in fp32 and rounded once at the output. Three launches with fixed-order sums
// and no atomics (a run is deterministic): per-row statistics m, l and
// D = rowsum(dp p); dq per query tile over key tiles; dk and dv per key tile
// over query tiles.
//
// What bounds them on the H100: per (batch, head) 4 T^2 dh FLOPs forward and
// 10 T^2 dh backward against 4 T dh (7 T dh) bf16 values moved, about T / 2
// FLOPs a byte: at T = 257, 128, under the ~295 at which the tensor cores and
// not HBM become the limit, so both are bound by bytes (5.7 and 9.9 us at
// [9, 16, 257, 64]). What the tensor-core route does about it:
//   - every product runs on wgmma (m64n64k16, bf16 in, fp32 accumulators), so
//     the arithmetic no longer hides the memory: one warpgroup owns 64 rows and
//     a 64-row tile's product is four instructions;
//   - TMA streams 64 x 64 tiles (128-byte rows, 128-byte swizzle, zeros past
//     T) into a two-stage ring on mbarriers, so tile j + 1 loads while tile j
//     computes; the rows a block owns load once;
//   - the [64, 64] panels s, p, dp and ds stay in the accumulator registers;
//     p and ds, rounded to bf16, become the register A operand of the next
//     product (p . v, ds . k, p^T dO, ds^T q) with no trip through memory;
//   - an element of a panel costs an FFMA and one ex2 (logits in base 2, the
//     scale folded into per-row constants); only tiles that reach past T or
//     sit on the causal diagonal are masked, and k-steps of rows past T skip.
// The card then spends its time on each block's chain of wgmma, wait and
// element work per tile, with 3-5 blocks of 64 rows resident on an SM, not on
// bytes; the backward runs 9 tile products to the function's 5, since without
// atomics s is recomputed in each launch and dp in two.
// Rounding points: the forward's are the SIMT K4's (p rounded relative to the
// running max, fp32 sums). The backward rounds p and ds to bf16 as operands of
// their products, where the Pallas kernel keeps them in fp32 (FlashAttention-2
// and -3 make the same choice); its statistics carry D_u = sum exp(s - m_run)
// dp with the rescale of l, so D = D_u / l equals rowsum(dp p) without
// recomputing o.
#include "attention_tiles.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace cct {
namespace {

#define CCT_TRY(expr)                      \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

// ---- SIMT route (attention_tiles.cuh) ---------------------------------------

AttnArgs bhtd_args(const void* q, const void* k, const void* v, int h, int t, int dh,
                   int causal, float scale) {
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.in = HeadView{(long long)h * t * dh, (long long)t * dh, dh};
  a.dov = a.ov = a.o2v = a.in;
  a.n_heads = h;
  a.t_len = t;
  a.dh = dh;
  a.causal = causal;
  a.scale = scale;
  return a;
}

template <typename T>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, int b, int h, int t,
                    int dh, int causal, float scale, cudaStream_t stream) {
  if (b <= 0) return cudaErrorInvalidValue;
  AttnArgs a = bhtd_args(q, k, v, h, t, dh, causal, scale);
  a.out = o;
  return launch_tiles(attn_rows<T, kFwd, false>, a, b, stream);
}

template <typename T>
cudaError_t run_bwd(const void* q, const void* k, const void* v, const void* g, float* work,
                    void* dq, void* dk, void* dv, int b, int h, int t, int dh, int causal,
                    float scale, cudaStream_t stream) {
  if (b <= 0) return cudaErrorInvalidValue;
  AttnArgs a = bhtd_args(q, k, v, h, t, dh, causal, scale);
  const size_t n = (size_t)b * h * t;
  a.dout = g;
  a.m = work;
  a.l = work + n;
  a.dsum = work + 2 * n;
  CCT_TRY(launch_tiles(attn_rows<T, kStats, false>, a, b, stream));
  a.out = dq;
  CCT_TRY(launch_tiles(attn_rows<T, kDq, false>, a, b, stream));
  a.out = dk;
  a.out2 = dv;
  return launch_tiles(attn_cols<T, false>, a, b, stream);
}

// ---- tensor-core route (bf16, dh = 64) --------------------------------------

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kTcThreads = 128;  // one warpgroup: 64 rows, 16 a warp
constexpr int kTcDh = 64;
constexpr int kStages = 2;  // streamed tiles in flight (3 or 4 measured no faster)
constexpr int kStatFloats = 3 * kBoxRows;  // m, l, D of a streamed tile's 64 query rows

// Shared memory of a block: `fixed` tiles loaded once (a; b when fixed is 2),
// a ring of kStages stages of two streamed tiles (x, y), for the dk/dv pass
// each stage's query statistics, then mbarrier 0 for the fixed tiles and
// 1 + s for stage s.
struct TcSmem {
  bf16* a;
  bf16* b;
  uint8_t* ring;
  float* stat_base;
  uint64_t* bar;
  __device__ __forceinline__ bf16* x(int st) const {
    return reinterpret_cast<bf16*>(ring + 2 * st * kBoxBytes);
  }
  __device__ __forceinline__ bf16* y(int st) const {
    return reinterpret_cast<bf16*>(ring + (2 * st + 1) * kBoxBytes);
  }
  __device__ __forceinline__ float* stats(int st) const { return stat_base + st * kStatFloats; }
};

constexpr size_t tc_smem_bytes(int fixed, bool stats) {
  return 1024 + (fixed + 2 * kStages) * kBoxBytes +
         (stats ? kStages * kStatFloats * sizeof(float) : 0) + (1 + kStages) * sizeof(uint64_t);
}

__device__ __forceinline__ TcSmem tc_smem(uint8_t* raw, int fixed, bool stats) {
  uint8_t* p = align_1024(raw);
  TcSmem s;
  s.a = reinterpret_cast<bf16*>(p);
  s.b = reinterpret_cast<bf16*>(p + kBoxBytes);
  s.ring = p + fixed * kBoxBytes;
  s.stat_base = reinterpret_cast<float*>(s.ring + 2 * kStages * kBoxBytes);
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
// given), x and y stream from row (first + i) * 64 for i = 0 .. n - 1.
struct TcLoads {
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  const CUtensorMap* mx;
  const CUtensorMap* my;
  int a_row, first, n, bh;
};

// Thread 0: streamed tile i into stage i % kStages.
__device__ __forceinline__ void tc_issue(const TcSmem& sm, const TcLoads& ld, int i) {
  const int st = i % kStages;
  mbar_expect_tx(&sm.bar[1 + st], 2 * kBoxBytes);
  tma_load_3d(sm.x(st), ld.mx, &sm.bar[1 + st], 0, (ld.first + i) * kBoxRows, ld.bh);
  tma_load_3d(sm.y(st), ld.my, &sm.bar[1 + st], 0, (ld.first + i) * kBoxRows, ld.bh);
}

// Sets up the barriers and starts the loads of the fixed tiles and of the
// first kStages streamed tiles; every thread returns once the fixed tiles are in.
__device__ __forceinline__ void tc_start(const TcSmem& sm, const TcLoads& ld) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&sm.bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.bar[0], (ld.mb ? 2 : 1) * kBoxBytes);
    tma_load_3d(sm.a, ld.ma, &sm.bar[0], 0, ld.a_row, ld.bh);
    if (ld.mb) tma_load_3d(sm.b, ld.mb, &sm.bar[0], 0, ld.a_row, ld.bh);
    for (int i = 0; i < kStages && i < ld.n; ++i) tc_issue(sm, ld, i);
  }
  mbar_wait(&sm.bar[0], 0);
}

// Streamed tile i has landed.
__device__ __forceinline__ void tc_wait(const TcSmem& sm, int i) {
  mbar_wait(&sm.bar[1 + i % kStages], (i / kStages) & 1);
}

// After tile i: once every warp is done with its stage, thread 0 refills it
// with tile i + kStages.
__device__ __forceinline__ void tc_release(const TcSmem& sm, const TcLoads& ld, int i) {
  __syncthreads();
  if (threadIdx.x == 0 && i + kStages < ld.n) tc_issue(sm, ld, i + kStages);
}

// Stores a [64, 64] fp32 accumulator (times `mul` per row half) as bf16 rows
// row0 + r < t_len of the head's [T, 64] output.
__device__ __forceinline__ void store_rows(const float (&d)[32], const float (&mul)[2], bf16* out,
                                           int row0, int t_len) {
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    const int row = row0 + acc_row(k);
    if (row < t_len) {
      const float f = mul[(k >> 1) & 1];
      *reinterpret_cast<uint32_t*>(out + (size_t)row * kTcDh + acc_col(k)) =
          pack_bf16(d[k] * f, d[k + 1] * f);
    }
  }
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) d[k] = 0.f;
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

// K4: grid (B*H, T/64 query tiles). a = q; x, y = k, v tiles 0 .. (causal ? the
// diagonal : all).
__global__ void __launch_bounds__(kTcThreads)
    tc_fwd(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, bf16* out, int t_len, int causal,
           float scale) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem sm = tc_smem(smem_raw, 1, false);
  const int bh = blockIdx.x, qt = query_tile(causal), q0 = qt * kBoxRows;
  const TcLoads ld{&mq, nullptr, &mk, &mv, q0, 0, causal ? qt + 1 : n_tiles(t_len), bh};
  const float c = scale * kLog2e;
  tc_start(sm, ld);

  float o[32], m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  zero(o);
  for (int i = 0; i < ld.n; ++i) {
    const int st = i % kStages, key0 = i * kBoxRows;
    tc_wait(sm, i);
    float s[32];
    zero(s);
    fence_regs(s);
    wgmma_fence();
    mma_abt(s, sm.a, sm.x(st));
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
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int k = 0; k < 32; ++k) mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], s[k]);
    float corr[2], psum[2] = {0.f, 0.f};
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
      s[k] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(psum[r]);
    uint32_t pa[16];
    pack_a(s, pa);  // p rounded to bf16 relative to the running max
#pragma unroll
    for (int k = 0; k < 32; ++k) o[k] *= corr[(k >> 1) & 1];

    fence_regs(o);
    wgmma_fence();
    mma_rb(o, pa, sm.y(st), live_ksteps(key0, t_len));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    tc_release(sm, ld, i);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows(o, inv, out + (size_t)bh * t_len * kTcDh, q0, t_len);
}

// K5 pass 1: grid (B*H, T/64 query tiles). a, b = q, dO; x, y = k, v. Per row:
// m (base 2), l and D = D_u / l (D_u carried with l's rescale).
__global__ void __launch_bounds__(kTcThreads)
    tc_stats(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
             float* m_out, float* l_out, float* d_out, int t_len, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem sm = tc_smem(smem_raw, 2, false);
  const int bh = blockIdx.x, qt = query_tile(causal), q0 = qt * kBoxRows;
  const TcLoads ld{&mq, &mg, &mk, &mv, q0, 0, causal ? qt + 1 : n_tiles(t_len), bh};
  const float c = scale * kLog2e;
  tc_start(sm, ld);

  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
  for (int i = 0; i < ld.n; ++i) {
    const int st = i % kStages, key0 = i * kBoxRows;
    tc_wait(sm, i);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt(s, sm.a, sm.x(st));
    mma_abt(dp, sm.b, sm.y(st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
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

// K5 pass 2: grid (B*H, T/64 query tiles). a, b = q, dO; x, y = k, v.
// dq = sum over key tiles of bf16(ds) k, ds = 2^(t - m) (scale / l) (dp - D).
__global__ void __launch_bounds__(kTcThreads)
    tc_dq(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
          const float* m_in, const float* l_in, const float* d_in, bf16* dq, int t_len,
          int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem sm = tc_smem(smem_raw, 2, false);
  const int bh = blockIdx.x, qt = query_tile(causal), q0 = qt * kBoxRows;
  const TcLoads ld{&mq, &mg, &mk, &mv, q0, 0, causal ? qt + 1 : n_tiles(t_len), bh};
  const float c = scale * kLog2e;
  float m[2], cl[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(2 * r);
    const size_t at = (size_t)bh * t_len + row;
    m[r] = row < t_len ? m_in[at] : 0.f;
    cl[r] = row < t_len ? scale / l_in[at] : 0.f;
    dsum[r] = row < t_len ? d_in[at] : 0.f;
  }
  tc_start(sm, ld);

  float acc[32];
  zero(acc);
  for (int i = 0; i < ld.n; ++i) {
    const int st = i % kStages, key0 = i * kBoxRows;
    tc_wait(sm, i);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt(s, sm.a, sm.x(st));
    mma_abt(dp, sm.b, sm.y(st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int r = (k >> 1) & 1;
      s[k] = ex2(fmaf(s[k], c, -m[r])) * cl[r] * (dp[k] - dsum[r]);
    }
    if (key_edge(key0, q0, t_len, causal)) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int row = q0 + acc_row(k), col = key0 + acc_col(k);
        if (col >= t_len || (causal && col > row)) s[k] = 0.f;
      }
    }
    uint32_t da[16];
    pack_a(s, da);
    fence_regs(acc);
    wgmma_fence();
    mma_rb(acc, da, sm.x(st), live_ksteps(key0, t_len));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    tc_release(sm, ld, i);
  }
  const float one[2] = {1.f, 1.f};
  store_rows(acc, one, dq + (size_t)bh * t_len * kTcDh, q0, t_len);
}

// Thread t < 64: the statistics of streamed query tile i as (m, 1/l, D), with
// 1/l = 0 for rows past T so that their p is 0.
__device__ __forceinline__ void load_stats(const TcSmem& sm, const TcLoads& ld, int i,
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

// K5 pass 3: grid (B*H, T/64 key tiles). a, b = k, v; x, y = q, dO tiles from
// (causal ? the diagonal : 0). s^T = k q^T, dp^T = v dO^T, then
// dv += bf16(p^T) dO and dk += bf16(ds^T) q.
__global__ void __launch_bounds__(kTcThreads)
    tc_dkv(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
           const float* m_in, const float* l_in, const float* d_in, bf16* dk, bf16* dv,
           int t_len, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem sm = tc_smem(smem_raw, 2, true);
  const int bh = blockIdx.x, k0 = blockIdx.y * kBoxRows;
  const int first = causal ? (int)blockIdx.y : 0;
  const TcLoads ld{&mk, &mv, &mq, &mg, k0, first, n_tiles(t_len) - first, bh};
  const float c = scale * kLog2e;
  for (int i = 0; i < kStages; ++i) load_stats(sm, ld, i, m_in, l_in, d_in, t_len);
  tc_start(sm, ld);  // its __syncthreads publishes the statistics

  float acc_k[32], acc_v[32];
  zero(acc_k);
  zero(acc_v);
  for (int i = 0; i < ld.n; ++i) {
    const int st = i % kStages, q0 = (first + i) * kBoxRows;
    tc_wait(sm, i);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt(s, sm.a, sm.x(st));
    mma_abt(dp, sm.b, sm.y(st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
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
    mma_rb(acc_v, pa, sm.y(st), live);
    mma_rb(acc_k, da, sm.x(st), live);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    tc_release(sm, ld, i);  // every warp is done with stage st and its statistics
    load_stats(sm, ld, i + kStages, m_in, l_in, d_in, t_len);  // published by the next release
  }
  const float one[2] = {1.f, 1.f};
  store_rows(acc_k, one, dk + (size_t)bh * t_len * kTcDh, k0, t_len);
  store_rows(acc_v, one, dv + (size_t)bh * t_len * kTcDh, k0, t_len);
}

template <typename Kernel, typename... Args>
cudaError_t tc_launch(Kernel kernel, size_t smem, int heads, int t, cudaStream_t stream,
                      Args... args) {
  CCT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kernel<<<dim3(heads, n_tiles(t)), kTcThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

bool tc_takes(int dtype, int b, int h, int t, int dh) {
  return dtype == kBFloat16 && dh == kTcDh && b > 0 && h > 0 && t > 0;
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means a launch was refused. q, k, v, o are
// contiguous [B, H, T, dh] of one type. The SIMT route.
extern "C" int cct_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                       void* o, int b, int h, int t, int dh, int causal,
                                       float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_fwd<float>(q, k, v, o, b, h, t, dh, causal, scale, s);
    case cct::kBFloat16:
      return cct::run_fwd<__nv_bfloat16>(q, k, v, o, b, h, t, dh, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// work: fp32 scratch of 3 * B * H * T elements (per-row m, l, D). The SIMT route.
extern "C" int cct_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* g, void* work, void* dq, void* dk, void* dv,
                                       int b, int h, int t, int dh, int causal, float scale,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_bwd<float>(q, k, v, g, w, dq, dk, dv, b, h, t, dh, causal, scale, s);
    case cct::kBFloat16:
      return cct::run_bwd<__nv_bfloat16>(q, k, v, g, w, dq, dk, dv, b, h, t, dh, causal,
                                         scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core route, same arguments: bf16 at dh = 64 only (anything else
// is refused, never run on the other route).
extern "C" int cct_flash_attention_fwd_tc(int dtype, const void* q, const void* k,
                                          const void* v, void* o, int b, int h, int t, int dh,
                                          int causal, float scale, void* stream) {
  using namespace cct;
  if (!tc_takes(dtype, b, h, t, dh)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  CCT_TRY(hopper::head_tile_map(&mq, q, b * h, t));
  CCT_TRY(hopper::head_tile_map(&mk, k, b * h, t));
  CCT_TRY(hopper::head_tile_map(&mv, v, b * h, t));
  return tc_launch(tc_fwd, tc_smem_bytes(1, false), b * h, t, static_cast<cudaStream_t>(stream),
                   mq, mk, mv, static_cast<__nv_bfloat16*>(o), t, causal, scale);
}

extern "C" int cct_flash_attention_bwd_tc(int dtype, const void* q, const void* k,
                                          const void* v, const void* g, void* work, void* dq,
                                          void* dk, void* dv, int b, int h, int t, int dh,
                                          int causal, float scale, void* stream) {
  using namespace cct;
  if (!tc_takes(dtype, b, h, t, dh)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int heads = b * h;
  CUtensorMap mq, mk, mv, mg;
  CCT_TRY(hopper::head_tile_map(&mq, q, heads, t));
  CCT_TRY(hopper::head_tile_map(&mk, k, heads, t));
  CCT_TRY(hopper::head_tile_map(&mv, v, heads, t));
  CCT_TRY(hopper::head_tile_map(&mg, g, heads, t));
  float* m = static_cast<float*>(work);  // per row: m (base 2), l, D
  float* l = m + (size_t)heads * t;
  float* d = l + (size_t)heads * t;
  const float *mc = m, *lc = l, *dc = d;
  CCT_TRY(tc_launch(tc_stats, tc_smem_bytes(2, false), heads, t, s, mq, mk, mv, mg, m, l, d, t,
                    causal, scale));
  CCT_TRY(tc_launch(tc_dq, tc_smem_bytes(2, false), heads, t, s, mq, mk, mv, mg, mc, lc, dc,
                    static_cast<__nv_bfloat16*>(dq), t, causal, scale));
  return tc_launch(tc_dkv, tc_smem_bytes(2, true), heads, t, s, mq, mk, mv, mg, mc, lc, dc,
                   static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), t, causal,
                   scale);
}
