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
#include "attention_tc.cuh"
#include "attention_tiles.cuh"
#include "common.cuh"

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

// ---- tensor-core route (bf16, dh = 64; csrc/attention_tc.cuh) ---------------

// K4: grid (B*H, T/64 query tiles). a = q; x, y = k, v tiles 0 .. (causal ? the
// diagonal : all).
__global__ void __launch_bounds__(kTcThreads)
    tc_fwd(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, bf16* out, int t_len, int causal,
           float scale) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem<> sm = tc_smem(smem_raw, 1, false);
  const int bh = blockIdx.x, qt = query_tile(causal), q0 = qt * kBoxRows;
  const TcLoads ld{&mq, nullptr, &mk, &mv, q0, 0, causal ? qt + 1 : n_tiles(t_len), bh,
                   0, 0, 0, 0, bh};
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
  store_rows(o, inv, out + (size_t)bh * t_len * kTcDh, q0, t_len, kTcDh);
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
  const TcGeom geo{1, {0, 0, 0, 0}};     // [B*H, T, 64] arrays
  const long long z = (long long)t * kTcDh;
  const TcOut none{nullptr, 0, 0};
  return tc_attention_bwd<false, kTcDh>(mq, mk, mv, mg, geo, m, m + (size_t)heads * t,
                                 m + 2 * (size_t)heads * t,
                                 TcOut{static_cast<__nv_bfloat16*>(dq), z, kTcDh}, none,
                                 TcOut{static_cast<__nv_bfloat16*>(dk), z, kTcDh},
                                 TcOut{static_cast<__nv_bfloat16*>(dv), z, kTcDh}, heads, t,
                                 causal, scale, s);
}
