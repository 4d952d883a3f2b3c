// K3: backward of the fused pre-norm attention block (K1's forward),
//   out = x + W_out . MHA(split_heads(LN(x) . W_qkv + b_qkv)) + b_out.
//
// Replaces construction_clip_tpu/ops/pallas_attention_block.py:_bwd_kernel
// (launched by _backward's pl.pallas_call). Given x and the output gradient g,
// it recomputes LN, qkv and the probabilities and returns dx, dqkv [B,T,3D],
// the recomputed merged heads [B,T,D] (operands of the weight-gradient GEMMs,
// which stay outside, as in the JAX package) and the LN scale/bias gradients.
// Rounding points follow _bwd_kernel: h and qkv as in the forward; dmerged =
// g . W_out^T in fp32, rounded to T per head (dmg); normalised fp32 p, and
// p_lo = T(p) for merged and dv; dp = dmg . v^T in fp32;
// ds = T(p (dp - rowsum(dp p)) scale); dq, dk, dv rounded to T; dh = dqkv .
// W_qkv^T in fp32 and the LN backward in fp32, dx rounded once.
//
// What bounds it on the H100: the three weight products (recomputed qkv,
// dmerged, dh) hold most of the FLOPs (14.9 of 15.7 GFLOP at [36, 50, 768]):
// the tensor cores' rate. The SIMT route (fp32, and bf16 at other head widths)
// runs them on the CUDA cores in fp32 FMA and is bound by the FMA rate; the
// tensor-core route below runs every product on wgmma.
//
// Design: the Pallas kernel keeps both weight matrices in 16 MiB of VMEM and
// carries the dLN sums across a sequential grid; a Hopper block has neither,
// so the C entry is a chain of launches with scratch the wrapper allocates:
//   (1) block_gemm<kQkv>           qkv = T(T(LN(x) W_qkv) + b_qkv)
//   (2) block_gemm<kRound, W^T>    dmg = T(g W_out^T)
//   (3) attn_rows<kStats>          per query row m, l, D (attention_tiles.cuh)
//   (4) attn_rows<kDq, ROUND>      dq and merged
//   (5) attn_cols<ROUND>           dk and dv
//   (6) block_gemm<kFloat, W^T>    dh = dqkv W_qkv^T (fp32)
//   (7) ln_backward_rows           dx, and each row's mean and rstd
//   (8) ln_param_partials          per 64-row chunk column sums of dh xhat, dh
//   (9) ln_param_reduce            dln = the chunks' sums, added in fixed order
// That is the bf16 chain at head widths other than 64 and 96. On the fp32
// route a row pass (ln_rows<float>, ln_rows.cuh) first writes h = LN(x) into a
// fifth D-wide slot of the T-typed scratch, once a row, where the caller
// finds it for the weight gradient of W_qkv; (1), (2) and (6) are then
// gemm_f32.cuh's register-blocked GEMM (qkv from h), bit-equal to block_gemm
// (10 launches in all).
// The attention passes stream 64-row tiles of K,V (or Q,dO) through shared
// memory, so one head never needs K, V, dK and dV resident at once (256 KB in
// fp32 at T=256, dh=64, over the 227 KB a block may have), and the [T,T]
// panels stay in registers. (8)+(9) replace the TPU's cross-grid accumulator
// with a second pass instead of atomics, so two runs give the same bits.
// No library GEMM or attention is called.
//
// Tensor-core route (bf16 at dh = 64 or 96, cct_attention_block_bwd_tc; chosen by
// ops/attention_block.py:route, never a retry of the other route): the same
// nine steps with the three weight products on wgmma (gemm_tc.cuh) and the
// three attention passes on wgmma (attention_tc.cuh, the K5 passes reading q,
// k, v out of qkv and dO out of dmg through column offsets, writing dq, dk and
// dv into their column slices of dqkv, and the dq pass writing merged; at
// dh 96 each head is three 32-column boxes, attention_tc.cuh). The
// products' A operands come from memory through TMA, so a row pass first
// writes h = T(LN(x)) (ln_rows.cuh, shared with K1 and K9) into a fifth
// D-wide slot of the T-typed scratch, where the caller finds it for the
// weight gradient of W_qkv (10 launches in all).
// A row pass and not a producer that normalises into the swizzled tile: TMA
// then stays a plain copy, and the pass moves 4 rows D bytes (5.5 MB at
// [36, 50, 768], ~2 us at the HBM rate). The rounding points are the SIMT chain's; p_lo and
// ds are the bf16 operands wgmma takes anyway. The LN backward (7)-(9) is
// shared with the SIMT chain.
#include <type_traits>

#include "attention_tc.cuh"
#include "attention_tiles.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "gemm_f32.cuh"
#include "gemm_tc.cuh"
#include "ln_rows.cuh"

namespace cct {
namespace {

constexpr int kLnChunk = 64, kColThreads = 256;   // kLnWarps: ln_rows.cuh

size_t ln_chunks(int rows) { return (rows + kLnChunk - 1) / kLnChunk; }

// fp32 scratch: attention stats (3 B H T), dh (B T D), row mean/rstd (2 B T),
// dLN partials (2 chunks D).
size_t work_floats(int b, int t, int d, int h) {
  const size_t rows = (size_t)b * t;
  return 3 * (size_t)b * h * t + rows * d + 2 * rows + 2 * ln_chunks((int)rows) * d;
}

template <typename T>
__global__ void __launch_bounds__(32 * kLnWarps)
ln_backward_rows(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ dh,
                 const T* __restrict__ ln_s, T* __restrict__ dx, float* __restrict__ row_mean,
                 float* __restrict__ row_rstd, int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kLnWarps + warp;
  if (m >= rows) return;
  const T* xr = x + (size_t)m * d;
  const float* dr = dh + (size_t)m * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / d;
  float var = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dv = to_f(xr[c]) - mean;
    var += dv * dv;
  }
  const float rstd = rsqrtf(warp_sum(var) / d + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dxhat = dr[c] * to_f(ln_s[c]);
    s1 += dxhat;
    s2 += dxhat * (to_f(xr[c]) - mean) * rstd;
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
  for (int c = lane; c < d; c += 32) {
    const float xhat = (to_f(xr[c]) - mean) * rstd;
    const float dxhat = dr[c] * to_f(ln_s[c]);
    dx[(size_t)m * d + c] =
        from_f<T>(to_f(g[(size_t)m * d + c]) + rstd * (dxhat - m1 - xhat * m2));
  }
  if (lane == 0) {
    row_mean[m] = mean;
    row_rstd[m] = rstd;
  }
}

// partial[0][chunk][col] = sum over the chunk's rows of dh * xhat,
// partial[1][chunk][col] = sum of dh.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
ln_param_partials(const T* __restrict__ x, const float* __restrict__ dh,
                  const float* __restrict__ row_mean, const float* __restrict__ row_rstd,
                  float* __restrict__ partial, int rows, int d) {
  const int col = blockIdx.x * kColThreads + threadIdx.x, chunk = blockIdx.y;
  if (col >= d) return;
  const int r0 = chunk * kLnChunk, r1 = min(rows, r0 + kLnChunk);
  float ss = 0.f, sb = 0.f;
  for (int m = r0; m < r1; ++m) {
    const float dv = dh[(size_t)m * d + col];
    ss += dv * (to_f(x[(size_t)m * d + col]) - row_mean[m]) * row_rstd[m];
    sb += dv;
  }
  partial[(size_t)chunk * d + col] = ss;
  partial[((size_t)gridDim.y + chunk) * d + col] = sb;
}

__global__ void __launch_bounds__(kColThreads)
ln_param_reduce(const float* __restrict__ partial, float* __restrict__ dln_s,
                float* __restrict__ dln_b, int chunks, int d) {
  const int col = blockIdx.x * kColThreads + threadIdx.x;
  if (col >= d) return;
  float ss = 0.f, sb = 0.f;
  for (int c = 0; c < chunks; ++c) {
    ss += partial[(size_t)c * d + col];
    sb += partial[((size_t)chunks + c) * d + col];
  }
  dln_s[col] = ss;
  dln_b[col] = sb;
}

#define CCT_TRY(expr)                      \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

// The LN backward (7)-(9), shared by both routes.
template <typename T>
cudaError_t ln_backward(const T* x, const T* g, const float* dh, const T* ln_s, T* dx,
                        float* row_mean, float* row_rstd, float* partial, float* dln_s,
                        float* dln_b, int rows, int d, float eps, cudaStream_t stream) {
  const int chunks = (int)ln_chunks(rows);
  ln_backward_rows<T><<<(rows + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, stream>>>(
      x, g, dh, ln_s, dx, row_mean, row_rstd, rows, d, eps);
  CCT_TRY(cudaGetLastError());
  const int col_blocks = (d + kColThreads - 1) / kColThreads;
  ln_param_partials<T><<<dim3(col_blocks, chunks), kColThreads, 0, stream>>>(
      x, dh, row_mean, row_rstd, partial, rows, d);
  CCT_TRY(cudaGetLastError());
  ln_param_reduce<<<col_blocks, kColThreads, 0, stream>>>(partial, dln_s, dln_b, chunks, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_block_bwd(const void* x_, const void* g_, const void* ln_s_, const void* ln_b_,
                          const void* w_qkv_, const void* b_qkv_, const void* w_out_,
                          void* work_t, float* work_f, void* dx, void* dqkv_, void* merged,
                          float* dln_s, float* dln_b, int b, int t, int d, int h, int causal,
                          float eps, float scale, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d % h != 0 || d / h > kMaxDh) return cudaErrorInvalidValue;
  const int rows = b * t, dh_ = d / h;
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  const T* ln_s = static_cast<const T*>(ln_s_);
  T* qkv = static_cast<T*>(work_t);           // [rows, 3D]
  T* dmg = qkv + (size_t)rows * 3 * d;        // [rows, D]
  T* dqkv = static_cast<T*>(dqkv_);
  float* st_m = work_f;
  float* st_l = st_m + (size_t)b * h * t;
  float* st_d = st_l + (size_t)b * h * t;
  float* dh = st_d + (size_t)b * h * t;       // [rows, D]
  float* row_mean = dh + (size_t)rows * d;
  float* row_rstd = row_mean + rows;
  float* partial = row_rstd + rows;

  const T* w_qkv = static_cast<const T*>(w_qkv_);
  const T* w_out = static_cast<const T*>(w_out_);
  constexpr bool kF32 = std::is_same_v<T, float>;
  if constexpr (kF32) {
    T* hn = dmg + (size_t)rows * d;           // [rows, D]: h = LN(x), left for the caller
    CCT_TRY(launch_ln_rows(x, ln_s, static_cast<const T*>(ln_b_), hn, rows, d, eps, stream));
    CCT_TRY((launch_gemm_f32<kQkv, false>(hn, w_qkv, static_cast<const T*>(b_qkv_), nullptr,
                                          qkv, rows, 3 * d, d, stream)));
    CCT_TRY((launch_gemm_f32<kRound, true>(g, w_out, nullptr, nullptr, dmg, rows, d, d,
                                           stream)));
  } else {
    CCT_TRY((launch_gemm<T, kQkv, false, T>(x, w_qkv, static_cast<const T*>(b_qkv_), ln_s,
                                            static_cast<const T*>(ln_b_), nullptr, qkv, rows,
                                            3 * d, d, eps, stream)));
    CCT_TRY((launch_gemm<T, kRound, true, T>(g, w_out, nullptr, nullptr, nullptr, nullptr, dmg,
                                             rows, d, d, eps, stream)));
  }

  AttnArgs a{};
  a.q = qkv;
  a.k = qkv + d;
  a.v = qkv + 2 * d;
  a.dout = dmg;
  a.m = st_m;
  a.l = st_l;
  a.dsum = st_d;
  a.in = HeadView{(long long)t * 3 * d, dh_, 3LL * d};
  a.dov = HeadView{(long long)t * d, dh_, d};
  a.n_heads = h;
  a.t_len = t;
  a.dh = dh_;
  a.causal = causal;
  a.scale = scale;
  CCT_TRY(launch_tiles(attn_rows<T, kStats, true>, a, b, stream));
  a.out = dqkv;                               // dq: columns [0, D)
  a.ov = a.in;
  a.out2 = merged;
  a.o2v = a.dov;
  CCT_TRY(launch_tiles(attn_rows<T, kDq, true>, a, b, stream));
  a.out = dqkv + d;                           // dk: columns [D, 2D)
  a.out2 = dqkv + 2 * d;                      // dv: columns [2D, 3D)
  a.o2v = a.in;
  CCT_TRY(launch_tiles(attn_cols<T, true>, a, b, stream));

  if constexpr (kF32)
    CCT_TRY((launch_gemm_f32<kFloat, true>(dqkv, w_qkv, nullptr, nullptr, dh, rows, d, 3 * d,
                                           stream)));
  else
    CCT_TRY((launch_gemm<T, kFloat, true, float>(dqkv, w_qkv, nullptr, nullptr, nullptr,
                                                 nullptr, dh, rows, d, 3 * d, eps, stream)));
  return ln_backward<T>(x, g, dh, ln_s, static_cast<T*>(dx), row_mean, row_rstd, partial, dln_s,
                        dln_b, rows, d, eps, stream);
}

// ---- tensor-core route (bf16, dh = 64 or 96) --------------------------------

// K3's three attention passes at head width DH: q, k, v out of qkv [B, T, 3D]
// and dO out of dmg [B, T, D] through maps of HeadTile<DH> boxes (zeros past
// T); dq, dk, dv into their column slices of dqkv, merged [B, T, D].
template <int DH>
cudaError_t block_attention_bwd_tc(const bf16* qkv, const bf16* dmg, float* stats, bf16* dqkv,
                                   bf16* merged, int b, int t, int d, int h, int causal,
                                   float scale, cudaStream_t stream) {
  const int heads = b * h;
  CUtensorMap mqkv, mg;
  CCT_TRY(head_map<DH>(&mqkv, qkv, b, t, 3 * d));
  CCT_TRY(head_map<DH>(&mg, dmg, b, t, d));
  const TcGeom geo{h, {0, d, 2 * d, 0}};
  const long long z3 = (long long)t * 3 * d;
  return tc_attention_bwd<true, DH>(mqkv, mqkv, mqkv, mg, geo, stats, stats + (size_t)heads * t,
                                    stats + 2 * (size_t)heads * t, TcOut{dqkv, z3, 3 * d},
                                    TcOut{merged, (long long)t * d, d},
                                    TcOut{dqkv + d, z3, 3 * d}, TcOut{dqkv + 2 * d, z3, 3 * d},
                                    heads, t, causal, scale, stream);
}

cudaError_t run_block_bwd_tc(const bf16* x, const bf16* g, const bf16* ln_s, const bf16* ln_b,
                             const bf16* w_qkv, const bf16* b_qkv, const bf16* w_out,
                             bf16* work_t, float* work_f, bf16* dx, bf16* dqkv, bf16* merged,
                             float* dln_s, float* dln_b, int b, int t, int d, int h, int causal,
                             float eps, float scale, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d % h != 0 || !tc_block_dh(d / h))
    return cudaErrorInvalidValue;
  const int rows = b * t, heads = b * h;
  bf16* qkv = work_t;                          // [rows, 3D]
  bf16* dmg = qkv + (size_t)rows * 3 * d;      // [rows, D]
  bf16* hn = dmg + (size_t)rows * d;           // [rows, D]: h = T(LN(x)), left for the caller
  float* st_m = work_f;
  float* dh = st_m + 3 * (size_t)heads * t;    // [rows, D]
  float* row_mean = dh + (size_t)rows * d;
  float* row_rstd = row_mean + rows;
  float* partial = row_rstd + rows;

  CCT_TRY(launch_ln_rows(x, ln_s, ln_b, hn, rows, d, eps, stream));
  CCT_TRY((launch_gemm_tc<kQkv, false>(hn, w_qkv, b_qkv, nullptr, qkv, rows, 3 * d, d, stream)));
  CCT_TRY((launch_gemm_tc<kRound, true>(g, w_out, nullptr, nullptr, dmg, rows, d, d, stream)));

  CCT_TRY(d / h == 64
              ? block_attention_bwd_tc<64>(qkv, dmg, st_m, dqkv, merged, b, t, d, h, causal,
                                           scale, stream)
              : block_attention_bwd_tc<96>(qkv, dmg, st_m, dqkv, merged, b, t, d, h, causal,
                                           scale, stream));

  CCT_TRY((launch_gemm_tc<kFloat, true>(dqkv, w_qkv, nullptr, nullptr, dh, rows, d, 3 * d,
                                          stream)));
  return ln_backward<bf16>(x, g, dh, ln_s, dx, row_mean, row_rstd, partial, dln_s, dln_b, rows,
                           d, eps, stream);
}

}  // namespace
}  // namespace cct

// Elements of the fp32 workspace cct_attention_block_bwd needs; its T-typed
// workspace holds qkv and dmg, B*T*4D elements, and in fp32 h = LN(x) after
// them, B*T*5D, which it leaves in the last B*T*D.
extern "C" long long cct_attention_block_bwd_work_floats(int b, int t, int d, int h) {
  return (long long)cct::work_floats(b, t, d, h);
}

// Returns a cudaError_t; nonzero means a launch was refused. All arrays are
// contiguous; dln_s and dln_b are fp32 [D], the rest of the input type. The
// SIMT route.
extern "C" int cct_attention_block_bwd(int dtype, const void* x, const void* g,
                                       const void* ln_s, const void* ln_b, const void* w_qkv,
                                       const void* b_qkv, const void* w_out, void* work_t,
                                       void* work_f, void* dx, void* dqkv, void* merged,
                                       void* dln_s, void* dln_b, int b, int t, int d, int h,
                                       int causal, float eps, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wf = static_cast<float*>(work_f);
  float* ds = static_cast<float*>(dln_s);
  float* db = static_cast<float*>(dln_b);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_block_bwd<float>(x, g, ln_s, ln_b, w_qkv, b_qkv, w_out, work_t, wf, dx,
                                       dqkv, merged, ds, db, b, t, d, h, causal, eps, scale, s);
    case cct::kBFloat16:
      return cct::run_block_bwd<__nv_bfloat16>(x, g, ln_s, ln_b, w_qkv, b_qkv, w_out, work_t,
                                               wf, dx, dqkv, merged, ds, db, b, t, d, h,
                                               causal, eps, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core route, same arguments: bf16 at dh = 64 or 96 only (anything
// else is refused, never run on the other route). Its T-typed workspace holds
// B*T*5D elements: qkv, dmg and h = T(LN(x)), which it leaves in the last
// B*T*D.
extern "C" int cct_attention_block_bwd_tc(int dtype, const void* x, const void* g,
                                          const void* ln_s, const void* ln_b, const void* w_qkv,
                                          const void* b_qkv, const void* w_out, void* work_t,
                                          void* work_f, void* dx, void* dqkv, void* merged,
                                          void* dln_s, void* dln_b, int b, int t, int d, int h,
                                          int causal, float eps, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  if (dtype != cct::kBFloat16) return cudaErrorInvalidValue;
  return cct::run_block_bwd_tc(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(ln_s),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w_qkv),
      static_cast<const bf16*>(b_qkv), static_cast<const bf16*>(w_out),
      static_cast<bf16*>(work_t), static_cast<float*>(work_f), static_cast<bf16*>(dx),
      static_cast<bf16*>(dqkv), static_cast<bf16*>(merged), static_cast<float*>(dln_s),
      static_cast<float*>(dln_b), b, t, d, h, causal, eps, scale,
      static_cast<cudaStream_t>(stream));
}
