// K1: fused pre-norm attention block forward,
//   out = x + W_out . MHA(split_heads(LN(x) . W_qkv + b_qkv)) + b_out
//
// Replaces construction_clip_tpu/ops/pallas_attention_block.py:_kernel (launched
// by _forward's pl.pallas_call). Rounding points follow that kernel: LN in fp32
// with h rounded to T; qkv = T(h . W_qkv in fp32) + b_qkv in T; logits in fp32
// times dh^-0.5, causal keys masked; the unnormalised p = exp(logit - max) is
// rounded to T for p . v (fp32 sum) and the result divided by the fp32 row sum
// of p; the output is T(x32 + y + b_out) rounded once.
//
// What bounds it on the H100: the two weight GEMMs hold ~99% of the FLOPs
// (at [8,50,768]: 1.9 GFLOP against 4.7 MB of bf16 weights and 1.2 MB of x
// and out, ~320 operations a byte, just over the ~295 at which the tensor
// cores and not HBM become the limit: 1.9 us at 989 TFLOP/s).
//
// Design: on the TPU both weight matrices sit in VMEM (5.3 MB for ViT-B). A
// Hopper block has at most 227 KB of shared memory, so the block is a chain of
// launches from one C entry, with qkv and the merged heads in device scratch
// the wrapper allocates. Two routes, chosen by ops/attention_block.py:route
// (a launch on one never retries the other):
//
// SIMT (fp32, and bf16 at head widths other than 64 and 96;
// cct_attention_block_fwd),
// the products in fp32 FMA on the CUDA cores (fp32 on the tensor cores would
// be TF32, a different result), bound by the FMA rate. fp32:
//   (a) ln_rows<float> (ln_rows.cuh): h = LN(x) once a row, into the merged
//       scratch until (b) has read it;
//   (b) gemm_f32<kQkv> (gemm_f32.cuh): qkv = h W_qkv + b_qkv, a
//       register-blocked GEMM fed by a TMA ring;
//   (c) row_attention (row_attention.cuh): blocks of 16 or 64 query rows of a
//       head, the rows' whole score panel (T <= 256) in shared memory, k and v
//       streamed by cp.async into register micro-tiles, two sweeps so that p
//       rounds against the row's final max;
//   (d) gemm_f32<kResidual>: merged . W_out with a bias + residual epilogue.
// bf16 at other head widths: block_gemm<kQkv> (gemm.cuh), a 64x64-tiled GEMM
// whose prologue computes each row's LN statistics and normalises the A tile
// as it is staged, (c), and block_gemm<kResidual>. The fp32 outputs are
// bit-equal to what block_gemm gave on that route (gemm_f32.cuh).
//
// Tensor cores (bf16 at dh = 64 or 96, T <= 256; cct_attention_block_fwd_tc),
// every product on wgmma with TMA-fed tiles, K3's tensor-core design:
//   (1) ln_rows (ln_rows.cuh): h = T(LN(x)), into the merged scratch, once a
//       row (the SIMT prologue normalises each A element again for each of the
//       3D / 64 column tiles);
//   (2) gemm_tc<kQkv> (gemm_tc.cuh): qkv = T(T(h W_qkv) + b_qkv), W_qkv read
//       where it lies (MN-major);
//   (3) tc_block_fwd (attention_tc.cuh): per (batch, head) and 64-row query
//       tile, q, k and v read out of qkv at their column offsets through 3-D
//       TMA maps, merged written at the head's columns; dh 96 (GPT-2's
//       transformer mapper) reads each head as three 32-column boxes;
//   (4) gemm_tc<kResidual>: out = T((x + merged W_out) + b_out).
// The rounding points are the SIMT chain's; bf16(p) is the operand wgmma takes
// anyway. No library GEMM or attention is called.
#include <type_traits>

#include "attention_tc.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "gemm_f32.cuh"
#include "gemm_tc.cuh"
#include "ln_rows.cuh"
#include "row_attention.cuh"

namespace cct {
namespace {

template <typename T>
cudaError_t run_block(const void* x, const void* ln_s, const void* ln_b, const void* w_qkv,
                      const void* b_qkv, const void* w_out, const void* b_out, void* qkv,
                      void* merged, void* out, int b, int t, int d, int h, int causal,
                      float eps, float scale, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d % h != 0) return cudaErrorInvalidValue;
  const int m = b * t;
  constexpr bool kF32 = std::is_same_v<T, float>;
  cudaError_t err;
  if constexpr (kF32) {
    err = launch_ln_rows(static_cast<const T*>(x), static_cast<const T*>(ln_s),
                         static_cast<const T*>(ln_b), static_cast<T*>(merged), m, d, eps, stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm_f32<kQkv, false>(static_cast<const T*>(merged),
                                       static_cast<const T*>(w_qkv),
                                       static_cast<const T*>(b_qkv), nullptr,
                                       static_cast<T*>(qkv), m, 3 * d, d, stream);
  } else {
    err = launch_gemm<T, kQkv, false, T>(
        static_cast<const T*>(x), static_cast<const T*>(w_qkv), static_cast<const T*>(b_qkv),
        static_cast<const T*>(ln_s), static_cast<const T*>(ln_b), nullptr,
        static_cast<T*>(qkv), m, 3 * d, d, eps, stream);
  }
  if (err != cudaSuccess) return err;

  err = launch_row_attention(static_cast<const T*>(qkv), static_cast<T*>(merged), b, t, d, h,
                             causal, scale, stream);
  if (err != cudaSuccess) return err;

  if constexpr (kF32)
    return launch_gemm_f32<kResidual, false>(
        static_cast<const T*>(merged), static_cast<const T*>(w_out),
        static_cast<const T*>(b_out), static_cast<const T*>(x), static_cast<T*>(out), m, d, d,
        stream);
  else
    return launch_gemm<T, kResidual, false, T>(
        static_cast<const T*>(merged), static_cast<const T*>(w_out),
        static_cast<const T*>(b_out), nullptr, nullptr, static_cast<const T*>(x),
        static_cast<T*>(out), m, d, d, eps, stream);
}

#define CCT_TRY(expr)                      \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

// K1's attention pass at head width DH: q, k and v read out of qkv [B, T, 3D]
// through one map of HeadTile<DH> boxes (zeros past T), merged [B, T, D].
template <int DH>
cudaError_t block_attention_tc(const bf16* qkv, bf16* merged, int b, int t, int d, int h,
                               int causal, float scale, cudaStream_t stream) {
  CUtensorMap mqkv;
  CCT_TRY(head_map<DH>(&mqkv, qkv, b, t, 3 * d));
  return tc_launch(tc_block_fwd<bf16, DH>, tc_block_smem_bytes<DH>(t), b * h, t, stream, mqkv,
                   TcGeom{h, {0, d, 2 * d, 0}}, TcOut{merged, (long long)t * d, d}, t, causal,
                   scale);
}

// The tensor-core route: h = T(LN(x)) lives in `merged` until the qkv product
// has read it, then the attention pass overwrites it with the merged heads.
cudaError_t run_block_tc(const bf16* x, const bf16* ln_s, const bf16* ln_b, const bf16* w_qkv,
                         const bf16* b_qkv, const bf16* w_out, const bf16* b_out, bf16* qkv,
                         bf16* merged, bf16* out, int b, int t, int d, int h, int causal,
                         float eps, float scale, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d % h != 0 || !tc_block_dh(d / h) ||
      n_tiles(t) > kBlockMaxTiles)
    return cudaErrorInvalidValue;
  const int rows = b * t;
  CCT_TRY(launch_ln_rows(x, ln_s, ln_b, merged, rows, d, eps, stream));
  CCT_TRY((launch_gemm_tc<kQkv, false>(merged, w_qkv, b_qkv, nullptr, qkv, rows, 3 * d, d,
                                       stream)));
  CCT_TRY(d / h == 64 ? block_attention_tc<64>(qkv, merged, b, t, d, h, causal, scale, stream)
                      : block_attention_tc<96>(qkv, merged, b, t, d, h, causal, scale, stream));
  return launch_gemm_tc<kResidual, false>(merged, w_out, b_out, x, out, rows, d, d, stream);
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means a launch was refused. qkv [B*T, 3D] and
// merged [B*T, D] are scratch of the input type; all arrays are contiguous.
// The SIMT route.
extern "C" int cct_attention_block_fwd(int dtype, const void* x, const void* ln_s,
                                       const void* ln_b, const void* w_qkv,
                                       const void* b_qkv, const void* w_out,
                                       const void* b_out, void* qkv, void* merged,
                                       void* out, int b, int t, int d, int h, int causal,
                                       float eps, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_block<float>(x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, qkv, merged,
                                   out, b, t, d, h, causal, eps, scale, s);
    case cct::kBFloat16:
      return cct::run_block<__nv_bfloat16>(x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, qkv,
                                           merged, out, b, t, d, h, causal, eps, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core route, same arguments: bf16 at dh = 64 or 96 and T <= 256
// only (anything else is refused, never run on the other route).
extern "C" int cct_attention_block_fwd_tc(int dtype, const void* x, const void* ln_s,
                                          const void* ln_b, const void* w_qkv,
                                          const void* b_qkv, const void* w_out,
                                          const void* b_out, void* qkv, void* merged,
                                          void* out, int b, int t, int d, int h, int causal,
                                          float eps, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  if (dtype != cct::kBFloat16) return cudaErrorInvalidValue;
  return cct::run_block_tc(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(w_qkv), static_cast<const bf16*>(b_qkv),
      static_cast<const bf16*>(w_out), static_cast<const bf16*>(b_out), static_cast<bf16*>(qkv),
      static_cast<bf16*>(merged), static_cast<bf16*>(out), b, t, d, h, causal, eps, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* cct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
