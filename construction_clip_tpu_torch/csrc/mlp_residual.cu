// K9: fused pre-norm MLP residual,
//   out = x + W_proj . quick_gelu(LN(x) . W_fc + b_fc) + b_proj
//
// Replaces construction_clip_tpu/ops/pallas_mlp.py:_kernel (launched by
// _forward's pl.pallas_call). Rounding points follow that kernel: LN in fp32
// with h rounded to T; T(h . W_fc in fp32) + b_fc in T; QuickGELU in T, each
// operation rounded (gemm.cuh: quick_gelu_t); h . W_proj in fp32; the output
// T((x32 + y) + b_proj) rounded once.
//
// What bounds it on the H100: 4 rows D H operations (3.8 GFLOP at
// [8,50,768] -> 3072) against 9.4 MB of bf16 weights and 1.2 MB of x and out,
// ~360 operations a byte: the tensor cores' 3.8 us, just over HBM's 3.2 us.
//
// Design: the Pallas kernel keeps both weight matrices (9.4 MB for ViT-B in
// fp32) and the [rows, 4D] hidden in VMEM. A Hopper block has at most 227 KB
// of shared memory, so K9 is a chain of launches from one C entry, with the
// hidden in device scratch the wrapper allocates. Two routes, chosen by
// ops/mlp.py:route (a launch on one never retries the other):
//
// SIMT (fp32, and bf16 where D or H is no multiple of 8; cct_mlp_residual),
// fp32 FMA on the CUDA cores (fp32 on the tensor cores would be TF32). fp32,
// K1's fp32 chain with K9's epilogues:
//   (a) ln_rows<float> (ln_rows.cuh): h = LN(x) once a row, into `out`;
//   (b) gemm_f32<kGelu> (gemm_f32.cuh): hidden = quick_gelu_t(h W_fc + b_fc),
//       a register-blocked GEMM fed by a TMA ring;
//   (c) gemm_f32<kResidual>: out = (x + hidden W_proj) + b_proj.
//   The fc product has 48 column tiles at H = 3072; the proj product (N = D,
//   K = H) has D / 64, and gemm_f32_rows spreads its rows over the SMs (no
//   split-K: the sums keep block_gemm's order, so the bits are block_gemm's).
// bf16 where D or H is no multiple of 8 (gemm_f32 is fp32 only): gemm.cuh's
// block_gemm<kGelu>, K1's LN-prologue GEMM with a bias + QuickGELU epilogue
// writing the hidden [rows, H] in T, then block_gemm<kResidual>.
//
// Tensor cores (bf16 with D and H multiples of 8, TMA's 16-byte row pitch;
// cct_mlp_residual_tc), both products on wgmma (gemm_tc.cuh):
//   (1) ln_rows (ln_rows.cuh): h = T(LN(x)) once a row, into `out`, which
//       nothing reads again before (3) writes it;
//   (2) gemm_tc<kGelu>: hidden = quick_gelu_t(T(T(h W_fc) + b_fc));
//   (3) gemm_tc<kResidual>: out = T((x + hidden W_proj) + b_proj).
// The hidden goes through device memory, not through shared memory: 2.4 MB
// at [8,50,768] and 11 MB at [36,50,768], both inside the 50 MB L2. Holding
// it on chip would take a [64, D] fp32 accumulator a block (384 registers a
// thread for one warpgroup at D = 768) or a split-K reduction over H / 256
// blocks, for the bytes of one L2 round trip.
// No library GEMM is called.
#include <type_traits>

#include "common.cuh"
#include "gemm.cuh"
#include "gemm_f32.cuh"
#include "gemm_tc.cuh"
#include "ln_rows.cuh"

namespace cct {
namespace {

template <typename T>
cudaError_t run_mlp(const void* x, const void* ln_s, const void* ln_b, const void* w_fc,
                    const void* b_fc, const void* w_proj, const void* b_proj, void* hidden,
                    void* out, int rows, int d, int h, float eps, cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || h <= 0) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* ht = static_cast<T*>(hidden);
  T* ot = static_cast<T*>(out);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    err = launch_ln_rows(xt, static_cast<const T*>(ln_s), static_cast<const T*>(ln_b), ot, rows,
                         d, eps, stream);
    if (err == cudaSuccess)
      err = launch_gemm_f32<kGelu, false>(ot, static_cast<const T*>(w_fc),
                                          static_cast<const T*>(b_fc), nullptr, ht, rows, h, d,
                                          stream);
    if (err != cudaSuccess) return err;
    return launch_gemm_f32<kResidual, false>(ht, static_cast<const T*>(w_proj),
                                             static_cast<const T*>(b_proj), xt, ot, rows, d, h,
                                             stream);
  } else {
    err = launch_gemm<T, kGelu, false, T>(xt, static_cast<const T*>(w_fc),
                                          static_cast<const T*>(b_fc), static_cast<const T*>(ln_s),
                                          static_cast<const T*>(ln_b), nullptr, ht, rows, h, d,
                                          eps, stream);
    if (err != cudaSuccess) return err;
    return launch_gemm<T, kResidual, false, T>(ht, static_cast<const T*>(w_proj),
                                               static_cast<const T*>(b_proj), nullptr, nullptr,
                                               xt, ot, rows, d, h, eps, stream);
  }
}

cudaError_t run_mlp_tc(const __nv_bfloat16* x, const __nv_bfloat16* ln_s,
                       const __nv_bfloat16* ln_b, const __nv_bfloat16* w_fc,
                       const __nv_bfloat16* b_fc, const __nv_bfloat16* w_proj,
                       const __nv_bfloat16* b_proj, __nv_bfloat16* hidden, __nv_bfloat16* out,
                       int rows, int d, int h, float eps, cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || h <= 0 || d % 8 || h % 8) return cudaErrorInvalidValue;
  cudaError_t err = launch_ln_rows(x, ln_s, ln_b, out, rows, d, eps, stream);
  if (err == cudaSuccess)
    err = launch_gemm_tc<kGelu, false>(out, w_fc, b_fc, nullptr, hidden, rows, h, d, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm_tc<kResidual, false>(hidden, w_proj, b_proj, x, out, rows, d, h, stream);
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means a launch was refused. x and out are
// [rows, d], w_fc [d, h], w_proj [h, d], hidden [rows, h] scratch, all of the
// input type and contiguous. The SIMT route.
extern "C" int cct_mlp_residual(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                const void* w_fc, const void* b_fc, const void* w_proj,
                                const void* b_proj, void* hidden, void* out, int rows, int d,
                                int h, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_mlp<float>(x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, hidden, out,
                                 rows, d, h, eps, s);
    case cct::kBFloat16:
      return cct::run_mlp<__nv_bfloat16>(x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, hidden,
                                         out, rows, d, h, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core route, same arguments: bf16 with d and h multiples of 8 only
// (anything else is refused, never run on the other route).
extern "C" int cct_mlp_residual_tc(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                   const void* w_fc, const void* b_fc, const void* w_proj,
                                   const void* b_proj, void* hidden, void* out, int rows, int d,
                                   int h, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  if (dtype != cct::kBFloat16) return cudaErrorInvalidValue;
  return cct::run_mlp_tc(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(w_fc), static_cast<const bf16*>(b_fc),
      static_cast<const bf16*>(w_proj), static_cast<const bf16*>(b_proj),
      static_cast<bf16*>(hidden), static_cast<bf16*>(out), rows, d, h, eps,
      static_cast<cudaStream_t>(stream));
}
