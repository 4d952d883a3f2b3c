// K9: fused pre-norm MLP residual,
//   out = x + W_proj . quick_gelu(LN(x) . W_fc + b_fc) + b_proj
//
// Replaces construction_clip_tpu/ops/pallas_mlp.py:_kernel (launched by
// _forward's pl.pallas_call). Rounding points follow that kernel: LN in fp32
// with h rounded to T; T(h . W_fc in fp32) + b_fc in T; QuickGELU in T, each
// operation rounded (gemm.cuh: quick_gelu_t); h . W_proj in fp32; the output
// T((x32 + y) + b_proj) rounded once.
//
// Design: the Pallas kernel keeps both weight matrices (9.4 MB for ViT-B in
// fp32) and the [rows, 4D] hidden in VMEM. A Hopper block has at most 227 KB
// of shared memory, so K9 is two launches of gemm.cuh's tiled GEMM from one C
// entry, with the hidden in device scratch the wrapper allocates:
//   (a) block_gemm<kGelu>: K1's LN-prologue GEMM with a bias + QuickGELU
//       epilogue, writing the hidden [rows, H] in T;
//   (b) block_gemm<kResidual>: hidden . W_proj with the bias + residual
//       epilogue.
// The products run on the CUDA cores in fp32 FMA, as K1's do. No library GEMM
// is called.
#include "common.cuh"
#include "gemm.cuh"

namespace cct {
namespace {

template <typename T>
cudaError_t run_mlp(const void* x, const void* ln_s, const void* ln_b, const void* w_fc,
                    const void* b_fc, const void* w_proj, const void* b_proj, void* hidden,
                    void* out, int rows, int d, int h, float eps, cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || h <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = launch_gemm<T, kGelu, false, T>(
      static_cast<const T*>(x), static_cast<const T*>(w_fc), static_cast<const T*>(b_fc),
      static_cast<const T*>(ln_s), static_cast<const T*>(ln_b), nullptr,
      static_cast<T*>(hidden), rows, h, d, eps, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T, kResidual, false, T>(
      static_cast<const T*>(hidden), static_cast<const T*>(w_proj),
      static_cast<const T*>(b_proj), nullptr, nullptr, static_cast<const T*>(x),
      static_cast<T*>(out), rows, d, h, eps, stream);
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means a launch was refused. x and out are
// [rows, d], w_fc [d, h], w_proj [h, d], hidden [rows, h] scratch, all of the
// input type and contiguous.
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
