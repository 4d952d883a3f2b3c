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
// (at [8,50,768]: 1.9 GFLOP against 4.7 MB of bf16 weights, i.e. far below
// the ~295 FLOP/byte ridge, so a tensor-core GEMM would be bound by reading
// the weights). This first version runs the products on the CUDA cores in fp32
// FMA, so it is bound by the FMA rate, not by memory.
//
// Design: on the TPU both weight matrices sit in VMEM (5.3 MB for ViT-B). A
// Hopper block has at most 227 KB of shared memory, so the block is three
// launches from one C entry, with qkv and the merged heads in device scratch
// the wrapper allocates:
//   (a) block_gemm<kQkv> (gemm.cuh): a 64x64-tiled GEMM whose prologue computes
//       each row's LN statistics and normalises the A tile as it is staged;
//   (b) head_attention (head_attention.cuh): one block per (batch, head) with
//       that head's K and V (T <= 256) staged in dynamic shared memory; one
//       warp per query row;
//   (c) block_gemm<kResidual>: merged . W_out with a bias + residual epilogue.
// No library GEMM or attention is called.
#include "common.cuh"
#include "gemm.cuh"
#include "head_attention.cuh"

namespace cct {
namespace {

template <typename T>
cudaError_t run_block(const void* x, const void* ln_s, const void* ln_b, const void* w_qkv,
                      const void* b_qkv, const void* w_out, const void* b_out, void* qkv,
                      void* merged, void* out, int b, int t, int d, int h, int causal,
                      float eps, float scale, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d % h != 0) return cudaErrorInvalidValue;
  const int m = b * t;
  const size_t smem = attn_smem_bytes(t, d / h);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;

  cudaError_t err = launch_gemm<T, kQkv, false, T>(
      static_cast<const T*>(x), static_cast<const T*>(w_qkv), static_cast<const T*>(b_qkv),
      static_cast<const T*>(ln_s), static_cast<const T*>(ln_b), nullptr,
      static_cast<T*>(qkv), m, 3 * d, d, eps, stream);
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(head_attention<T, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  head_attention<T, T><<<dim3(b, h), kAttnThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(merged), t, d, h, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  return launch_gemm<T, kResidual, false, T>(
      static_cast<const T*>(merged), static_cast<const T*>(w_out),
      static_cast<const T*>(b_out), nullptr, nullptr, static_cast<const T*>(x),
      static_cast<T*>(out), m, d, d, eps, stream);
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means a launch was refused. qkv [B*T, 3D] and
// merged [B*T, D] are scratch of the input type; all arrays are contiguous.
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

extern "C" const char* cct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
