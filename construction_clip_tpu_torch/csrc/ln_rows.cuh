// The row pass of the fused blocks' tensor-core routes (K1, K3, K9):
//
//   h = T(LN(x))   (bf16 [rows, d] -> bf16 [rows, d])
//
// the A operand of the LN-prologue weight product (qkv, or K9's fc), which TMA
// then copies as it lies. One warp a row, with gemm.cuh's prologue arithmetic:
// two-pass statistics in fp32 over the row, each affine step rounded
// (__fmul_rn / __fadd_rn, so that no contraction merges two roundings), h
// rounded once to bf16. It moves 4 rows d bytes (1.2 MB at [8, 50, 768]), a
// few microseconds at the HBM rate.
#pragma once

#include "common.cuh"

namespace cct {
namespace {

constexpr int kLnWarps = 8;  // rows a block, one warp each

__global__ void __launch_bounds__(32 * kLnWarps)
    ln_rows(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln_s,
            const __nv_bfloat16* __restrict__ ln_b, __nv_bfloat16* __restrict__ h, int rows,
            int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kLnWarps + warp;
  if (m >= rows) return;
  const __nv_bfloat16* xr = x + (size_t)m * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / d;
  float var = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dv = to_f(xr[c]) - mean;
    var += dv * dv;
  }
  const float rstd = rsqrtf(warp_sum(var) / d + eps);
  for (int c = lane; c < d; c += 32)
    h[(size_t)m * d + c] = from_f<__nv_bfloat16>(__fadd_rn(
        __fmul_rn(__fmul_rn(to_f(xr[c]) - mean, rstd), to_f(ln_s[c])), to_f(ln_b[c])));
}

cudaError_t launch_ln_rows(const __nv_bfloat16* x, const __nv_bfloat16* ln_s,
                           const __nv_bfloat16* ln_b, __nv_bfloat16* h, int rows, int d,
                           float eps, cudaStream_t stream) {
  ln_rows<<<(rows + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, stream>>>(x, ln_s, ln_b, h, rows,
                                                                        d, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cct
