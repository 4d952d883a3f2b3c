// The row pass of the fused blocks' LN-prologue products (K1, K3, K9):
//
//   h = T(LN(x))   (T [rows, d] -> T [rows, d]; T bf16 or fp32)
//
// the A operand of the LN-prologue weight product (qkv, or K9's fc), which TMA
// then copies as it lies (the tensor-core routes, and gemm_f32.cuh on K1's and
// K3's fp32 route). One warp a row, with gemm.cuh's prologue
// arithmetic: two-pass statistics in fp32 over the row, each affine step
// rounded (__fmul_rn / __fadd_rn, so that no contraction merges two
// roundings), h rounded once to T, so that h is bit-equal to what block_gemm's
// prologue stages. It moves 4 rows d bytes in bf16 (1.2 MB at [8, 50, 768]),
// 8 in fp32, a few microseconds at the HBM rate.
#pragma once

#include "common.cuh"

namespace cct {
namespace {

constexpr int kLnWarps = 8;  // rows a block, one warp each

template <typename T>
__global__ void __launch_bounds__(32 * kLnWarps)
    ln_rows(const T* __restrict__ x, const T* __restrict__ ln_s, const T* __restrict__ ln_b,
            T* __restrict__ h, int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kLnWarps + warp;
  if (m >= rows) return;
  const T* xr = x + (size_t)m * d;
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
    h[(size_t)m * d + c] = from_f<T>(__fadd_rn(
        __fmul_rn(__fmul_rn(to_f(xr[c]) - mean, rstd), to_f(ln_s[c])), to_f(ln_b[c])));
}

template <typename T>
cudaError_t launch_ln_rows(const T* x, const T* ln_s, const T* ln_b, T* h, int rows, int d,
                           float eps, cudaStream_t stream) {
  ln_rows<T><<<(rows + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, stream>>>(x, ln_s, ln_b, h,
                                                                          rows, d, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cct
