// Tiled GEMM on the CUDA cores for the fused blocks' weight products (K1, K3,
// K9).
//
//   out[M, N] = epilogue(A'[M, K] . B[K, N])
//
// A' = T(LN(A)) with each row's LN statistics computed in the prologue (kQkv,
// kGelu), A otherwise. B is W [K, N] row-major, or with TRANS_B, W [N, K] read
// transposed (the backward's g . W_out^T and dqkv . W_qkv^T). Products and
// sums are fp32 FMA; the LN affine step and the epilogues' adds round each
// operation (__fmul_rn/__fadd_rn), so no contraction merges two roundings
// that the plain versions keep apart. Epilogues:
//   kQkv      out = T(T(acc) + bias)        (the forward's qkv rounding points)
//   kResidual out = T((resid + acc) + bias)  (the forward's residual output)
//   kRound    out = T(acc)
//   kFloat    out = acc                      (fp32 output)
//   kGelu     out = quick_gelu_t(T(T(acc) + bias))   (K9's hidden)
// Each of the 256 threads owns a 4x4 set of outputs strided by 16, so the
// shared-memory reads of a warp are broadcasts (A) or consecutive (W).
#pragma once

#include "common.cuh"

namespace cct {

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

enum Epilogue : int { kQkv = 0, kResidual = 1, kRound = 2, kFloat = 3, kGelu = 4 };

// QuickGELU x * (1 / (1 + exp(c x))) as ops/activations.quick_gelu computes
// it: each operation in fp32 and its result rounded to T, with c = -1.702
// rounded to T first (-1.703125 in bf16).
template <typename T>
__device__ __forceinline__ float quick_gelu_t(float x) {
  const float c = round_to<T>(-1.702f);
  const float e = round_to<T>(expf(round_to<T>(__fmul_rn(c, x))));
  const float r = round_to<T>(__fdiv_rn(1.f, round_to<T>(__fadd_rn(1.f, e))));
  return round_to<T>(__fmul_rn(x, r));
}

template <typename T, int EPI, bool TRANS_B, typename Out>
__global__ void __launch_bounds__(kGemmThreads)
block_gemm(const T* __restrict__ a, const T* __restrict__ w, const T* __restrict__ bias,
           const T* __restrict__ ln_s, const T* __restrict__ ln_b,
           const T* __restrict__ resid, Out* __restrict__ out, int M, int N, int K,
           float eps) {
  __shared__ float a_s[kBK][kBM + 1];
  __shared__ float w_s[kBK][kBN + 1];
  __shared__ float row_mean[kBM];
  __shared__ float row_rstd[kBM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  constexpr bool kLnPrologue = EPI == kQkv || EPI == kGelu;
  if constexpr (kLnPrologue) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < M) {
        const T* xr = a + (size_t)m * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += to_f(xr[k]);
        mean = warp_sum(s) / K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float dv = to_f(xr[k]) - mean;
          v += dv * dv;
        }
        rstd = rsqrtf(warp_sum(v) / K + eps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kGemmThreads) {
      const int r = i / kBK, c = i % kBK, m = m0 + r, k = k0 + c;
      float v = 0.f;
      if (m < M && k < K) {
        v = to_f(a[(size_t)m * K + k]);
        if constexpr (kLnPrologue)
          v = round_to<T>(__fadd_rn(
              __fmul_rn(__fmul_rn(v - row_mean[r], row_rstd[r]), to_f(ln_s[k])),
              to_f(ln_b[k])));
      }
      a_s[c][r] = v;
    }
    for (int i = tid; i < kBK * kBN; i += kGemmThreads) {
      // consecutive threads read consecutive addresses of W in both layouts
      const int r = TRANS_B ? i % kBK : i / kBN, c = TRANS_B ? i / kBK : i % kBN;
      const int k = k0 + r, n = n0 + c;
      float v = 0.f;
      if (k < K && n < N) v = to_f(TRANS_B ? w[(size_t)n * K + k] : w[(size_t)k * N + n]);
      w_s[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if constexpr (EPI == kQkv)
        out[o] = from_f<T>(round_to<T>(acc[i][j]) + to_f(bias[n]));
      else if constexpr (EPI == kGelu)
        out[o] = from_f<T>(quick_gelu_t<T>(
            round_to<T>(__fadd_rn(round_to<T>(acc[i][j]), to_f(bias[n])))));
      else if constexpr (EPI == kResidual)
        out[o] = from_f<T>(__fadd_rn(__fadd_rn(to_f(resid[o]), acc[i][j]), to_f(bias[n])));
      else if constexpr (EPI == kRound)
        out[o] = from_f<T>(acc[i][j]);
      else
        out[o] = acc[i][j];
    }
  }
}

template <typename T, int EPI, bool TRANS_B, typename Out>
cudaError_t launch_gemm(const T* a, const T* w, const T* bias, const T* ln_s, const T* ln_b,
                        const T* resid, Out* out, int M, int N, int K, float eps,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  block_gemm<T, EPI, TRANS_B, Out><<<grid, kGemmThreads, 0, stream>>>(
      a, w, bias, ln_s, ln_b, resid, out, M, N, K, eps);
  return cudaGetLastError();
}

}  // namespace cct
