// Tiled int8 GEMM on the tensor cores for K7's two weight products, with
// per-row activation scales and per-column weight scales:
//
//   out[M, N] = epilogue(int32(A[M, K] . B[K, N]))
//
// A is the quantized rows, int8 [M, K] row-major (K-major). B is the weight as
// ops/quant.gemm_layout stores it: K contiguous, so its transpose w_t [N, K] is
// row-major (K-major too; 8-bit wgmma has no transpose bit), read in place.
//
// gemm_tc.cuh's design with int8 tiles: a block owns a BM x BN output tile (64
// or 128 each) as BM / 64 consumer warpgroups running wgmma m64nBNk32 s8 ->
// s32, and a producer warp streams BM x 128 tiles of A and BN x 128 tiles of
// w_t with TMA (128-byte swizzle: a 128-byte row is 128 int8 values of K, so a
// k-tile is 128 deep and a k-step of 32 is +2 in the descriptor; zeros past M,
// N and K) into a ring of kGemmTcStages stages (gemm_tc_mainloop, shared with
// gemm_tc); the tile is chosen by gemm_tc_tile. TMA wants the row pitch in
// multiples of 16 bytes: K % 16 == 0.
//
// What bounds it: at K7's shapes (M = 50 .. 400 rows, K = 768) a tile is six
// k-tiles deep, so a launch is mostly the ring's fill and the epilogue, not
// the tensor cores' rate: 6.0 us for [400, 768] x [768, 2304] (12% of the
// 1,979 TOP/s int8 peak) and 5.8 us for [400, 768] x [768, 768] on an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 15).
//
// The int32 sums are exact in any order (|sum| <= K 127^2, 16.5 M at K = 1024,
// far below 2^31), so this GEMM's output is bit-equal to the __dp4a GEMM's of
// attention_block_int8.cu. The epilogues are that GEMM's:
//   kInt8Qkv       out = T(float(acc) * a_scale[m] * w_scale[n] + bias[n])
//   kInt8Residual  out = T((resid[m, n] + float(acc) * a_scale[m] * w_scale[n]) + bias[n])
// each step rounded (__fmul_rn / __fadd_rn: no contraction into an FMA).
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "hopper.cuh"

namespace cct {
namespace {

constexpr int kS8BK = kGemmTcRowBytes;  // int8 values of K a k-tile

enum Int8Epilogue : int { kInt8Qkv = 0, kInt8Residual = 1 };

// A k-tile's four int8 k-steps of 32 (32 bytes of both K-major tiles each).
template <int BN>
struct GemmS8Mma {
  __device__ __forceinline__ void operator()(int (&acc)[BN / 2], const uint8_t* a,
                                             const uint8_t* b) const {
    using namespace hopper;
    const uint64_t da = desc_k_major(a), db = desc_k_major(b);
#pragma unroll
    for (int kk = 0; kk < kS8BK / 32; ++kk) {
      if constexpr (BN == 128)
        wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, 1);
      else
        wgmma_m64n64k32_s8(acc, da + 2 * kk, db + 2 * kk, 1);
    }
  }
};

// grid (N / BN, M / BM), 2 BM + 32 threads: a warpgroup per 64 rows, then
// the producer warp. T is the output's type (fp32 or bf16), as are bias and
// resid.
template <int EPI, typename T, int BM, int BN>
__global__ void __launch_bounds__(2 * BM + 32)
    gemm_s8(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
            const float* __restrict__ a_scale, const float* __restrict__ w_scale,
            const T* __restrict__ bias, const T* __restrict__ resid, T* __restrict__ out, int M,
            int N, int K) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  int acc[BN / 2];
  if (!gemm_tc_mainloop<true, BM, BN, kS8BK>(acc, align_1024(smem_raw), &ma, &mb, K,
                                             GemmS8Mma<BN>{}))
    return;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float sa[2];  // the scales of this thread's two rows (acc_row's row halves)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + acc_row(2 * r);
    sa[r] = row < M ? a_scale[row] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < BN / 2; k += 2) {
    const int row = m0 + acc_row(k), col = n0 + acc_col(k);  // acc_row spans both warpgroups
    if (row >= M || col >= N) continue;  // N is even: col + 1 < N too
    const size_t o = (size_t)row * N + col;
    const float s = sa[(k >> 1) & 1];
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[k + j]), s), w_scale[col + j]);
      if constexpr (EPI == kInt8Qkv)
        v[j] = __fadd_rn(y, to_f(bias[col + j]));
      else
        v[j] = __fadd_rn(__fadd_rn(to_f(resid[o + j]), y), to_f(bias[col + j]));
    }
    if constexpr (std::is_same_v<T, float>) {
      out[o] = v[0];
      out[o + 1] = v[1];
    } else {
      *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v[0], v[1]);
    }
  }
}

template <int EPI, typename T, int BM, int BN>
cudaError_t launch_gemm_s8_tile(const int8_t* a, const float* a_scale, const int8_t* w_t,
                                const float* w_scale, const T* bias, const T* resid, T* out,
                                int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ma, mb;
  cudaError_t err = hopper::tile_map(&ma, a, 0, M, K, BM, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == cudaSuccess)
    err = hopper::tile_map(&mb, w_t, 0, N, K, BN, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = gemm_tc_smem_bytes<BM, BN>();
  const auto kernel = gemm_s8<EPI, T, BM, BN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, 2 * BM + 32, smem, stream>>>(ma, mb, a_scale, w_scale, bias, resid, out, M, N,
                                              K);
  return cudaGetLastError();
}

// out = epilogue(a [M, K] . w_t^T), w_t [N, K] row-major; resid only for
// kInt8Residual (else null). K % 16 == 0 (TMA's row pitch) and N even.
template <int EPI, typename T>
cudaError_t launch_gemm_s8(const int8_t* a, const float* a_scale, const int8_t* w_t,
                           const float* w_scale, const T* bias, const T* resid, T* out, int M,
                           int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 2 || K % 16) return cudaErrorInvalidValue;
  int tile = 0;
  const cudaError_t err = gemm_tc_tile(M, N, &tile);
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 0:
      return launch_gemm_s8_tile<EPI, T, 128, 128>(a, a_scale, w_t, w_scale, bias, resid, out,
                                                   M, N, K, stream);
    case 1:
      return launch_gemm_s8_tile<EPI, T, 64, 128>(a, a_scale, w_t, w_scale, bias, resid, out, M,
                                                  N, K, stream);
    default:
      return launch_gemm_s8_tile<EPI, T, 64, 64>(a, a_scale, w_t, w_scale, bias, resid, out, M,
                                                 N, K, stream);
  }
}

}  // namespace
}  // namespace cct
