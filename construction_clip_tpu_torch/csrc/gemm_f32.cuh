// fp32 GEMM on the CUDA cores for the weight products of the fp32 routes of
// K1, K3 and K9:
//
//   out[M, N] = epilogue(A[M, K] . B[K, N])
//
// Replaces gemm.cuh's block_gemm on those routes (qkv = h W_qkv, merged W_out
// + x, dmg = g W_out^T, dh = dqkv W_qkv^T; K9's hidden = QuickGELU(h W_fc +
// b_fc) and hidden W_proj + x); block_gemm stays for the bf16 SIMT routes of
// K1/K3 and K9. A is row-major fp32 [M, K], already normalised where the
// product needs LN(x) (ln_rows.cuh writes h once a row; block_gemm normalised
// each A element again for every column tile). B is W [K, N] row-major, or
// with TRANS_B W [N, K] read transposed (g W_out^T and dqkv W_qkv^T).
// Epilogues: gemm.cuh's kQkv, kResidual, kRound, kFloat and kGelu, in
// block_gemm's arithmetic.
//
// What bounds it on the H100: fp32 on the tensor cores would be TF32, a
// different result, so the products run in fp32 FMA on the CUDA cores, 2 M N K
// operations at 67 TFLOP/s (the qkv product at [36, 50, 768]: 6.4 GFLOP,
// 95 us) against 4 (M K + K N + M N) bytes (25 MB there, 7.5 us at the HBM
// rate): the FMA rate.
//
// Design: a block owns a BM x 64 output tile, four consumer warps and one
// producer warp.
// - Each consumer thread owns BM / 8 x 4 outputs: rows ty + 8 i, and four
//   columns (4 tx .. 4 tx + 3, or tx + 16 j where B is W^T). It reads its
//   operands as 16-byte shared-memory loads, one float4 along k a row of A
//   (and of W^T) serving four k-steps, one float4 along n a k-step of W: 2.7
//   FMAs for each float loaded at BM = 64, against block_gemm's 2.
// - The producer streams K slices of 32 into a ring of kF32Stages stages with
//   TMA (the tiles in 128-byte-swizzled rows of 32 floats, so that the 8 rows
//   or columns of a quarter-warp's loads fall in 32 distinct banks; zeros past
//   M, N and K), a `full` mbarrier a stage counting its bytes and an `empty`
//   one that each consumer warp arrives on when it is done with the stage. No
//   block-wide barrier runs in the main loop, so a warp waits only for its
//   data, and the address arithmetic of the copies leaves the consumers.
//   Where a row or an operand is not 16-byte aligned (fp32 at d = 18: rows of
//   72 bytes), which TMA does not take, the producer warp's 32 lanes copy the
//   same swizzled tiles with scalar loads instead.
// - The tile is 64, 48 or 32 rows x 64 columns, chosen per product so that
//   the tiles spread over the SMs (gemm_f32_rows): a block of 5 warps leaves
//   room for several on an SM, which hides latency better than one block of
//   a larger tile, and fewer rows fill the SMs where 64 would leave some idle.
// - Each output has one accumulator, summed with fmaf over k in ascending
//   order, over K rounded up to 16 with zeros past K (the last slice stops at
//   16 where that ends it), as block_gemm sums it: the outputs are bit-equal to
//   block_gemm's. No split-K and no atomics, so two calls give the same bits.
// No library GEMM, no TF32 and no wgmma.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "gemm.cuh"  // Epilogue
#include "hopper.cuh"

namespace cct {
namespace {

constexpr int kF32BN = 64, kF32BK = 32, kF32Stages = 4;
constexpr int kF32Tx = 16, kF32Ty = 8;             // consumer threads along n and m
constexpr int kF32Consumers = kF32Tx * kF32Ty;     // 128: BM / 8 x 4 outputs each
constexpr int kF32Threads = kF32Consumers + 32;    // and the producer warp
constexpr uint32_t kF32BBytes = kF32BN * kF32BK * sizeof(float);  // B's tile a stage

template <int BM>
struct F32Tile {
  static constexpr int kTm = BM / kF32Ty;          // rows a thread
  static constexpr uint32_t kABytes = BM * kF32BK * sizeof(float);
  static constexpr uint32_t kStageBytes = kABytes + kF32BBytes;
  static constexpr size_t kSmemBytes = 1024 + kF32Stages * kStageBytes + 2 * kF32Stages * 8;
};

// The float offset of (row r, k) in a tile of 128-byte rows (32 floats) with
// the 128-byte swizzle: the 16-byte chunk k / 4 sits at chunk (k / 4) ^ (r % 8).
__device__ __forceinline__ int f32_swizzled(int r, int k) {
  return r * kF32BK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

// The producer without TMA: K slice kt of A (64 rows from m0) and B into a
// stage, laid out as TMA lays it (A and W^T: 64 swizzled rows; W: two boxes
// of 32 k-rows x 32 swizzled columns), zeros past M, N and K; one float a
// lane.
template <bool TRANS_B>
__device__ __forceinline__ void gemm_f32_copy(float* as, const float* __restrict__ a,
                                              const float* __restrict__ w, int m0, int n0,
                                              int kt, int M, int N, int K, int lane) {
  float* bs = as + kF32BN * kF32BK;
  const int k0 = kt * kF32BK;
  for (int e = lane; e < kF32BN * kF32BK; e += 32) {
    const int r = e / kF32BK, k = e % kF32BK;
    const int m = m0 + r, n = n0 + r;
    as[f32_swizzled(r, k)] = m < M && k0 + k < K ? a[(size_t)m * K + k0 + k] : 0.f;
    if constexpr (TRANS_B) {
      bs[f32_swizzled(r, k)] = n < N && k0 + k < K ? w[(size_t)n * K + k0 + k] : 0.f;
    } else {  // e as (k row, column): box c / 32, swizzled within
      const int kr = e / kF32BN, c = e % kF32BN, nc = n0 + c;
      bs[(c / 32) * (32 * kF32BK) + f32_swizzled(kr, c % 32)] =
          nc < N && k0 + kr < K ? w[(size_t)(k0 + kr) * N + nc] : 0.f;
    }
  }
}

// One K slice (or its first 16 k where that ends K rounded up to 16: GROUPS 4)
// of a consumer thread's 8 x 4 products. The thread's A rows ty + 8 i share
// the swizzle phase ty, its W^T rows tx + 16 j the phase tx % 8; a k-row of W
// has the phase k % 8, known at compile time.
template <bool TRANS_B, int GROUPS, int TM>
__device__ __forceinline__ void gemm_f32_slice(float (&acc)[TM][4], const float* as,
                                               const float* bs, int tx, int ty) {
  const float* ar = as + ty * kF32BK;
  const float* br = TRANS_B ? bs + tx * kF32BK : bs + (tx >> 3) * (32 * kF32BK);
  const int sa = ty & 7, sb = tx & 7;
#pragma unroll
  for (int c = 0; c < GROUPS; ++c) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(ar + i * kF32Ty * kF32BK + ((c ^ sa) << 2));
    if constexpr (TRANS_B) {
      float4 bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(br + j * kF32Tx * kF32BK + ((c ^ sb) << 2));
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(f32_lane(av[i], q), f32_lane(bv[j], q), acc[i][j]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // columns 4 tx .. 4 tx + 3 of k-row 4 c + q: box tx / 8, chunk tx % 8
        const int k = 4 * c + q;
        const float4 bv =
            *reinterpret_cast<const float4*>(br + k * kF32BK + ((sb ^ (k & 7)) << 2));
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(f32_lane(av[i], q), f32_lane(bv, j), acc[i][j]);
      }
    }
  }
}

// grid (ceil(N / 64), ceil(M / 64)), kF32Threads threads. TMA: ma and mb map
// A and B (launch_gemm_f32); else the producer copies from a and w.
template <int EPI, bool TRANS_B, bool TMA, int BM>
__global__ void __launch_bounds__(kF32Threads)
gemm_f32(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
         const float* __restrict__ a, const float* __restrict__ w,
         const float* __restrict__ bias, const float* __restrict__ resid,
         float* __restrict__ out, int M, int N, int K) {
  using namespace hopper;
  static_assert(TMA || BM == kF32BN, "the scalar producer fills 64-row tiles");
  extern __shared__ uint8_t f32_smem[];
  uint8_t* base = align_1024(f32_smem);
  using Tile = F32Tile<BM>;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kF32Stages * Tile::kStageBytes);
  uint64_t* empty = full + kF32Stages;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kF32BN;
  const int k16 = (K + 15) / 16 * 16, k_tiles = (k16 + kF32BK - 1) / kF32BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);
      mbar_init(&empty[s], kF32Consumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kF32Consumers) {  // the producer warp
    const int lane = threadIdx.x - kF32Consumers;
    if (TMA && lane != 0) return;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kF32Stages;
      if (kt >= kF32Stages)  // the stage's previous slice is consumed
        mbar_wait(&empty[s], (kt / kF32Stages - 1) & 1);
      uint8_t* stage = base + s * Tile::kStageBytes;
      if constexpr (TMA) {
        mbar_expect_tx(&full[s], Tile::kStageBytes);
        tma_load_2d(stage, &ma, &full[s], kt * kF32BK, m0);
        if constexpr (TRANS_B) {
          tma_load_2d(stage + Tile::kABytes, &mb, &full[s], kt * kF32BK, n0);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)  // 32 k-rows of W [K, N], 32 columns a box
            tma_load_2d(stage + Tile::kABytes + j * kF32BBytes / 2, &mb, &full[s],
                        n0 + 32 * j, kt * kF32BK);
        }
      } else {
        gemm_f32_copy<TRANS_B>(reinterpret_cast<float*>(stage), a, w, m0, n0, kt, M, N, K,
                               lane);
        mbar_arrive(&full[s]);  // releases this lane's stores to the consumers
      }
    }
    return;
  }

  const int tx = threadIdx.x % kF32Tx, ty = threadIdx.x / kF32Tx;
  float acc[Tile::kTm][4];
#pragma unroll
  for (int i = 0; i < Tile::kTm; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kF32Stages;
    mbar_wait(&full[s], (kt / kF32Stages) & 1);
    const float* as = reinterpret_cast<const float*>(base + s * Tile::kStageBytes);
    const float* bs = as + BM * kF32BK;
    if (k16 - kt * kF32BK >= kF32BK)
      gemm_f32_slice<TRANS_B, kF32BK / 4>(acc, as, bs, tx, ty);
    else
      gemm_f32_slice<TRANS_B, 4>(acc, as, bs, tx, ty);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < Tile::kTm; ++i) {
    const int m = m0 + ty + kF32Ty * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + (TRANS_B ? tx + kF32Tx * j : 4 * tx + j);
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if constexpr (EPI == kQkv)
        out[o] = acc[i][j] + bias[n];
      else if constexpr (EPI == kResidual)
        out[o] = __fadd_rn(__fadd_rn(resid[o], acc[i][j]), bias[n]);
      else if constexpr (EPI == kGelu)
        out[o] = quick_gelu_t<float>(__fadd_rn(acc[i][j], bias[n]));
      else
        out[o] = acc[i][j];  // kRound and kFloat: fp32 rounds nothing
    }
  }
}

template <int EPI, bool TRANS_B, bool TMA, int BM>
cudaError_t launch_gemm_f32_tile(const float* a, const float* w, const float* bias,
                                 const float* resid, float* out, int M, int N, int K,
                                 cudaStream_t stream) {
  CUtensorMap ma{}, mb{};
  if constexpr (TMA) {
    constexpr auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    cudaError_t err = hopper::tile_map(&ma, a, 0, M, K, BM, f32);
    if (err == cudaSuccess)
      err = TRANS_B ? hopper::tile_map(&mb, w, 0, N, K, kF32BN, f32)
                    : hopper::tile_map(&mb, w, 0, K, N, kF32BK, f32);
    if (err != cudaSuccess) return err;
  }
  const auto kernel = gemm_f32<EPI, TRANS_B, TMA, BM>;
  constexpr size_t smem = F32Tile<BM>::kSmemBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kF32BN - 1) / kF32BN, (M + BM - 1) / BM);
  kernel<<<grid, kF32Threads, smem, stream>>>(ma, mb, a, w, bias, resid, out, M, N, K);
  return cudaGetLastError();
}

// The tile's rows: of 64, 48 and 32, the first whose tiles cost the fewest
// rounds over the SMs, a round costing a tile's rows (ceil(tiles / SMs) BM):
// at [400, 768] 48 (108 tiles, one round, against 84 tiles of 64 rows), at
// [400, 2304] 64 (252 tiles: two rounds, as 324 of 48 rows take three).
inline cudaError_t gemm_f32_rows(int M, int N, int* bm) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  long long best = -1;
  for (const int rows : {64, 48, 32}) {
    const long long tiles = (long long)((M + rows - 1) / rows) * ((N + kF32BN - 1) / kF32BN);
    const long long cost = (tiles + sms - 1) / sms * rows;
    if (best < 0 || cost < best) *bm = rows, best = cost;
  }
  return cudaSuccess;
}

// out = epilogue(a [M, K] . B): B = w [K, N] (TRANS_B false) or w [N, K] read
// transposed (true); bias for kQkv, kResidual and kGelu, resid [M, N] for kResidual
// (else null). Any M, N, K >= 1: TMA where K (and N for W [K, N]) is a
// multiple of 4 and a and w are 16-byte aligned, with the tile's rows from
// gemm_f32_rows; else the scalar producer on 64 rows.
template <int EPI, bool TRANS_B>
cudaError_t launch_gemm_f32(const float* a, const float* w, const float* bias,
                            const float* resid, float* out, int M, int N, int K,
                            cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (K % 4 || (!TRANS_B && N % 4) || !aligned16(a) || !aligned16(w))
    return launch_gemm_f32_tile<EPI, TRANS_B, false, 64>(a, w, bias, resid, out, M, N, K, stream);
  int bm = 64;
  const cudaError_t err = gemm_f32_rows(M, N, &bm);
  if (err != cudaSuccess) return err;
  switch (bm) {
    case 64:
      return launch_gemm_f32_tile<EPI, TRANS_B, true, 64>(a, w, bias, resid, out, M, N, K, stream);
    case 48:
      return launch_gemm_f32_tile<EPI, TRANS_B, true, 48>(a, w, bias, resid, out, M, N, K, stream);
    default:
      return launch_gemm_f32_tile<EPI, TRANS_B, true, 32>(a, w, bias, resid, out, M, N, K, stream);
  }
}

}  // namespace
}  // namespace cct
