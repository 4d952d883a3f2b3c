// Tiled GEMM on the tensor cores for the fused blocks' weight products (K1,
// K3, K9; bf16 operands, fp32 sums):
//
//   out[M, N] = epilogue(A[M, K] . B[K, N])
//
// A is a row-major bf16 [M, K] (K-major). B is a weight read where it lies:
// W [K, N] row-major is MN-major and wgmma reads it with the transpose bit
// (h . W_qkv); W [N, K] row-major is B's transpose, K-major (g . W_out^T and
// dqkv . W_qkv^T). No weight is copied.
//
// What bounds it: at the blocks' shapes (M = 400 .. 2772 rows, N and K = 512 ..
// 3072)
// 2 M N K operations against 2 (M K + K N + M N) bytes, hundreds of operations
// a byte: the tensor cores, not HBM. The design: a block owns a BM x BN output
// tile (64 or 128 each) as BM / 64 consumer warpgroups of 64 rows, each running
// wgmma m64nBNk16 with both operands in shared memory, and one producer warp
// that streams BM x 64 tiles of A and BN x 64 (or 64 x BN) tiles of B with TMA
// (128-byte swizzle, zeros past M, N and K) into a ring of kGemmTcStages
// stages. A stage has a `full` mbarrier (the TMA bytes landed) and an `empty`
// one (every consumer warpgroup is done with it): the producer refills a stage
// as soon as it is free, and the consumers never wait on each other. A
// consumer keeps one k-tile's products in flight while it issues the next
// (wgmma wait 1) and frees a stage when its products are done
// (gemm_tc_mainloop, which gemm_s8.cuh's int8 GEMM shares). The tile is
// chosen per product so that the tiles spread evenly over the SMs
// (gemm_tc_tile). Rows past M are masked at the store.
//
// Epilogues (gemm.cuh's rounding points, Epilogue):
//   kQkv      out = T(T(acc) + bias)
//   kResidual out = T((resid + acc) + bias), resid [M, N] like out
//   kRound    out = T(acc)
//   kFloat    out = acc (fp32)
//   kGelu     out = quick_gelu_t(T(T(acc) + bias))
#pragma once

#include "common.cuh"
#include "gemm.cuh"
#include "hopper.cuh"

namespace cct {
namespace {

constexpr int kGemmTcBK = 64, kGemmTcStages = 4;  // a k-tile: 64 bf16, 128 bytes a row
constexpr int kGemmTcRowBytes = 128;                 // gemm_s8.cuh's k-tile: 128 int8

template <int BM>
__host__ __device__ constexpr uint32_t gemm_tc_a_bytes() {
  return BM * kGemmTcRowBytes;
}

template <int BM, int BN>
__host__ __device__ constexpr uint32_t gemm_tc_stage_bytes() {
  return gemm_tc_a_bytes<BM>() + BN * kGemmTcRowBytes;
}

template <int BM, int BN>
constexpr size_t gemm_tc_smem_bytes() {
  return 1024 + kGemmTcStages * (size_t)gemm_tc_stage_bytes<BM, BN>() +
         2 * kGemmTcStages * sizeof(uint64_t);
}

// The producer: k-tile kt (BK elements of K) of A and B into its stage.
template <bool B_KMAJOR, int BM, int BN, int BK>
__device__ __forceinline__ void gemm_tc_issue(uint8_t* base, uint64_t* full, const CUtensorMap* ma,
                                              const CUtensorMap* mb, int kt, int m0, int n0) {
  const int st = kt % kGemmTcStages, k0 = kt * BK;
  uint8_t* a = base + st * gemm_tc_stage_bytes<BM, BN>();
  uint8_t* b = a + gemm_tc_a_bytes<BM>();
  hopper::mbar_expect_tx(&full[st], gemm_tc_stage_bytes<BM, BN>());
  hopper::tma_load_2d(a, ma, &full[st], k0, m0);
  if constexpr (B_KMAJOR) {
    hopper::tma_load_2d(b, mb, &full[st], k0, n0);  // BN rows of W [N, K]
  } else {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)  // 64 rows of W [K, N], 64 columns a box
      hopper::tma_load_2d(b + j * hopper::kBoxBytes, mb, &full[st], n0 + 64 * j, k0);
  }
}

// The main loop of a block of 2 BM + 32 threads (a consumer warpgroup per 64
// rows, then the producer warp), shared by gemm_tc and gemm_s8: the producer
// streams the k-tiles of A [M, K] and B into the ring and returns false; each
// consumer runs mma(acc, a, b) on every k-tile (a its 64 rows of A's tile, b
// B's tile), keeps one k-tile's products in flight while it issues the next,
// frees a stage when its products are done, and returns true with acc summed
// over K. acc starts at zero.
template <bool B_KMAJOR, int BM, int BN, int BK, typename Acc, int N, typename Mma>
__device__ __forceinline__ bool gemm_tc_mainloop(Acc (&acc)[N], uint8_t* base,
                                                 const CUtensorMap* ma, const CUtensorMap* mb,
                                                 int K, Mma mma) {
  using namespace hopper;
  static_assert((BM == 64 || BM == 128) && (BN == 64 || BN == 128), "m64 / m128, n64 / n128");
  constexpr int kConsumers = BM / 64;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + kGemmTcStages * gemm_tc_stage_bytes<BM, BN>());
  uint64_t* empty = full + kGemmTcStages;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt_n = (K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kGemmTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == kConsumers) {  // the producer warp; its lane 0 issues every load
    if (threadIdx.x % 32 == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        if (kt >= kGemmTcStages)  // the stage's previous k-tile is consumed
          mbar_wait(&empty[kt % kGemmTcStages], (kt / kGemmTcStages - 1) & 1);
        gemm_tc_issue<B_KMAJOR, BM, BN, BK>(base, full, ma, mb, kt, m0, n0);
      }
    }
    return false;
  }

#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % kGemmTcStages;
    mbar_wait(&full[st], (kt / kGemmTcStages) & 1);
    const uint8_t* a = base + st * gemm_tc_stage_bytes<BM, BN>();
    fence_regs(acc);
    wgmma_fence();
    mma(acc, a + wg * gemm_tc_a_bytes<64>(), a + gemm_tc_a_bytes<BM>());  // this warpgroup's rows
    wgmma_commit();
    wgmma_wait<1>();  // k-tile kt - 1's products are done: free its stage
    fence_regs(acc);
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % kGemmTcStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  return true;
}

// A k-tile's four bf16 k-steps of 16: a k-step is 32 bytes along a K-major
// row, 16 rows (2048 bytes) of an MN-major tile.
template <bool B_KMAJOR, int BN>
struct GemmTcBf16Mma {
  __device__ __forceinline__ void operator()(float (&acc)[BN / 2], const uint8_t* a,
                                             const uint8_t* b) const {
    using namespace hopper;
    const uint64_t da = desc_k_major(a);
    const uint64_t db = B_KMAJOR ? desc_k_major(b)
                        : BN == 64 ? desc_mn_major(b)
                                   : desc_mn_major_wide(b, kBoxBytes);
#pragma unroll
    for (int kk = 0; kk < kGemmTcBK / 16; ++kk) {
      const uint64_t dbk = db + (B_KMAJOR ? 2 : 128) * kk;
      if constexpr (BN == 128)
        wgmma_m64n128k16_ss<B_KMAJOR ? 0 : 1>(acc, da + 2 * kk, dbk, 1);
      else
        wgmma_m64n64k16_ss<B_KMAJOR ? 0 : 1>(acc, da + 2 * kk, dbk, 1);
    }
  }
};

// grid (N / BN, M / BM), 2 BM + 32 threads: a warpgroup per 64 rows, then
// the producer warp.
template <int EPI, bool B_KMAJOR, int BM, int BN>
__global__ void __launch_bounds__(2 * BM + 32)
    gemm_tc(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
            const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ resid,
            void* __restrict__ out, int M, int N, int K) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  float acc[BN / 2];
  if (!gemm_tc_mainloop<B_KMAJOR, BM, BN, kGemmTcBK>(acc, align_1024(smem_raw), &ma, &mb, K,
                                                     GemmTcBf16Mma<B_KMAJOR, BN>{}))
    return;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

#pragma unroll
  for (int k = 0; k < BN / 2; k += 2) {
    const int row = m0 + acc_row(k), col = n0 + acc_col(k);  // acc_row spans both warpgroups
    if (row >= M || col >= N) continue;
    const size_t o = (size_t)row * N + col;
    if constexpr (EPI == kFloat) {
      float* dst = static_cast<float*>(out) + o;  // scalar stores: o may be odd
      dst[0] = acc[k];
      dst[1] = acc[k + 1];
    } else {
      float v0 = acc[k], v1 = acc[k + 1];
      if constexpr (EPI == kQkv) {
        v0 = round_to<__nv_bfloat16>(v0) + to_f(bias[col]);
        v1 = round_to<__nv_bfloat16>(v1) + to_f(bias[col + 1]);
      } else if constexpr (EPI == kResidual) {  // scalar loads: resid may be 2-byte aligned
        v0 = __fadd_rn(__fadd_rn(to_f(resid[o]), v0), to_f(bias[col]));
        v1 = __fadd_rn(__fadd_rn(to_f(resid[o + 1]), v1), to_f(bias[col + 1]));
      } else if constexpr (EPI == kGelu) {
        using bf = __nv_bfloat16;
        v0 = quick_gelu_t<bf>(round_to<bf>(__fadd_rn(round_to<bf>(v0), to_f(bias[col]))));
        v1 = quick_gelu_t<bf>(round_to<bf>(__fadd_rn(round_to<bf>(v1), to_f(bias[col + 1]))));
      }
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + o) = pack_bf16(v0, v1);
    }
  }
}

template <int EPI, bool B_KMAJOR, int BM, int BN>
cudaError_t launch_gemm_tc_tile(const __nv_bfloat16* a, const __nv_bfloat16* w,
                                const __nv_bfloat16* bias, const __nv_bfloat16* resid, void* out,
                                int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ma, mb;
  cudaError_t err = hopper::tile_map(&ma, a, 0, M, K, BM);
  if (err == cudaSuccess)
    err = B_KMAJOR ? hopper::tile_map(&mb, w, 0, N, K, BN) : hopper::tile_map(&mb, w, 0, K, N, 64);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = gemm_tc_smem_bytes<BM, BN>();
  const auto kernel = gemm_tc<EPI, B_KMAJOR, BM, BN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, 2 * BM + 32, smem, stream>>>(ma, mb, bias, resid, out, M, N, K);
  return cudaGetLastError();
}

// The tile of an [M, N] product: of 128 x 128, 64 x 128 and 64 x 64 (index
// 0, 1, 2), the first whose tiles cost the fewest rounds over the SMs, a round
// costing a tile's area (ceil(tiles / SMs) BM BN): at [1800, 2304] 64 x 128
// (522 tiles, 3.95 an SM) and not 128 x 128 (270 tiles: 2.05 an SM, so some
// SMs run 3); 64 x 64 for the N = D products.
inline cudaError_t gemm_tc_tile(int M, int N, int* tile) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  constexpr int kTiles[3][2] = {{128, 128}, {64, 128}, {64, 64}};
  long long best_cost = -1;
  for (int i = 0; i < 3; ++i) {
    const int bm = kTiles[i][0], bn = kTiles[i][1];
    const long long tiles = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * bm * bn;
    if (best_cost < 0 || cost < best_cost) *tile = i, best_cost = cost;
  }
  return cudaSuccess;
}

// out = epilogue(a [M, K] . B): B = w [K, N] (B_KMAJOR false) or w [N, K]
// read transposed (true); resid only for kResidual (else null). K and N
// multiples of 8 (TMA's 16-byte row pitch). The tile: gemm_tc_tile.
template <int EPI, bool B_KMAJOR>
cudaError_t launch_gemm_tc(const __nv_bfloat16* a, const __nv_bfloat16* w,
                           const __nv_bfloat16* bias, const __nv_bfloat16* resid, void* out,
                           int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return cudaErrorInvalidValue;
  int tile = 0;
  const cudaError_t err = gemm_tc_tile(M, N, &tile);
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 0:
      return launch_gemm_tc_tile<EPI, B_KMAJOR, 128, 128>(a, w, bias, resid, out, M, N, K,
                                                          stream);
    case 1:
      return launch_gemm_tc_tile<EPI, B_KMAJOR, 64, 128>(a, w, bias, resid, out, M, N, K, stream);
    default:
      return launch_gemm_tc_tile<EPI, B_KMAJOR, 64, 64>(a, w, bias, resid, out, M, N, K, stream);
  }
}

}  // namespace
}  // namespace cct
