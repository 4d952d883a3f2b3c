// Hopper (sm_90a) building blocks in inline PTX, for kernels that run their
// products on the tensor cores with tiles streamed by the Tensor Memory
// Accelerator:
//
//   mbarrier   init, arrive (with an expected byte count), wait on a phase;
//   TMA        a 2-D or 3-D tile copy from device memory into shared memory
//              that completes on an mbarrier (rows past the tensor's end are
//              zero);
//   wgmma      m64n64k16 and m64n128k16 bf16 -> fp32 with both operands in
//              shared memory (ss), m64n64k16 and m64n96k16 with A in
//              registers (rs), m64n64k32 and m64n128k32 s8 -> s32 (ss, both
//              operands K-major: 8-bit wgmma has no transpose), its fence /
//              commit / wait, and the shared-memory descriptors of 128- and
//              64-byte-swizzled tiles.
//
// A tile here is rows of 128 bytes (64 bf16 or 128 int8), written by a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned slot: the
// layout wgmma reads through a descriptor with the 128-byte swizzle. A box of
// 64-byte rows (32 bf16) takes the 64-byte swizzle instead, in a 512-byte-
// aligned slot (the attention passes' dh-96 heads: attention_tc.cuh).
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cct {
namespace hopper {

constexpr int kBoxRows = 64;                                       // rows of a tile
constexpr uint32_t kBoxBytes = kBoxRows * 64 * sizeof(__nv_bfloat16);   // 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (a 128-byte-swizzled tile's
// alignment); the caller asks for 1024 bytes more than it uses.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA); a __syncthreads
// follows before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to wait for `bytes` from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival (a consumer releasing a stage).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed. A phase
// that never completes (a copy that was never issued, a wrong byte count) traps
// after ~2^24 polls, seconds, so that a fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// ---- TMA --------------------------------------------------------------------

// Copies the box at coordinates (c0 innermost, c1, c2) of `map` into dst; the
// bytes count against `bar`'s expected transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 2-D map (c0 innermost).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator's registers at this point of the program, so that the
// compiler moves no read or write of them across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Descriptor of a 128-byte-swizzled tile in shared memory (start address,
// leading and stride byte offsets in 16-byte units, layout 1 = 128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// A tile whose rows run along the product's M or N and whose 128 bytes a row
// are the reduction index (K-major): 8-row groups 1024 bytes apart; a k-step
// of 32 bytes (16 bf16, or 32 int8) is +2 in the descriptor.
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  return desc_sw128(tile, 0, 1024);
}
// A tile whose rows are the reduction index and whose 64 columns run along N
// (MN-major, read with the transpose bit): one 64-wide swizzle atom in N, 8-row
// groups 1024 bytes apart; a k-step of 16 rows is 2048 bytes further (+128).
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile) {
  return desc_sw128(tile, 1024, 1024);
}
// An MN-major operand wider than 64 columns, built of one 64 x 64 tile per 64
// columns of N placed `atom_bytes` apart (each tile one TMA box): the leading
// byte offset is the step from one 64-column swizzle atom to the next, the
// stride byte offset the step between 8-row groups of the reduction, as above.
__device__ __forceinline__ uint64_t desc_mn_major_wide(const void* tile, uint32_t atom_bytes) {
  return desc_sw128(tile, atom_bytes, 1024);
}

// The 64-byte swizzle (layout 2): a box of 64-byte rows written by a TMA load
// with CU_TENSOR_MAP_SWIZZLE_64B. K-major: 8-row groups 512 bytes apart, a
// k-step of 32 bytes is +2 (two a row). MN-major (transpose bit): one 32-column
// swizzle atom a box, `atom_bytes` to the next along N (the leading byte
// offset), 8-row groups of the reduction 512 bytes apart; a k-step of 16 rows
// is 1024 bytes further (+64).
__device__ __forceinline__ uint64_t desc_sw64(const void* tile, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (2ull << 62);
}
__device__ __forceinline__ uint64_t desc_k_major_sw64(const void* tile) {
  return desc_sw64(tile, 0, 512);
}
__device__ __forceinline__ uint64_t desc_mn_major_sw64(const void* tile, uint32_t atom_bytes) {
  return desc_sw64(tile, atom_bytes, 512);
}

#define CCT_WGMMA_D32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define CCT_D8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B over k = 16, A [64 x 16] and B [16 x 64] in shared memory.
// accumulate == 0 overwrites d. d's element (row, col) of the warpgroup's
// [64 x 64] lives in thread 32w + 4g + q (w = row / 16, g = row % 8, q = col % 8
// / 2) at index 4 (col / 8) + 2 (row % 16 / 8) + col % 2.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CCT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : CCT_D8(0), CCT_D8(8), CCT_D8(16), CCT_D8(24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// The same with A in registers: a[0..3] hold the bf16 pairs of a warp's 16
// rows as mma.sync's m16n8k16 A fragment (rows g and g + 8, columns 2q, 2q + 1
// and 2q + 8, 2q + 9 of the k-step).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CCT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : CCT_D8(0), CCT_D8(8), CCT_D8(16), CCT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

#define CCT_WGMMA_D48                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"

// d (+)= A . B over k = 16, A in registers (as m64n64k16_rs) and B [16 x 96] in
// shared memory. d's element (row, col) lives where m64n64k16 puts it, with
// col / 8 up to 11 (acc_row / acc_col hold).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48], const uint32_t* a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " CCT_WGMMA_D48
      ", {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : CCT_D8(0), CCT_D8(8), CCT_D8(16), CCT_D8(24), CCT_D8(32), CCT_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

#define CCT_WGMMA_D64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A . B over k = 16, A [64 x 16] and B [16 x 128] in shared memory. d's
// element (row, col) lives where m64n64k16 puts it, with col / 8 up to 15:
// index 4 (col / 8) + 2 (row % 16 / 8) + col % 2 (acc_row / acc_col hold).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " CCT_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : CCT_D8(0), CCT_D8(8), CCT_D8(16), CCT_D8(24), CCT_D8(32), CCT_D8(40), CCT_D8(48),
        CCT_D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

#define CCT_I8(i)                                                                  \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),      \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (+)= A . B over k = 32, A [64 x 32] and B^T [64 x 32] int8 K-major tiles in
// shared memory, exact int32 sums. d's elements lie where m64n64k16 puts its
// fp32 ones (acc_row / acc_col hold).
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " CCT_WGMMA_D32
      ", %32, %33, p;\n}\n"
      : CCT_I8(0), CCT_I8(8), CCT_I8(16), CCT_I8(24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same with B^T [128 x 32].
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " CCT_WGMMA_D64
      ", %64, %65, p;\n}\n"
      : CCT_I8(0), CCT_I8(8), CCT_I8(16), CCT_I8(24), CCT_I8(32), CCT_I8(40), CCT_I8(48),
        CCT_I8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef CCT_D8
#undef CCT_I8
#undef CCT_WGMMA_D32
#undef CCT_WGMMA_D48
#undef CCT_WGMMA_D64

// Row and column, within the warpgroup's [64 x N] accumulator, of this
// thread's element k (0 .. N / 2 - 1).
__device__ __forceinline__ int acc_row(int k) {
  return ((threadIdx.x >> 5) << 4) + ((threadIdx.x & 31) >> 2) + (((k >> 1) & 1) << 3);
}
__device__ __forceinline__ int acc_col(int k) {
  return ((k >> 2) << 3) + ((threadIdx.x & 3) << 1) + (k & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A operand of a product whose reduction index is an
// accumulator's columns: accumulator elements k, k + 1 (k even: columns
// 8 (k / 4) + 2q and the next, row half (k / 2) % 2) as bf16 in word
// a_word(k) of the operand, k-step kk in words 4 kk .. 4 kk + 3.
__device__ __forceinline__ constexpr int a_word(int k) {
  return 4 * (k >> 3) + 2 * ((k >> 2) & 1) + ((k >> 1) & 1);
}
__device__ __forceinline__ void pack_a(const float (&d)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int k = 0; k < 32; k += 2) a[a_word(k)] = pack_bf16(d[k], d[k + 1]);
}

// d = A . B^T over a reduction of 64: A and B K-major tiles (four k-steps).
__device__ __forceinline__ void mma_abt(float (&d)[32], const void* a, const void* b) {
  const uint64_t da = desc_k_major(a), db = desc_k_major(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0>(d, da + 2 * kk, db + 2 * kk, kk);
}

// d += A . B over the first 16 `ksteps` rows of a reduction of 64: A from
// pack_a, B an MN-major tile. ksteps is the same in every thread.
__device__ __forceinline__ void mma_rb(float (&d)[32], const uint32_t (&a)[16], const void* b,
                                       int ksteps) {
  const uint64_t db = desc_mn_major(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < ksteps) wgmma_m64n64k16_rs<1>(d, &a[4 * kk], db + 128 * kk, 1);
  }
}

// Quad reductions: the four threads 4g .. 4g + 3 of a warp share accumulator rows.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- host: TMA descriptors --------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so that the
// library links against no libcuda; null where the driver lacks it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of an array [depth, rows, cols] of bf16 (or, with
// CU_TENSOR_MAP_DATA_TYPE_UINT8, of bytes: int8; with _FLOAT32, of fp32)
// (cols contiguous, a row `cols` elements long) in boxes of `box_bytes` bytes
// of columns x box_rows rows x 1: 128 bytes (64 bf16, 128 int8, 32 fp32) with
// the 128-byte swizzle, or 64 bytes (32 bf16) with the 64-byte swizzle; a box
// reaching past `rows` or `cols` reads zeros. depth 0 gives a 2-D map of
// [rows, cols] (coordinates column, row), depth >= 1 a 3-D map (column, row,
// depth index). TMA wants the base and the row pitch in multiples of 16 bytes.
inline cudaError_t tile_map(CUtensorMap* map, const void* base, int depth, int rows, int cols,
                            int box_rows,
                            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            int box_bytes = 128) {
  if (box_bytes != 128 && box_bytes != 64) return cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem = type == CU_TENSOR_MAP_DATA_TYPE_UINT8     ? 1
                          : type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? sizeof(float)
                                                                    : sizeof(__nv_bfloat16);
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * elem;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth > 0 ? depth : 1)};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {box_bytes / elem, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, type, depth > 0 ? 3 : 2,
                            const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a contiguous bf16 [heads, rows, 64] array in 64 x 64 boxes; a
// box past `rows` reads zeros.
inline cudaError_t head_tile_map(CUtensorMap* map, const void* base, int heads, int rows) {
  return tile_map(map, base, heads, rows, 64, kBoxRows);
}

}  // namespace hopper
}  // namespace cct
