// K8: streaming vocab-head GEMV for small-batch decode steps.
//
// Replaces construction_clip_tpu/ops/pallas_vocab_head.py:_gemv (the
// pl.pallas_call in vocab_head_logits), which models/t5.py:_head_logits runs for
// every cached single-token mT5 decode step at B <= 8.
//
// out[b, v] = sum_d float(x[b, d]) * float(table[d, v])      (bf16 table)
// out[b, v] = (sum_d float(x[b, d]) * float(q[d, v])) * scale[v]   (int8 table)
// x is bf16 (the wrapper rounds it, as the Pallas kernel's caller does), the sum
// is fp32, and the output is fp32, never rounded to bf16. int8 values are exact
// in fp32 (|q| <= 127), as they are in bf16 on the TPU.
//
// What bounds it on the H100: bytes. mT5-small's head is 512 x 250112: 256 MB in
// bf16, 128 MB in int8, read once per step against at most 8 x 2 FLOPs per
// element, far below the ridge and far above the 50 MB L2. The design keeps the
// table stream coalesced and many loads in flight:
//   - each block owns a tile of 256 adjacent columns; each lane of a warp owns 8
//     adjacent columns, read as one 16-byte (bf16) or 8-byte (int8) load per
//     table row, so a warp reads 512 (256) contiguous bytes of a row at once;
//   - the block's 4 warps split D into 4 contiguous chunks, and each warp issues
//     the loads of kVhUnroll rows before it uses any of them;
//   - the loads are streaming (__ldcs): no row is read twice in a step;
//   - x lives in shared memory as fp32 (<= 8 x D), read as warp broadcasts;
//   - the warps' partial sums are added in a fixed order (warp 0, 1, 2, 3)
//     through shared memory, so two runs give the same bits (no atomics).
// Any V is taken: when V is not a multiple of 8 (or the table is not aligned),
// the loads are scalar and guarded at the tail.
#include <cstdint>

#include "common.cuh"

namespace cct {
namespace {

constexpr int kVhThreads = 128, kVhWarps = kVhThreads / 32, kVhCols = 8;
constexpr int kVhTile = 32 * kVhCols, kVhUnroll = 4, kVhMaxRows = 8;

// 8 adjacent table elements of one row: 16 bytes of bf16 bits or 8 int8 values.
template <bool INT8>
struct Pack {
  uint32_t w[INT8 ? 2 : 4];
};

template <bool INT8>
__device__ __forceinline__ float element(const Pack<INT8>& p, int j) {
  if constexpr (INT8) {
    return static_cast<float>(static_cast<int>(p.w[j / 4] << (24 - 8 * (j % 4))) >> 24);
  } else {
    return __uint_as_float(j % 2 ? (p.w[j / 2] & 0xffff0000u) : (p.w[j / 2] << 16));
  }
}

template <bool INT8, bool VEC>
__device__ __forceinline__ Pack<INT8> load_pack(const void* table, size_t row_start, int c0,
                                                int v) {
  Pack<INT8> p;
  if constexpr (VEC) {
    if constexpr (INT8) {
      const uint2 t = __ldcs(reinterpret_cast<const uint2*>(
          static_cast<const int8_t*>(table) + row_start + c0));
      p.w[0] = t.x;
      p.w[1] = t.y;
    } else {
      const uint4 t = __ldcs(reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(table) + row_start + c0));
      p.w[0] = t.x;
      p.w[1] = t.y;
      p.w[2] = t.z;
      p.w[3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < (INT8 ? 2 : 4); ++i) p.w[i] = 0u;
#pragma unroll
    for (int j = 0; j < kVhCols; ++j) {
      if (c0 + j < v) {
        if constexpr (INT8) {
          const uint32_t b = static_cast<uint8_t>(
              __ldcs(static_cast<const int8_t*>(table) + row_start + c0 + j));
          p.w[j / 4] |= b << (8 * (j % 4));
        } else {
          const uint32_t b = __ldcs(static_cast<const uint16_t*>(table) + row_start + c0 + j);
          p.w[j / 2] |= b << (16 * (j % 2));
        }
      }
    }
  }
  return p;
}

template <int ROWS, bool INT8>
__device__ __forceinline__ void fma_row(float (&acc)[ROWS][kVhCols], const Pack<INT8>& p,
                                        const float* x_s, int d, int k) {
  float w[kVhCols];
#pragma unroll
  for (int j = 0; j < kVhCols; ++j) w[j] = element<INT8>(p, j);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float xv = x_s[r * d + k];
#pragma unroll
    for (int j = 0; j < kVhCols; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
  }
}

size_t vocab_head_smem_bytes(int rows, int d) {
  return sizeof(float) * ((size_t)rows * d + (size_t)(kVhWarps - 1) * rows * kVhTile);
}

template <int ROWS, bool INT8, bool VEC>
__global__ void __launch_bounds__(kVhThreads)
vocab_head_gemv(const __nv_bfloat16* __restrict__ x, const void* __restrict__ table,
                const float* __restrict__ scale, float* __restrict__ out, int d, int v) {
  extern __shared__ float smem[];
  float* x_s = smem;               // [ROWS, d]
  float* red = x_s + ROWS * d;     // [kVhWarps - 1, ROWS, kVhTile], warps 1..3
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < ROWS * d; i += kVhThreads) x_s[i] = __bfloat162float(x[i]);
  __syncthreads();

  const int c0 = blockIdx.x * kVhTile + lane * kVhCols;
  const int chunk = (d + kVhWarps - 1) / kVhWarps;
  const int d_begin = min(d, warp * chunk), d_end = min(d, d_begin + chunk);
  float acc[ROWS][kVhCols];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < kVhCols; ++j) acc[r][j] = 0.f;

  if (c0 < v) {
    int k = d_begin;
    for (; k + kVhUnroll <= d_end; k += kVhUnroll) {
      Pack<INT8> p[kVhUnroll];
#pragma unroll
      for (int u = 0; u < kVhUnroll; ++u)
        p[u] = load_pack<INT8, VEC>(table, (size_t)(k + u) * v, c0, v);
#pragma unroll
      for (int u = 0; u < kVhUnroll; ++u) fma_row<ROWS, INT8>(acc, p[u], x_s, d, k + u);
    }
    for (; k < d_end; ++k)
      fma_row<ROWS, INT8>(acc, load_pack<INT8, VEC>(table, (size_t)k * v, c0, v), x_s, d, k);
  }

  if (warp > 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < kVhCols; ++j)
        red[((warp - 1) * ROWS + r) * kVhTile + lane * kVhCols + j] = acc[r][j];
  }
  __syncthreads();
  if (warp != 0 || c0 >= v) return;

  float s[kVhCols];
  if constexpr (INT8) {
#pragma unroll
    for (int j = 0; j < kVhCols; ++j) s[j] = (VEC || c0 + j < v) ? scale[c0 + j] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float o[kVhCols];
#pragma unroll
    for (int j = 0; j < kVhCols; ++j) {
      float sum = acc[r][j];
#pragma unroll
      for (int w = 0; w < kVhWarps - 1; ++w)
        sum += red[(w * ROWS + r) * kVhTile + lane * kVhCols + j];
      if constexpr (INT8) sum *= s[j];
      o[j] = sum;
    }
    float* dst = out + (size_t)r * v + c0;
    if constexpr (VEC) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int j = 0; j < kVhCols; ++j)
        if (c0 + j < v) dst[j] = o[j];
    }
  }
}

template <int ROWS, bool INT8, bool VEC>
cudaError_t launch_gemv(const void* x, const void* table, const float* scale, void* out, int d,
                        int v, cudaStream_t stream) {
  const size_t smem = vocab_head_smem_bytes(ROWS, d);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vocab_head_gemv<ROWS, INT8, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (v + kVhTile - 1) / kVhTile;
  vocab_head_gemv<ROWS, INT8, VEC><<<blocks, kVhThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), table, scale, static_cast<float*>(out), d, v);
  return cudaGetLastError();
}

template <bool INT8, bool VEC>
cudaError_t run_rows(int rows, const void* x, const void* table, const float* scale, void* out,
                     int d, int v, cudaStream_t s) {
  switch (rows) {
    case 1: return launch_gemv<1, INT8, VEC>(x, table, scale, out, d, v, s);
    case 2: return launch_gemv<2, INT8, VEC>(x, table, scale, out, d, v, s);
    case 3: return launch_gemv<3, INT8, VEC>(x, table, scale, out, d, v, s);
    case 4: return launch_gemv<4, INT8, VEC>(x, table, scale, out, d, v, s);
    case 5: return launch_gemv<5, INT8, VEC>(x, table, scale, out, d, v, s);
    case 6: return launch_gemv<6, INT8, VEC>(x, table, scale, out, d, v, s);
    case 7: return launch_gemv<7, INT8, VEC>(x, table, scale, out, d, v, s);
    case 8: return launch_gemv<8, INT8, VEC>(x, table, scale, out, d, v, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool INT8>
cudaError_t run_vocab_head(const void* x, const void* table, const float* scale, void* out,
                           int rows, int d, int v, cudaStream_t s) {
  // 16-byte (bf16) / 8-byte (int8) loads need every row start aligned: V a
  // multiple of 8 and an aligned base; the fp32 output then takes float4 stores.
  const uintptr_t align = INT8 ? 8 : 16;
  const bool vec = v % kVhCols == 0 && reinterpret_cast<uintptr_t>(table) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? run_rows<INT8, true>(rows, x, table, scale, out, d, v, s)
             : run_rows<INT8, false>(rows, x, table, scale, out, d, v, s);
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t. x [rows, d] bf16, table [d, v] (table_dtype kBFloat16 or
// kInt8), scale [v] fp32 for an int8 table (ignored for bf16), out [rows, v] fp32.
extern "C" int cct_vocab_head(int table_dtype, const void* x, const void* table,
                              const void* scale, void* out, int rows, int d, int v,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > cct::kVhMaxRows || d <= 0 || v <= 0) return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  switch (table_dtype) {
    case cct::kBFloat16:
      return cct::run_vocab_head<false>(x, table, nullptr, out, rows, d, v, s);
    case cct::kInt8:
      if (sc == nullptr) return cudaErrorInvalidValue;
      return cct::run_vocab_head<true>(x, table, sc, out, rows, d, v, s);
    default:
      return cudaErrorInvalidValue;
  }
}
