// Token-embedding backward: dW[v] = sum of grad[i] over the rows i with ids[i] == v,
// the gradient of the lookup table[ids] (models/clip/model.py:encode_text, through
// ops/embedding.py).
//
// Replaces no TPU kernel: the JAX package's lookup is an XLA gather, whose
// scatter-add backward XLA writes. On the card the lookup's backward was
// PyTorch's index_put_(accumulate=True). That kernel sorts the ids and gives each
// run of equal ids to one warp per 128-column slice, which adds the run's rows
// one after another, reading and rounding the output row in the output's type at
// every add. Text zero-padded after EOT puts ~26,000 of a ViT-B/32 training
// step's 38,808 rows on id 0, and that one chain took 26.3 ms on an H100, where
// all-distinct ids took 0.05 ms.
//
// Bound: bytes. grad [N, D] is read once and dW [V, D] written once; the adds
// are N x D in fp32 and cost nothing beside them. The design keeps every chain
// of dependent work short, whatever the longest run of equal ids:
//
//  1. Keys (embedding_keys): the key of an id is the row the forward's gather
//     reads, id for one in [0, V) and id + V for one in [-V, 0), as table[ids]
//     wraps it; any other id (the gather raises on it) becomes V, is never
//     written and only keeps memory safe. The wrapper (ops/embedding.py) sorts
//     the int32 keys stably with torch.sort and hands over the sorted keys and
//     the rows they came from: each id's rows keep their row order.
//  2. Bounds: the first and one-past-last sorted position of every present id.
//  3. Zeros: every row of an id that no row holds.
//  4. Pieces. The sorted rows are cut into pieces of kPiece (64) positions,
//     whatever the ids. A warp takes a piece and a 256-column slice (8 columns a
//     lane: one 16-byte load a row in bf16 or fp16, two in fp32), walks the
//     piece's rows in order with kInFlight (8) rows' loads in flight, and sums
//     each run of equal ids in fp32 registers. A run that lies wholly in the
//     piece is rounded once and written to dW. The piece's first run, if it
//     began in an earlier piece, goes to the piece's fp32 partial slot 0; its
//     last run, if it begins in the piece and goes on, to slot 1.
//  5. Finish. The piece that holds a cut run's last row sums the run's partials
//     (slot 1 of its first piece, then slot 0 of each later one), a block for
//     each 128 columns: 8 warps each take a fixed contiguous share of them in
//     piece order, the 8 shares are added in warp order, and the sum is rounded
//     once and written.
//
// Every row of dW is written exactly once. The order of each sum follows from
// the ids alone (no atomics; the sort is stable), so two runs give
// bit-identical output. A run of L rows takes ceil(L / 64) + 1 partials at
// most, shared by 8 warps: the longest chain is 64 rows plus 1/8 of N/64
// partials.
#include <cuda_fp16.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cct {
namespace {

constexpr int kPiece = 64;            // sorted positions a piece holds
constexpr int kInFlight = 8;          // rows whose loads a lane keeps in flight
constexpr int kSlice = 256;           // columns a piece warp takes (8 a lane)
constexpr int kPieceWarps = 4;
constexpr int kFinishWarps = 8;
constexpr int kFillThreads = 256;
constexpr uint32_t kNoKey = UINT_MAX;

// The key of each id (int or long long): the row table[ids] reads, V where
// the gather has none.
template <typename Id>
__global__ void embedding_keys(const Id* __restrict__ ids, long long n, int v,
                               int* __restrict__ keys) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x) {
    const Id id = ids[j];
    keys[j] = id >= 0 && id < v ? (int)id : id < 0 && id >= -(Id)v ? (int)(id + v) : v;
  }
}

// start[k] and end[k]: the first and one-past-last sorted position of id k
// (start stays -1 for an id no row holds).
__global__ void run_bounds(const uint32_t* __restrict__ keys, long long n, int v,
                           int* __restrict__ start, int* __restrict__ end) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x) {
    const uint32_t k = keys[j];
    if (k >= (uint32_t)v) continue;
    if (j == 0 || keys[j - 1] != k) start[k] = (int)j;
    if (j == n - 1 || keys[j + 1] != k) end[k] = (int)(j + 1);
  }
}

// Zeros in every row whose id no row holds, 16 bytes a thread.
__global__ void __launch_bounds__(kFillThreads)
zero_rows(const int* __restrict__ start, uint4* __restrict__ dw, int v, int chunks_a_row) {
  const long long total = (long long)v * chunks_a_row;
  for (long long i = blockIdx.x * (long long)kFillThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kFillThreads) {
    if (start[i / chunks_a_row] < 0) dw[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Eight consecutive elements of a row: loaded raw (kWords 16-byte words), then
// widened to fp32, and stored after one rounding.
template <typename T>
struct Row8;
template <>
struct Row8<float> {
  static constexpr int kWords = 2;
  __device__ static void widen(const uint4 (&q)[2], float (&f)[8]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      f[4 * i + 0] = __uint_as_float(q[i].x);
      f[4 * i + 1] = __uint_as_float(q[i].y);
      f[4 * i + 2] = __uint_as_float(q[i].z);
      f[4 * i + 3] = __uint_as_float(q[i].w);
    }
  }
  __device__ static void store(float* p, const float (&f)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};
__device__ __forceinline__ float2 unpack2(uint32_t w, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 unpack2(uint32_t w, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <typename T>
struct Row8 {   // bf16 and fp16
  static constexpr int kWords = 1;
  __device__ static void widen(const uint4 (&q)[1], float (&f)[8]) {
    const uint32_t w[4] = {q[0].x, q[0].y, q[0].z, q[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = unpack2(w[i], T());
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static void store(T* p, const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(f[0], f[1], T()), pack2(f[2], f[3], T()),
                                              pack2(f[4], f[5], T()), pack2(f[6], f[7], T()));
  }
};

// Four consecutive elements, rounded once, for the finish pass.
__device__ __forceinline__ void store4(float* p, float4 f) { *reinterpret_cast<float4*>(p) = f; }
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 f) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(f.x, f.y, T()), pack2(f.z, f.w, T()));
}

// One warp a (piece, 256-column slice). Lanes whose columns lie past D still
// take part in the shuffles.
template <typename T>
__global__ void __launch_bounds__(32 * kPieceWarps)
piece_sums(const T* __restrict__ grad, const uint32_t* __restrict__ keys,
           const long long* __restrict__ rows, long long n, int d, int v, int slices,
           long long pieces, T* __restrict__ dw, float* __restrict__ part) {
  constexpr int W = Row8<T>::kWords;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kPieceWarps + (threadIdx.x >> 5);
  if (item >= pieces * slices) return;
  const long long piece = item / slices;
  const int col = (int)(item % slices) * kSlice + lane * 8;
  const bool active = col < d;
  const long long b0 = piece * kPiece;
  const int count = (int)min((long long)kPiece, n - b0);
  // the piece's keys and rows, positions lane and 32 + lane
  const uint32_t key_lo = lane < count ? keys[b0 + lane] : kNoKey;
  const uint32_t key_hi = 32 + lane < count ? keys[b0 + 32 + lane] : kNoKey;
  const long long row_lo = lane < count ? rows[b0 + lane] : 0;
  const long long row_hi = 32 + lane < count ? rows[b0 + 32 + lane] : 0;
  auto key_at = [&](int j) { return __shfl_sync(0xffffffffu, j < 32 ? key_lo : key_hi, j & 31); };
  auto row_at = [&](int j) { return __shfl_sync(0xffffffffu, j < 32 ? row_lo : row_hi, j & 31); };
  const uint32_t first = key_at(0), last = key_at(count - 1);
  const bool began_before = b0 > 0 && keys[b0 - 1] == first;
  const bool goes_on = b0 + count < n && keys[b0 + count] == last;

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  uint32_t cur = first;
  bool cur_before = began_before;
  // A finished run: rounded into dW if it lies wholly in the piece, else its
  // fp32 partial into the piece's slot.
  auto flush = [&](bool cut_after) {
    if (!active || cur >= (uint32_t)v) return;
    if (!cur_before && !cut_after) {
      Row8<T>::store(dw + (long long)cur * d + col, acc);
    } else {
      Row8<float>::store(part + (piece * 2 + (cur_before ? 0 : 1)) * d + col, acc);
    }
  };
  for (int j0 = 0; j0 < count; j0 += kInFlight) {
    uint4 q[kInFlight][W];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u;
      if (j < count) {
        const long long r = row_at(j);
        if (active) {
          const uint4* src = reinterpret_cast<const uint4*>(grad + r * d + col);
#pragma unroll
          for (int i = 0; i < W; ++i) q[u][i] = __ldg(src + i);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u;
      if (j < count) {
        const uint32_t k = key_at(j);
        if (k != cur) {
          flush(false);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = 0.f;
          cur = k;
          cur_before = false;
        }
        if (active) {
          float f[8];
          Row8<T>::widen(q[u], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += f[e];
        }
      }
    }
  }
  flush(goes_on);
}

// One block a (piece, 128-column slice); only the piece that holds the last
// row of a run cut by a piece boundary works: it sums that run's partials and
// writes its row.
template <typename T>
__global__ void __launch_bounds__(32 * kFinishWarps)
finish_runs(const uint32_t* __restrict__ keys, const int* __restrict__ start,
            const int* __restrict__ end, const float* __restrict__ part, int d, int v,
            T* __restrict__ dw) {
  __shared__ float4 share[kFinishWarps][32];
  const long long piece = blockIdx.x;
  const long long b0 = piece * kPiece;
  const uint32_t k = keys[b0];
  if (b0 == 0 || k >= (uint32_t)v || keys[b0 - 1] != k) return;   // no run cut before it
  if (end[k] > b0 + kPiece) return;                                // the run goes on
  const long long p0 = start[k] / kPiece;
  const long long m = piece - p0 + 1;   // partials: slot 1 of p0, slot 0 of p0+1..piece
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long lo = m * warp / kFinishWarps, hi = m * (warp + 1) / kFinishWarps;
  const int col = blockIdx.y * 128 + lane * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < d) {
    for (long long i0 = lo; i0 < hi; i0 += kInFlight) {
      float4 q[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long i = i0 + u;
        if (i < hi) {
          const long long slot = i == 0 ? p0 * 2 + 1 : (p0 + i) * 2;
          q[u] = *reinterpret_cast<const float4*>(part + slot * d + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (i0 + u < hi) {
          acc.x += q[u].x;
          acc.y += q[u].y;
          acc.z += q[u].z;
          acc.w += q[u].w;
        }
      }
    }
  }
  share[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < d) {
    float4 s = share[0][lane];
#pragma unroll
    for (int w = 1; w < kFinishWarps; ++w) {
      const float4 o = share[w][lane];
      s.x += o.x;
      s.y += o.y;
      s.z += o.z;
      s.w += o.w;
    }
    store4(dw + (long long)k * d + col, s);
  }
}

long long pieces_of(long long n) { return (n + kPiece - 1) / kPiece; }
size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

// The workspace: start and end, the pieces' partial slots.
struct Work {
  int* start;
  int* end;
  float* part;
  size_t bytes;
};

Work carve(char* base, long long n, int d, int v) {
  Work w{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  w.start = reinterpret_cast<int*>(take(sizeof(int) * (size_t)v));
  w.end = reinterpret_cast<int*>(take(sizeof(int) * (size_t)v));
  w.part = reinterpret_cast<float*>(take(sizeof(float) * 2 * (size_t)pieces_of(n) * d));
  w.bytes = off;
  return w;
}

int blocks_for(long long work, int threads) {
  const long long b = (work + threads - 1) / threads;
  return (int)(b < 1 ? 1 : (b < 65535LL * 16 ? b : 65535LL * 16));
}

template <typename T>
cudaError_t run_embedding_bwd(const uint32_t* keys, const long long* rows, const T* grad, T* dw,
                              char* work, long long n, int d, int v, cudaStream_t stream) {
  const Work w = carve(work, n, d, v);
  cudaError_t err = cudaMemsetAsync(w.start, 0xff, sizeof(int) * (size_t)v, stream);
  if (err != cudaSuccess) return err;
  if (n > 0) run_bounds<<<blocks_for(n, 256), 256, 0, stream>>>(keys, n, v, w.start, w.end);
  const int chunks_a_row = (int)(d * sizeof(T) / 16);
  zero_rows<<<blocks_for((long long)v * chunks_a_row, kFillThreads), kFillThreads, 0, stream>>>(
      w.start, reinterpret_cast<uint4*>(dw), v, chunks_a_row);
  if (n > 0) {
    const long long pieces = pieces_of(n);
    const int slices = (d + kSlice - 1) / kSlice;
    const long long blocks = (pieces * slices + kPieceWarps - 1) / kPieceWarps;
    piece_sums<T><<<(unsigned)blocks, 32 * kPieceWarps, 0, stream>>>(
        grad, keys, rows, n, d, v, slices, pieces, dw, w.part);
    const dim3 grid((unsigned)pieces, (unsigned)((d + 127) / 128));
    finish_runs<T><<<grid, 32 * kFinishWarps, 0, stream>>>(keys, w.start, w.end, w.part, d, v,
                                                           dw);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace cct

// Writes keys [n] int32: the row table[ids] reads for each id of ids [n]
// (int32, id_type 0, or int64, 1), v for an id the gather has no row for.
// Returns a cudaError_t.
extern "C" int cct_embedding_keys(int id_type, const void* ids, void* keys, long long n, int v,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > INT_MAX || v <= 0 || v == INT_MAX) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int* k = static_cast<int*>(keys);
  switch (id_type) {
    case 0:
      cct::embedding_keys<<<cct::blocks_for(n, 256), 256, 0, s>>>(static_cast<const int*>(ids),
                                                                    n, v, k);
      break;
    case 1:
      cct::embedding_keys<<<cct::blocks_for(n, 256), 256, 0, s>>>(
          static_cast<const long long*>(ids), n, v, k);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Bytes of workspace cct_embedding_bwd needs for n ids, width d and v rows.
extern "C" long long cct_embedding_bwd_work_bytes(long long n, int d, int v) {
  return (long long)cct::carve(nullptr, n, d, v).bytes;
}

// Returns a cudaError_t; nonzero means a launch was refused or an argument is
// out of range. keys [n] int32, cct_embedding_keys' keys sorted stably, and
// rows [n] int64, the position each came from; grad [n, d] and dw [v, d] of
// dtype (csrc/common.cuh: DType: fp32, bf16 or fp16), contiguous and 16-byte
// aligned, d a multiple of 8; work of cct_embedding_bwd_work_bytes bytes,
// 256-byte aligned. n < 2^31 and v < 2^31 - 1.
extern "C" int cct_embedding_bwd(int dtype, const void* keys, const void* rows, const void* grad,
                                 void* dw, void* work, long long n, int d, int v, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > INT_MAX || d <= 0 || d % 8 != 0 || v <= 0 || v == INT_MAX) {
    return cudaErrorInvalidValue;
  }
  if (!cct::aligned16(grad) || !cct::aligned16(dw) ||
      (reinterpret_cast<uintptr_t>(work) & 255) != 0) {
    return cudaErrorInvalidValue;
  }
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const long long* r = static_cast<const long long*>(rows);
  char* w = static_cast<char*>(work);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_embedding_bwd(k, r, static_cast<const float*>(grad),
                                    static_cast<float*>(dw), w, n, d, v, s);
    case cct::kBFloat16:
      return cct::run_embedding_bwd(k, r, static_cast<const __nv_bfloat16*>(grad),
                                    static_cast<__nv_bfloat16*>(dw), w, n, d, v, s);
    case cct::kFloat16:
      return cct::run_embedding_bwd(k, r, static_cast<const __half*>(grad),
                                    static_cast<__half*>(dw), w, n, d, v, s);
    default:
      return cudaErrorInvalidValue;
  }
}
