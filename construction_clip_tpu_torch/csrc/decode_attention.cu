// K2: decode-step attention over the stacked KV cache, with beam ancestry.
//
// Replaces construction_clip_tpu/ops/pallas_decode_attention.py:_kernel (the
// pl.pallas_call in decode_step_attention) AND the t==1 branch of
// construction_clip_tpu/models/gpt2.py:_attn_over_cache, which the JAX beam
// loop actually runs because the Pallas kernel cannot follow beam ancestry.
//
// For query row r and head h, with q [R, H, Dh], the caches [L, R, H, T_max, Dh]
// and a layer index: key/value position t (t < n_valid) is read from cache row
// ancestry[r, t] (clamped to the cache; row r itself without ancestry). Logits
// are (q * dh^-0.5) . k in fp32, softmax in fp32, out = sum_t p_t v_t in fp32,
// rounded once to q's type.
//
// What bounds it on the H100: bytes, and before them latency. Per layer and
// step it reads the valid part of one K and one V window (R H n_valid Dh
// elements each) and does 4 operations an element, far below the ridge, but at
// R = 3..24 the window is 0.1-10 MB: a few round trips to memory cost more
// than its bytes. The design therefore minimises round trips in flight:
//   - one pass over the positions with an online softmax in fp32: each lane
//     group carries (m, l, o) and rescales them, and K and V rows of a
//     position are loaded in the same sweep;
//   - 16-byte loads: L lanes span one row (8 lanes for a 64-wide bf16 row, 16
//     in fp32), so a warp covers 32 / L positions a load, and each group keeps
//     kUnroll positions' K and V rows in flight before it computes on them;
//     the ancestry of the next sweep is fetched while the current one loads;
//   - positions split into `chunks` blocks per (row, head) where R H blocks
//     would leave SMs idle (ops/decode_attention.chunk_count picks the count,
//     at most 8): the chunks of a (row, head) form a thread-block cluster,
//     each writes its partial (m, l, o) to its shared memory, and the
//     cluster's first block reads the others' through distributed shared
//     memory and merges them in chunk order: one launch and no scratch in
//     device memory, where merging partials from scratch would take a second
//     launch, a kernel boundary as long as the split saves. Groups merge in a
//     fixed tree order, warps and chunks in order: no float atomics, so two
//     runs give the same bits.
// No gathered copy of the window is materialised, which is what the lazy beam
// ancestry exists to avoid.
#include <algorithm>
#include <cfloat>
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cct {
namespace {

namespace cg = cooperative_groups;

constexpr int kDecThreads = 128, kDecWarps = kDecThreads / 32, kUnroll = 4;
constexpr int kMaxChunks = 8;  // a portable cluster

// VEC = 16 / sizeof(T) elements of T loaded as one 16-byte word.
template <typename T, int VEC>
struct Vec {
  static_assert(sizeof(T) * VEC == 16, "one 16-byte load");
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void clear() { raw = uint4{}; }
  __device__ __forceinline__ float at(int j) const {
    return to_f(reinterpret_cast<const T*>(&raw)[j]);
  }
};

// Merges the partial (m2, l2, o2) into (m, l, o): both rescaled to the larger m.
template <int VEC>
__device__ __forceinline__ void merge(float& m, float& l, float (&o)[VEC], float m2, float l2,
                                      const float (&o2)[VEC]) {
  const float mn = fmaxf(m, m2), a = expf(m - mn), b = expf(m2 - mn);
  l = l * a + l2 * b;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = o[j] * a + o2[j] * b;
  m = mn;
}

// grid (chunks, R * H), kDecThreads threads, clusters of (chunks, 1, 1) when
// chunks > 1. A lane group of `lanes` lanes (a power of two) serves one
// position at a time; its lane li holds elements li * VEC .. li * VEC + VEC - 1
// of the row (none when that is past dh).
template <typename T, int VEC>
__global__ void __launch_bounds__(kDecThreads)
decode_step(const T* __restrict__ q, const T* __restrict__ ck, const T* __restrict__ cv,
            const int* __restrict__ ancestry, T* __restrict__ out, int rows, int n_heads,
            int t_max, int dh, int layer, int n_valid, int lanes, float scale) {
  // per warp: m, l, o[dh]; then row 0 holds the block's (the chunk's) partial
  __shared__ float red[kDecWarps][2 + 32 * VEC];

  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int rh = blockIdx.y, r = rh / n_heads, h = rh % n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = 32 / lanes, li = lane % lanes;
  const int group = warp * groups + lane / lanes, n_groups = kDecWarps * groups;
  const int c0 = li * VEC;
  const bool active = c0 < dh;
  const int len = (n_valid + chunks - 1) / chunks;
  const int t0 = chunk * len, t1 = min(n_valid, t0 + len);
  const size_t head_stride = (size_t)t_max * dh;
  const T* k_base =
      ck + ((size_t)layer * rows * n_heads + h) * head_stride + c0;  // + source row, position
  const T* v_base = cv + (k_base - ck);
  const int* anc = ancestry ? ancestry + (size_t)r * t_max : nullptr;

  float qv[VEC], o[VEC];
  {
    Vec<T, VEC> qr;
    qr.clear();
    if (active) qr.load(q + (size_t)rh * dh + c0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      qv[j] = qr.at(j) * scale;
      o[j] = 0.f;
    }
  }
  float m = -FLT_MAX, l = 0.f;

  // the source row of each of this group's positions in the sweep from `base`
  auto sources = [&](int base, int (&src)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * n_groups + group;
      src[u] = r;
      if (anc && t < t1) src[u] = min(max(anc[t], 0), rows - 1);  // stay inside the cache
    }
  };
  int src[kUnroll];
  sources(t0, src);
  for (int base = t0; base < t1; base += kUnroll * n_groups) {
    Vec<T, VEC> kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * n_groups + group;
      kr[u].clear();
      vr[u].clear();
      if (active && t < t1) {
        const size_t at = (size_t)src[u] * n_heads * head_stride + (size_t)t * dh;
        kr[u].load(k_base + at);
        vr[u].load(v_base + at);
      }
    }
    sources(base + kUnroll * n_groups, src);  // in flight beside the rows

    float s[kUnroll], mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) d = fmaf(qv[j], kr[u].at(j), d);
      for (int off = lanes >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      s[u] = base + u * n_groups + group < t1 ? d : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(s[u] - mx);
      l += p;
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = fmaf(p, vr[u].at(j), o[j]);
    }
    m = mx;
  }

  // the warp's groups, in a fixed tree order (partners get the same bits)
  for (int off = lanes; off < 32; off <<= 1) {
    float o2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) o2[j] = __shfl_xor_sync(0xffffffffu, o[j], off);
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge<VEC>(m, l, o, m2, l2, o2);
  }
  if (lane < lanes) {
    if (lane == 0) {
      red[warp][0] = m;
      red[warp][1] = l;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[warp][2 + c0 + j] = o[j];
  }
  __syncthreads();
  const bool lead = warp == 0 && lane < lanes;  // holds the merged (m, l, o)
  if (lead) {
    for (int w = 1; w < kDecWarps; ++w) {  // the block's warps, in warp order
      float o2[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o2[j] = red[w][2 + c0 + j];
      merge<VEC>(m, l, o, red[w][0], red[w][1], o2);
    }
  }
  if (chunks > 1) {
    // the chunks of this (row, head): block 0 of the cluster merges the
    // others' partials from their shared memory, in chunk order
    cg::cluster_group cluster = cg::this_cluster();
    if (lead) {
      if (lane == 0) {
        red[0][0] = m;
        red[0][1] = l;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[0][2 + c0 + j] = o[j];
    }
    cluster.sync();  // every chunk's partial is in place
    if (lead && cluster.block_rank() == 0) {
      for (int k = 1; k < chunks; ++k) {
        const float* pk = cluster.map_shared_rank(&red[0][0], k);
        float o2[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) o2[j] = pk[2 + c0 + j];
        merge<VEC>(m, l, o, pk[0], pk[1], o2);
      }
    }
    cluster.sync();  // the partials stay until block 0 has read them
    if (cluster.block_rank() != 0) return;
  }
  if (!lead || !active) return;  // an active lane's VEC elements all lie below dh
  const float inv = 1.f / l;
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[(size_t)rh * dh + c0 + j] = from_f<T>(o[j] * inv);
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

template <typename T, int VEC>
cudaError_t launch_decode(const T* q, const T* ck, const T* cv, const int* ancestry, T* out,
                          int rows, int n_heads, int t_max, int dh, int layer, int n_valid,
                          int chunks, float scale, cudaStream_t stream) {
  const int lanes = next_pow2((dh + VEC - 1) / VEC);
  if (lanes > 32) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, rows * n_heads);
  cfg.blockDim = dim3(kDecThreads);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = chunks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = chunks > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, decode_step<T, VEC>, q, ck, cv, ancestry, out, rows, n_heads,
                            t_max, dh, layer, n_valid, lanes, scale);
}

template <typename T>
cudaError_t run_decode(const void* q, const void* ck, const void* cv, const int* ancestry,
                       void* out, int rows, int n_heads, int t_max, int dh, int layer,
                       int cache_len, int chunks, float scale, cudaStream_t stream) {
  const int n_valid = std::min(cache_len + 1, t_max);
  if (rows <= 0 || n_heads <= 0 || dh <= 0 || t_max <= 0 || cache_len < 0 || layer < 0 ||
      chunks < 1 || chunks > std::min(n_valid, kMaxChunks))
    return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);  // one 16-byte load a lane: rows of whole words
  for (const void* p : {q, ck, cv})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  if (dh % kVec) return cudaErrorInvalidValue;
  return launch_decode<T, kVec>(static_cast<const T*>(q), static_cast<const T*>(ck),
                                static_cast<const T*>(cv), ancestry, static_cast<T*>(out), rows,
                                n_heads, t_max, dh, layer, n_valid, chunks, scale, stream);
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t. ancestry may be null ([R, T_max] int32 otherwise);
// chunks: 1 .. min(8, n_valid) blocks a (row, head). q and the caches start
// on 16-byte boundaries and Dh is a multiple of 16 bytes.
extern "C" int cct_decode_attention(int dtype, const void* q, const void* ck, const void* cv,
                                    const void* ancestry, void* out, int rows, int n_heads,
                                    int t_max, int dh, int layer, int cache_len, int chunks,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* anc = static_cast<const int*>(ancestry);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_decode<float>(q, ck, cv, anc, out, rows, n_heads, t_max, dh, layer,
                                    cache_len, chunks, scale, s);
    case cct::kBFloat16:
      return cct::run_decode<__nv_bfloat16>(q, ck, cv, anc, out, rows, n_heads, t_max, dh,
                                            layer, cache_len, chunks, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
