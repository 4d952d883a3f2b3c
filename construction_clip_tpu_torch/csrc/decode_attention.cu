// K2: decode-step attention over the stacked KV cache, with beam ancestry.
//
// Replaces construction_clip_tpu/ops/pallas_decode_attention.py:_kernel (the
// pl.pallas_call in decode_step_attention) AND the t==1 branch of
// construction_clip_tpu/models/gpt2.py:_attn_over_cache, which the JAX beam
// loop actually runs because the Pallas kernel cannot follow beam ancestry.
//
// For query row r and head h, with q [R, H, Dh], the caches [L, R, H, T_max, Dh]
// and a layer index: key/value position t (t <= cache_len) is read from cache row
// ancestry[r, t] (row r itself without ancestry). Logits are (q * dh^-0.5) . k in
// fp32, softmax in fp32, out = sum_t p_t v_t in fp32, rounded once to q's type.
//
// What bounds it on the H100: bytes. Per layer and step it reads the valid part
// of one K and one V window (R*H*(cache_len+1)*Dh elements each) and does
// 4 FLOPs per element read, far below the ridge. The design reads each K/V row
// exactly once, straight out of the stacked cache (no layer slice and no
// gathered copy of the window is ever materialised, which is what the lazy beam
// ancestry exists to avoid), with a warp's 32 lanes on consecutive Dh elements
// so every row read is one coalesced transaction.
//
// Layout: one block per (r, h); four warps stride over positions. Pass 1 computes
// logits (lane-parallel dot, warp reduce), pass 2 the block max and sum, pass 3
// the p . v sums per warp, reduced across warps in shared memory.
#include <algorithm>
#include <cfloat>

#include "common.cuh"

namespace cct {
namespace {

constexpr int kDecThreads = 128, kDecWarps = kDecThreads / 32, kMaxDhChunks = 4;

size_t decode_smem_bytes(int t_max, int dh) {
  return sizeof(float) * ((size_t)dh + t_max + (size_t)kDecWarps * dh) + sizeof(int) * t_max;
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_step(const T* __restrict__ q, const T* __restrict__ ck, const T* __restrict__ cv,
            const int* __restrict__ ancestry, T* __restrict__ out, int rows, int n_heads,
            int t_max, int dh, int layer, int n_valid, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [dh], pre-scaled
  float* p_s = q_s + dh;             // [t_max], logits then probabilities
  float* red = p_s + t_max;          // [kDecWarps, dh], per-warp p . v partials
  int* src_s = reinterpret_cast<int*>(red + kDecWarps * dh);  // [t_max] source rows
  __shared__ float wred[kDecWarps];

  const int r = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head_stride = (size_t)t_max * dh;
  const size_t layer_base = (size_t)layer * rows * n_heads * head_stride;

  for (int c = tid; c < dh; c += kDecThreads)
    q_s[c] = to_f(q[((size_t)r * n_heads + h) * dh + c]) * scale;
  for (int t = tid; t < n_valid; t += kDecThreads) {
    int src = ancestry ? ancestry[(size_t)r * t_max + t] : r;
    src_s[t] = min(max(src, 0), rows - 1);  // stay inside the cache whatever the map holds
  }
  __syncthreads();

  float m = -FLT_MAX;
  for (int t = warp; t < n_valid; t += kDecWarps) {
    const T* k_row = ck + layer_base + ((size_t)src_s[t] * n_heads + h) * head_stride +
                     (size_t)t * dh;
    float s = 0.f;
    for (int c = lane; c < dh; c += 32) s = fmaf(q_s[c], to_f(k_row[c]), s);
    s = warp_sum(s);
    if (lane == 0) p_s[t] = s;
    m = fmaxf(m, s);
  }
  if (lane == 0) wred[warp] = m;
  __syncthreads();
  m = wred[0];
#pragma unroll
  for (int w = 1; w < kDecWarps; ++w) m = fmaxf(m, wred[w]);
  __syncthreads();  // every thread has read wred before it is reused

  float l = 0.f;
  for (int t = tid; t < n_valid; t += kDecThreads) {
    const float p = expf(p_s[t] - m);
    p_s[t] = p;
    l += p;
  }
  l = warp_sum(l);
  if (lane == 0) wred[warp] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) l += wred[w];

  float o[kMaxDhChunks];
#pragma unroll
  for (int k = 0; k < kMaxDhChunks; ++k) o[k] = 0.f;
  for (int t = warp; t < n_valid; t += kDecWarps) {
    const T* v_row = cv + layer_base + ((size_t)src_s[t] * n_heads + h) * head_stride +
                     (size_t)t * dh;
    const float p = p_s[t] / l;  // the fp32 softmax probability, as the reference
#pragma unroll
    for (int k = 0; k < kMaxDhChunks; ++k) {
      const int c = lane + 32 * k;
      if (c < dh) o[k] = fmaf(p, to_f(v_row[c]), o[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxDhChunks; ++k) {
    const int c = lane + 32 * k;
    if (c < dh) red[warp * dh + c] = o[k];
  }
  __syncthreads();
  for (int c = tid; c < dh; c += kDecThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) s += red[w * dh + c];
    out[((size_t)r * n_heads + h) * dh + c] = from_f<T>(s);
  }
}

template <typename T>
cudaError_t run_decode(const void* q, const void* ck, const void* cv, const int* ancestry,
                       void* out, int rows, int n_heads, int t_max, int dh, int layer,
                       int cache_len, float scale, cudaStream_t stream) {
  if (rows <= 0 || n_heads <= 0 || dh <= 0 || dh > 32 * kMaxDhChunks || cache_len < 0)
    return cudaErrorInvalidValue;
  const int n_valid = std::min(cache_len + 1, t_max);
  const size_t smem = decode_smem_bytes(t_max, dh);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_step<T><<<dim3(rows, n_heads), kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      ancestry, static_cast<T*>(out), rows, n_heads, t_max, dh, layer, n_valid, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t. ancestry may be null ([R, T_max] int32 otherwise).
extern "C" int cct_decode_attention(int dtype, const void* q, const void* ck, const void* cv,
                                    const void* ancestry, void* out, int rows, int n_heads,
                                    int t_max, int dh, int layer, int cache_len, float scale,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* anc = static_cast<const int*>(ancestry);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_decode<float>(q, ck, cv, anc, out, rows, n_heads, t_max, dh, layer,
                                    cache_len, scale, s);
    case cct::kBFloat16:
      return cct::run_decode<__nv_bfloat16>(q, ck, cv, anc, out, rows, n_heads, t_max, dh,
                                            layer, cache_len, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
