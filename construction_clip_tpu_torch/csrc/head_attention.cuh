// Per-(batch, head) attention of the fused blocks' middle launch (K1, K7).
//
// merged[b, i, h*dh:(h+1)*dh] = softmax-weighted V for query i of head h, from
// the packed qkv [B*T, 3D] rows (q | k | v). Rounding points follow the Pallas
// blocks' per_head_attention: logits in fp32 times dh^-0.5, causal keys masked;
// the unnormalised p = exp(logit - max) is rounded to T for p . v (fp32 sum)
// and the result divided by the fp32 row sum of p, then written as O (T for
// K1; fp32 for K7, whose out-projection quantizes the merged rows in fp32).
//
// One block per (batch, head) with that head's K and V (T <= 256) staged in
// dynamic shared memory, one warp per query row. K rows are padded to dh+1
// floats so that lanes reading 32 keys hit 32 banks.
#pragma once

#include <cfloat>

#include "common.cuh"

namespace cct {

constexpr int kAttnThreads = 128, kAttnWarps = kAttnThreads / 32;

inline size_t attn_smem_bytes(int t_len, int dh) {
  return sizeof(float) * ((size_t)t_len * (dh + 1) + (size_t)t_len * dh +
                          (size_t)kAttnWarps * (t_len + dh));
}

template <typename T, typename O>
__global__ void __launch_bounds__(kAttnThreads)
head_attention(const T* __restrict__ qkv, O* __restrict__ merged, int t_len, int d,
               int n_heads, int causal, float scale) {
  extern __shared__ float smem[];
  const int dh = d / n_heads, ks = dh + 1;
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* k_s = smem;
  float* v_s = k_s + (size_t)t_len * ks;
  float* p_s = v_s + (size_t)t_len * dh + (size_t)warp * t_len;
  float* q_s = v_s + (size_t)t_len * dh + (size_t)kAttnWarps * t_len + (size_t)warp * dh;
  const T* base = qkv + (size_t)b * t_len * 3 * d;

  for (int i = threadIdx.x; i < t_len * dh; i += kAttnThreads) {
    const int t = i / dh, c = i % dh;
    const T* row = base + (size_t)t * 3 * d + h * dh + c;
    k_s[t * ks + c] = to_f(row[d]);
    v_s[t * dh + c] = to_f(row[2 * d]);
  }
  __syncthreads();

  for (int i = warp; i < t_len; i += kAttnWarps) {
    const T* q_row = base + (size_t)i * 3 * d + h * dh;
    for (int c = lane; c < dh; c += 32) q_s[c] = to_f(q_row[c]);
    __syncwarp();
    const int n_keys = causal ? i + 1 : t_len;  // masked keys carry p == 0
    float m = -FLT_MAX;
    for (int j = lane; j < n_keys; j += 32) {
      float s = 0.f;
      for (int c = 0; c < dh; ++c) s = fmaf(q_s[c], k_s[j * ks + c], s);
      s *= scale;
      p_s[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n_keys; j += 32) {
      const float p = expf(p_s[j] - m);
      l += p;
      p_s[j] = round_to<T>(p);
    }
    l = warp_sum(l);
    __syncwarp();
    for (int c = lane; c < dh; c += 32) {
      float o = 0.f;
      for (int j = 0; j < n_keys; ++j) o = fmaf(p_s[j], v_s[j * dh + c], o);
      merged[((size_t)b * t_len + i) * d + h * dh + c] = from_f<O>(o / l);
    }
    __syncwarp();
  }
}

}  // namespace cct
