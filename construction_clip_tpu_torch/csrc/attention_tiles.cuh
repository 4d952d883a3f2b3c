// Attention over key and query tiles streamed through shared memory: the
// forward with an online softmax (K4) and the three passes of the attention
// backward (K3's per-head part, K5).
//
// One block serves one (batch, head) and kBlockRows rows; each warp owns
// kTileRows of them and keeps their state in registers, so no [T, T] panel is
// ever written to device memory, and shared memory holds one 64-row tile of
// two operands whatever T is (T <= 1024 is the callers' bound; dh <= 128).
//
//   attn_rows<kFwd>    o_i = T(sum_j T(p~_ij) v_j / l_i), p~ = exp(s - m_run),
//                      m and l carried across key tiles (online softmax).
//   attn_rows<kStats>  per query row: m_i, l_i and D_i = dO_i . o_i with
//                      unrounded fp32 p; D_i = sum_j p_ij dp_ij of the reference.
//   attn_rows<kDq>     p_ij = exp(s_ij - m_i) / l_i recomputed per key tile;
//                      dp = dO_i . v_j; ds = p (dp - D_i) scale; dq_i = sum ds k_j.
//                      With ROUND (K3): ds and p rounded to T, and the merged
//                      heads T(sum_j T(p_ij) v_j) written beside dq.
//   attn_cols          per key row j over query tiles: dv_j = sum_i p_ij dO_i,
//                      dk_j = sum_i ds_ij q_i (ROUND as above).
// Logits are (q . k) * scale in fp32; masked (causal) keys carry p == 0.
#pragma once

#include <cfloat>

#include "common.cuh"

namespace cct {

// Element (b, h, t, c) lives at base + b * sb + h * sh + t * st + c: one
// description for [B, T, 3D] qkv with heads at column offsets, [B, T, D]
// merged heads, and [B, H, T, dh] per-head arrays.
struct HeadView {
  long long sb, sh, st;
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // dO (kStats, kDq, cols)
  void* out;         // kFwd: o; kDq: dq; cols: dk
  void* out2;        // kDq with ROUND: merged; cols: dv
  float* m;          // per (b*H + h) * T + row statistics
  float* l;
  float* dsum;
  HeadView in, dov, ov, o2v;
  int n_heads, t_len, dh, causal;
  float scale;
};

constexpr int kTileWarps = 8, kTileThreads = 32 * kTileWarps;
constexpr int kTileRows = 4;                        // rows per warp
constexpr int kBlockRows = kTileWarps * kTileRows;  // rows per block
constexpr int kTile = 64;                           // staged keys (queries) per tile
constexpr int kMaxDh = 128, kMaxC = kMaxDh / 32;

enum RowMode : int { kFwd = 0, kStats = 1, kDq = 2 };

// Shared memory of attn_rows and attn_cols: two staged tiles (rows padded to
// dh+1 floats so that lanes reading one row each hit distinct banks), the
// warps' own rows of two operands, two per-warp scratch rows, 3 stat rows.
inline size_t tile_smem_bytes(int dh) {
  return sizeof(float) * (2 * (size_t)kTile * (dh + 1) + 2 * (size_t)kBlockRows * dh +
                          2 * (size_t)kTileWarps * kTile + 3 * kTile);
}

__device__ __forceinline__ long long head_base(const HeadView& v, int b, int h) {
  return (long long)b * v.sb + (long long)h * v.sh;
}

template <typename T, int MODE, bool ROUND>
__global__ void __launch_bounds__(kTileThreads) attn_rows(AttnArgs a) {
  extern __shared__ float smem[];
  const int dh = a.dh, ks = dh + 1, t_len = a.t_len;
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kBlockRows;
  float* k_s = smem;
  float* v_s = k_s + kTile * ks;
  float* q_s = v_s + kTile * ks + warp * kTileRows * dh;
  float* do_s = v_s + kTile * ks + kBlockRows * dh + warp * kTileRows * dh;
  float* p_s = v_s + kTile * ks + 2 * kBlockRows * dh + warp * kTile;
  float* ds_s = v_s + kTile * ks + 2 * kBlockRows * dh + kTileWarps * kTile + warp * kTile;

  const T* q = static_cast<const T*>(a.q) + head_base(a.in, b, h);
  const T* k = static_cast<const T*>(a.k) + head_base(a.in, b, h);
  const T* v = static_cast<const T*>(a.v) + head_base(a.in, b, h);
  const T* dout = static_cast<const T*>(a.dout) + head_base(a.dov, b, h);

  float m[kTileRows], l[kTileRows], dsum[kTileRows];
  float acc[kTileRows][kMaxC], acc2[kTileRows][kMaxC];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int i = row0 + warp * kTileRows + r;
    m[r] = -FLT_MAX;
    l[r] = 0.f;
    dsum[r] = 0.f;
    if (i < t_len) {
      for (int c = lane; c < dh; c += 32) {
        q_s[r * dh + c] = to_f(q[i * a.in.st + c]);
        if (MODE != kFwd) do_s[r * dh + c] = to_f(dout[i * a.dov.st + c]);
      }
      if (MODE == kDq) {
        const size_t s = (size_t)bh * t_len + i;
        m[r] = a.m[s];
        l[r] = a.l[s];
        dsum[r] = a.dsum[s];
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxC; ++u) acc[r][u] = acc2[r][u] = 0.f;
  }

  const int last_row = min(t_len, row0 + kBlockRows);
  const int n_keys = a.causal ? last_row : t_len;
  for (int j0 = 0; j0 < n_keys; j0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * dh; e += kTileThreads) {
      const int jj = e / dh, c = e % dh, j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < t_len) {
        kv = to_f(k[j * a.in.st + c]);
        vv = to_f(v[j * a.in.st + c]);
      }
      k_s[jj * ks + c] = kv;
      v_s[jj * ks + c] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int i = row0 + warp * kTileRows + r;  // warp-uniform
      if (i >= t_len) break;
      const int kmax = a.causal ? i + 1 : t_len;
      if (j0 >= kmax) continue;
      const int nt = min(kTile, kmax - j0);  // valid keys of this tile
      const float* qr = q_s + r * dh;
      const float* dor = do_s + r * dh;
      float s[2], dp[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jj = lane + 32 * u;
        s[u] = -FLT_MAX;
        dp[u] = 0.f;
        if (jj < nt) {
          float x = 0.f, y = 0.f;
          for (int c = 0; c < dh; ++c) {
            x = fmaf(qr[c], k_s[jj * ks + c], x);
            if (MODE == kDq) y = fmaf(dor[c], v_s[jj * ks + c], y);
          }
          s[u] = x * a.scale;
          dp[u] = y;
        }
      }
      if (MODE == kDq) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jj = lane + 32 * u;
          float p = 0.f, ds = 0.f;
          if (jj < nt) {
            p = expf(s[u] - m[r]) / l[r];
            ds = p * (dp[u] - dsum[r]) * a.scale;
            if (ROUND) {
              ds = round_to<T>(ds);
              p = round_to<T>(p);
            }
          }
          p_s[jj] = p;
          ds_s[jj] = ds;
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kMaxC; ++u) {
          const int c = lane + 32 * u;
          if (c < dh) {
            float x = acc[r][u], y = acc2[r][u];
            for (int jj = 0; jj < nt; ++jj) {
              x = fmaf(ds_s[jj], k_s[jj * ks + c], x);
              if (ROUND) y = fmaf(p_s[jj], v_s[jj * ks + c], y);
            }
            acc[r][u] = x;
            acc2[r][u] = y;
          }
        }
        __syncwarp();
      } else {
        const float m_new = fmaxf(m[r], warp_max(fmaxf(s[0], s[1])));
        const float corr = expf(m[r] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jj = lane + 32 * u;
          const float p = jj < nt ? expf(s[u] - m_new) : 0.f;
          psum += p;
          p_s[jj] = MODE == kFwd ? round_to<T>(p) : p;
        }
        l[r] = l[r] * corr + warp_sum(psum);
        m[r] = m_new;
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kMaxC; ++u) {
          const int c = lane + 32 * u;
          if (c < dh) {
            float x = acc[r][u] * corr;
            for (int jj = 0; jj < nt; ++jj) x = fmaf(p_s[jj], v_s[jj * ks + c], x);
            acc[r][u] = x;
          }
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int i = row0 + warp * kTileRows + r;
    if (i >= t_len) break;
    if (MODE == kStats) {
      float dd = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxC; ++u) {
        const int c = lane + 32 * u;
        if (c < dh) dd += do_s[r * dh + c] * (acc[r][u] / l[r]);
      }
      dd = warp_sum(dd);
      if (lane == 0) {
        const size_t s = (size_t)bh * t_len + i;
        a.m[s] = m[r];
        a.l[s] = l[r];
        a.dsum[s] = dd;
      }
      continue;
    }
    T* o = static_cast<T*>(a.out) + head_base(a.ov, b, h) + i * a.ov.st;
    T* o2 = static_cast<T*>(a.out2) + head_base(a.o2v, b, h) + i * a.o2v.st;
#pragma unroll
    for (int u = 0; u < kMaxC; ++u) {
      const int c = lane + 32 * u;
      if (c >= dh) continue;
      if (MODE == kFwd) {
        o[c] = from_f<T>(acc[r][u] / l[r]);
      } else {
        o[c] = from_f<T>(acc[r][u]);
        if (ROUND) o2[c] = from_f<T>(acc2[r][u]);
      }
    }
  }
}

template <typename T, bool ROUND>
__global__ void __launch_bounds__(kTileThreads) attn_cols(AttnArgs a) {
  extern __shared__ float smem[];
  const int dh = a.dh, ks = dh + 1, t_len = a.t_len;
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kBlockRows;  // first key row of the block
  float* q_s = smem;
  float* do_s = q_s + kTile * ks;
  float* k_r = do_s + kTile * ks + warp * kTileRows * dh;
  float* v_r = do_s + kTile * ks + kBlockRows * dh + warp * kTileRows * dh;
  float* p_s = do_s + kTile * ks + 2 * kBlockRows * dh + warp * kTile;
  float* ds_s = do_s + kTile * ks + 2 * kBlockRows * dh + kTileWarps * kTile + warp * kTile;
  float* st_m = do_s + kTile * ks + 2 * kBlockRows * dh + 2 * kTileWarps * kTile;
  float* st_l = st_m + kTile;
  float* st_d = st_l + kTile;

  const T* q = static_cast<const T*>(a.q) + head_base(a.in, b, h);
  const T* k = static_cast<const T*>(a.k) + head_base(a.in, b, h);
  const T* v = static_cast<const T*>(a.v) + head_base(a.in, b, h);
  const T* dout = static_cast<const T*>(a.dout) + head_base(a.dov, b, h);

  float dk[kTileRows][kMaxC], dv[kTileRows][kMaxC];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int j = col0 + warp * kTileRows + r;
    if (j < t_len) {
      for (int c = lane; c < dh; c += 32) {
        k_r[r * dh + c] = to_f(k[j * a.in.st + c]);
        v_r[r * dh + c] = to_f(v[j * a.in.st + c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxC; ++u) dk[r][u] = dv[r][u] = 0.f;
  }

  // causal: queries before the block's first key see none of its keys
  const int i_start = a.causal ? (col0 / kTile) * kTile : 0;
  for (int i0 = i_start; i0 < t_len; i0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * dh; e += kTileThreads) {
      const int ii = e / dh, c = e % dh, i = i0 + ii;
      float qv = 0.f, dv_ = 0.f;
      if (i < t_len) {
        qv = to_f(q[i * a.in.st + c]);
        dv_ = to_f(dout[i * a.dov.st + c]);
      }
      q_s[ii * ks + c] = qv;
      do_s[ii * ks + c] = dv_;
    }
    for (int ii = threadIdx.x; ii < kTile; ii += kTileThreads) {
      const int i = i0 + ii;
      const size_t s = (size_t)bh * t_len + i;
      st_m[ii] = i < t_len ? a.m[s] : 0.f;
      st_l[ii] = i < t_len ? a.l[s] : 1.f;
      st_d[ii] = i < t_len ? a.dsum[s] : 0.f;
    }
    __syncthreads();
    const int nt = min(kTile, t_len - i0);
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int j = col0 + warp * kTileRows + r;  // warp-uniform
      if (j >= t_len) break;
      const float* kr = k_r + r * dh;
      const float* vr = v_r + r * dh;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ii = lane + 32 * u, i = i0 + ii;
        float p = 0.f, ds = 0.f;
        if (ii < nt && (!a.causal || i >= j)) {
          float x = 0.f, y = 0.f;
          for (int c = 0; c < dh; ++c) {
            x = fmaf(q_s[ii * ks + c], kr[c], x);
            y = fmaf(do_s[ii * ks + c], vr[c], y);
          }
          p = expf(x * a.scale - st_m[ii]) / st_l[ii];
          ds = p * (y - st_d[ii]) * a.scale;
          if (ROUND) {
            ds = round_to<T>(ds);
            p = round_to<T>(p);
          }
        }
        p_s[ii] = p;
        ds_s[ii] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kMaxC; ++u) {
        const int c = lane + 32 * u;
        if (c < dh) {
          float x = dv[r][u], y = dk[r][u];
          for (int ii = 0; ii < nt; ++ii) {
            x = fmaf(p_s[ii], do_s[ii * ks + c], x);
            y = fmaf(ds_s[ii], q_s[ii * ks + c], y);
          }
          dv[r][u] = x;
          dk[r][u] = y;
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int j = col0 + warp * kTileRows + r;
    if (j >= t_len) break;
    T* dk_o = static_cast<T*>(a.out) + head_base(a.ov, b, h) + j * a.ov.st;
    T* dv_o = static_cast<T*>(a.out2) + head_base(a.o2v, b, h) + j * a.o2v.st;
#pragma unroll
    for (int u = 0; u < kMaxC; ++u) {
      const int c = lane + 32 * u;
      if (c >= dh) continue;
      dk_o[c] = from_f<T>(dk[r][u]);
      dv_o[c] = from_f<T>(dv[r][u]);
    }
  }
}

// Launches one tile kernel over grid (B*H, ceil(T / kBlockRows)), after raising
// its dynamic shared-memory limit.
template <typename Kernel>
cudaError_t launch_tiles(Kernel kernel, const AttnArgs& a, int batch, cudaStream_t stream) {
  if (a.dh <= 0 || a.dh > kMaxDh || a.t_len <= 0 || a.n_heads <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(a.dh);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.n_heads, (a.t_len + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kTileThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace cct
