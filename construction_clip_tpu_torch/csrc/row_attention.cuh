// The attention pass of the fused blocks' SIMT chains: K1's fp32 route and its
// bf16 route at head widths off the tensor cores (csrc/attention_block.cu), and
// K7's SIMT entry (csrc/attention_block_int8.cu).
//
//   merged[b, i, h dh .. (h+1) dh) = sum_j T(p_ij) v_j / l_i,
//   p_ij = exp(s_ij - m_i), s_ij = (q_i . k_j) * dh^-0.5, m_i = max_j s_ij,
//   l_i = sum_j p_ij (fp32, unrounded),
//
// q, k and v read out of the packed qkv [B*T, 3D] rows (q | k | v, heads at
// column offsets), the result written as O (T for K1; fp32 for K7, whose out
// product quantizes the merged rows in fp32). Rounding points follow the
// Pallas blocks' per_head_attention: p is rounded to T against the row's final
// max (K4 rounds against a running max, so this is a pass of its own), causal
// keys carry p == 0.
//
// What bounds it on the H100: fp32 on the tensor cores would be TF32, so both
// products run as fp32 FMA on the CUDA cores, 4 T^2 dh operations a head (61
// MFLOP at [8, 50, 768], 12 heads: 0.9 us at 67 TFLOP/s) against 16 T dh bytes
// of qkv and merged rows a head (4.9 MB there, 1.5 us at 3.35 TB/s). At these
// sizes the pass is bound by latency: a load of K, a product, the softmax, a
// load of V and a product, one after the other in each block.
//
// Design (T <= 256 under the blocks' gate):
//   - one block of 8 warps owns (batch, head, QR query rows), QR = 16 or 64
//     (NI = QR / 16; row_attention_rows): 64, all the rows of a head, where
//     T <= 64, no mask and the heads alone fill the SMs (one staging of k
//     and v serves them all); else 16, so that more blocks share the work
//     (at [8, 50, 768] 384 blocks) and causal blocks skip the key tiles past
//     their rows;
//   - the block's whole [QR, T] score panel stays in shared memory (16 KB at
//     16 rows x 256 keys), so the pass takes two sweeps and computes nothing
//     twice: sweep 1 streams 64-key tiles of k and writes s through register
//     micro-tiles, rows ty + 16 i by keys tx + 16 j, fed by 16-byte shared
//     loads along the head width (attention_tiles.cuh's layout); then a warp a
//     row takes m, p = exp(s - m) and l from the panel and leaves T(p) there;
//     sweep 2 streams 64-key tiles of v into an output micro-tile, rows
//     ty + 16 i by the 16-byte column chunks tx + 16 u of a W-wide slice;
//   - the tiles stream through a ring of two stages by cp.async (16-byte
//     copies, zeros past T), the next tile in flight while this one computes
//     (v's first tile behind the softmax); bf16, and fp32 rows that are not
//     16-byte aligned, are copied with plain loads, widened to fp32;
//   - heads wider than W = 128 floats (K7 at small T) run in W-wide slices:
//     sweep 1 continues each score's chain slice after slice (q's slice
//     staged with k's), sweep 2 runs once a slice of the output, and such
//     blocks take 16 rows.
//
// The outputs are bit-equal to the one-warp-a-row pass this replaces: each s
// is one fmaf chain over c = 0 .. dh-1 from 0 and then one rounded product by
// the scale; m a max; each lane L of a row's warp sums p over keys L + 32 k in
// order, then warp_sum's XOR butterfly; each output one fmaf chain over the
// row's keys in order, a tile at a time, then an IEEE division by l.
#pragma once

#include <cfloat>
#include <type_traits>

#include "attention_tiles.cuh"  // cp.async, tile_stride, kTile
#include "common.cuh"

namespace cct {

constexpr int kRowAttnThreads = 256;  // 8 warps: 16 x 16 threads of the micro-tiles
constexpr int kRowAttnMaxW = 128;     // the widest slice of the head a sweep holds

struct RowAttnArgs {
  const void* qkv;  // [B*T, 3D] of T
  void* merged;     // [B*T, D] of O
  int t_len, d, n_heads, dh, causal;
  float scale;
  int vec;       // fp32 rows copied in 16-byte chunks
  int n_slices;  // ceil(dh / W)
  int ks;        // row stride (floats) of a staged tile
  int ps;        // row stride (floats) of the score panel
};

// Rows r0 .. r0 + n - 1 of a head's slice (src: its first column, rows st
// apart), cw columns, into dst (stride ks), zeros past T. vec: 16-byte
// cp.async copies, which the caller commits; else plain loads, zeros also past
// cw up to the next multiple of 4.
template <typename T>
__device__ __forceinline__ void stage_slice(float* dst, const T* src, long long st, int r0,
                                            int n, int t_len, int cw, int ks, bool vec) {
  if constexpr (std::is_same_v<T, float>) {
    if (vec) {
      const int nc = cw >> 2;
      for (int e = threadIdx.x; e < n * nc; e += kRowAttnThreads) {
        const int r = e / nc, c = (e - r * nc) << 2, row = r0 + r;
        const bool ok = row < t_len;
        cp_async16(dst + r * ks + c, src + (ok ? row * st + c : 0), ok);
      }
      return;
    }
  }
  const int cp = (cw + 3) & ~3;
  for (int e = threadIdx.x; e < n * cp; e += kRowAttnThreads) {
    const int r = e / cp, c = e - r * cp, row = r0 + r;
    dst[r * ks + c] = row < t_len && c < cw ? to_f(src[row * st + c]) : 0.f;
  }
}

// s[i][j] continues its fmaf chain over columns 0 .. cw-1 of the slice with
// q[ty + 16 i][c] k[tx + 16 j][c], for the key groups j < nj.
template <int NI>
__device__ __forceinline__ void score_slice(float (&s)[NI][4], const float* q, const float* k,
                                            int ks, int cw, int tx, int ty, int nj) {
  const float* qr = q + ty * ks;
  const float* kr = k + tx * ks;
  const int c4 = cw & ~3;
#pragma unroll 2
  for (int c = 0; c < c4; c += 4) {
    float4 qv[NI], kv[4];
#pragma unroll
    for (int i = 0; i < NI; ++i) qv[i] = *reinterpret_cast<const float4*>(qr + 16 * i * ks + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nj) kv[j] = *reinterpret_cast<const float4*>(kr + 16 * j * ks + c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj) s[i][j] = fmaf(f32_lane(qv[i], e), f32_lane(kv[j], e), s[i][j]);
  }
  for (int c = c4; c < cw; ++c) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nj) s[i][j] = fmaf(qr[16 * i * ks + c], kr[16 * j * ks + c], s[i][j]);
  }
}

// acc[i][u][e] continues its fmaf chain with pan[ty + 16 i][jj] v[jj][4 (tx + 16 u) + e]
// over the keys jj = 0 .. n-1 of a tile in order (pan: the panel at the tile's
// first key), for the chunks below nch. EDGE: n at run time, and row i's chain
// stops at nt[i] (keys past its causal limit or past T add nothing); else 64.
template <int NI, int C, bool EDGE>
__device__ __forceinline__ void out_slice(float (&acc)[NI][C][4], const float* pan, int ps,
                                          const float* v, int ks, int n, const int (&nt)[NI],
                                          int tx, int ty, int nch) {
  const float* pr = pan + ty * ps;
  if (!EDGE) n = kTile;
#pragma unroll 2
  for (int j4 = 0; j4 < n; j4 += 4) {
    float4 pv[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) pv[i] = *reinterpret_cast<const float4*>(pr + 16 * i * ps + j4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = j4 + e;
      if (EDGE && jj >= n) break;
      const float* vr = v + jj * ks + 4 * tx;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        if (tx + 16 * u >= nch) continue;
        const float4 bv = *reinterpret_cast<const float4*>(vr + 64 * u);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          if (EDGE && jj >= nt[i]) continue;
          const float p = f32_lane(pv[i], e);
          acc[i][u][0] = fmaf(p, bv.x, acc[i][u][0]);
          acc[i][u][1] = fmaf(p, bv.y, acc[i][u][1]);
          acc[i][u][2] = fmaf(p, bv.z, acc[i][u][2]);
          acc[i][u][3] = fmaf(p, bv.w, acc[i][u][3]);
        }
      }
    }
  }
}

// grid (B*H, ceil(T / QR)), QR = 16 NI rows a block; W: the slice width, 64 or
// 128 floats. Shared memory: q's [QR, ks] (one slice only), the ring's two
// stages ([64, ks] of k or v, and with several slices q's slice beside k's),
// the [QR, ps] panel and the rows' l.
template <typename T, typename O, int NI, int W>
__global__ void __launch_bounds__(kRowAttnThreads) row_attention(RowAttnArgs a) {
  constexpr int QR = 16 * NI, C = W / 64;
  extern __shared__ float4 row_attn_smem[];
  float* sm = reinterpret_cast<float*>(row_attn_smem);
  const int t_len = a.t_len, d = a.d, dh = a.dh, ks = a.ks, ps = a.ps, ns = a.n_slices;
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * QR;
  const bool vec = a.vec;
  const int stage = kTile * ks + (ns > 1 ? QR * ks : 0);
  float* q_s = sm;
  float* ring = q_s + (ns > 1 ? 0 : QR * ks);
  float* pan = ring + 2 * stage;
  float* row_l = pan + QR * ps;

  const long long st = 3LL * d;
  const T* q = static_cast<const T*>(a.qkv) + (long long)b * t_len * st + (long long)h * dh;
  const T* k = q + d;
  const T* v = q + 2 * d;

  const int last_row = min(t_len, row0 + QR);
  const int n_keys = a.causal ? last_row : t_len;
  const int n_kt = (n_keys + kTile - 1) / kTile;
  const int n1 = n_kt * ns, n_items = 2 * n1;
  // threads whose first row lies past T skip the products; they meet every barrier
  const bool live = row0 + ty < t_len;
  int lim[NI];  // row ty + 16 i sees keys below lim[i] (none past T)
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = row0 + ty + 16 * i;
    lim[i] = row < t_len ? (a.causal ? row + 1 : t_len) : 0;
  }

  // item it < n1: sweep 1, key tile it / ns and slice it % ns; else sweep 2,
  // slice (it - n1) / n_kt and key tile (it - n1) % n_kt
  auto issue = [&](int it) {
    float* dst = ring + (it & 1) * stage;
    if (it < n1) {
      const int kt = it / ns, c0 = (it % ns) * W, cw = min(W, dh - c0);
      stage_slice(dst, k + c0, st, kt * kTile, kTile, t_len, cw, ks, vec);
      if (ns > 1)
        stage_slice(dst + kTile * ks, q + c0, st, row0, QR, t_len, cw, ks, vec);
      else if (it == 0)
        stage_slice(q_s, q, st, row0, QR, t_len, dh, ks, vec);
    } else {
      const int j = it - n1, c0 = (j / n_kt) * W, kt = j % n_kt;
      stage_slice(dst, v + c0, st, kt * kTile, kTile, t_len, min(W, dh - c0), ks, vec);
    }
    cp_async_commit();
  };

  float s[NI][4], acc[NI][C][4];
  issue(0);
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // item it is in; every thread is done with item it - 1
    if (it + 1 < n_items) issue(it + 1);
    const float* tile = ring + (it & 1) * stage;
    if (it < n1) {
      const int kt = it / ns, sl = it % ns, j0 = kt * kTile;
      const int cw = min(W, dh - sl * W);
      if (sl == 0) {
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      if (live)
        score_slice(s, ns > 1 ? tile + kTile * ks : q_s, tile, ks, cw, tx, ty,
                    min(4, (n_keys - j0 + 15) >> 4));
      if (sl == ns - 1) {
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = j0 + tx + 16 * j;
            if (key < lim[i]) pan[(ty + 16 * i) * ps + key] = __fmul_rn(s[i][j], a.scale);
          }
      }
      if (it == n1 - 1) {
        __syncthreads();  // the whole panel of s is in
        // a warp a row: m, then p = exp(s - m) into the panel as T(p), and l
        // summed over keys lane + 32 k before the XOR butterfly
        for (int r = warp; r < QR; r += kRowAttnThreads / 32) {
          const int row = row0 + r;
          if (row >= t_len) break;
          const int n = a.causal ? row + 1 : t_len;
          float* pr = pan + r * ps;
          float m = -FLT_MAX;
          for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
          m = warp_max(m);
          float l = 0.f;
          for (int j = lane; j < n; j += 32) {
            const float p = expf(__fsub_rn(pr[j], m));
            l = __fadd_rn(l, p);
            pr[j] = round_to<T>(p);
          }
          l = warp_sum(l);
          if (lane == 0) row_l[r] = l;
        }
      }
    } else {
      const int j = it - n1, sl = j / n_kt, kt = j % n_kt, j0 = kt * kTile;
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int u = 0; u < C; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][u][e] = 0.f;
      }
      const int nch = (min(W, dh - sl * W) + 3) >> 2;
      if (live) {
        const bool edge = j0 + kTile > t_len || (a.causal && j0 + kTile > row0 + 1);
        int nt[NI];  // a row's keys in this tile: up to its causal limit, none past T
#pragma unroll
        for (int i = 0; i < NI; ++i) nt[i] = max(0, min(kTile, lim[i] - j0));
        if (edge)
          out_slice<NI, C, true>(acc, pan + j0, ps, tile, ks, min(kTile, n_keys - j0), nt, tx,
                                 ty, nch);
        else
          out_slice<NI, C, false>(acc, pan + j0, ps, tile, ks, kTile, nt, tx, ty, nch);
      }
      if (kt == n_kt - 1) {
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int r = ty + 16 * i, row = row0 + r;
          if (row >= t_len) continue;
          O* o = static_cast<O*>(a.merged) + ((long long)b * t_len + row) * d +
                 (long long)h * dh + sl * W;
#pragma unroll
          for (int u = 0; u < C; ++u) {
            const int c0 = 4 * (tx + 16 * u);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (sl * W + c0 + e < dh)
                o[c0 + e] = from_f<O>(acc[i][u][e] / row_l[r]);
          }
        }
      }
    }
  }
}

// The rows a block owns: 64 (every row of a head: one staging of k and v for
// all) where T <= 64, no mask, one slice, and the heads alone give every SM
// a block; else 16. Measured on the H100 at the towers' fp32 shapes, 32 rows
// were never the fastest, and 64 were at most 2% faster where this picks 16
// (causal blocks of 16 rows skip the key tiles past their rows; at 96 heads
// 64-row blocks leave SMs idle).
inline cudaError_t row_attention_rows(int heads, int t_len, int causal, int n_slices,
                                      int* rows) {
  *rows = 16;
  if (n_slices > 1 || causal || t_len > kTile) return cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (heads >= sms) *rows = 64;
  return cudaSuccess;
}

template <typename T, typename O, int NI, int W>
cudaError_t launch_row_attention_tile(const RowAttnArgs& a, int batch, cudaStream_t stream) {
  constexpr int QR = 16 * NI;
  const size_t floats = (size_t)(a.n_slices > 1 ? 0 : QR * a.ks) +
                        2 * ((size_t)kTile * a.ks + (a.n_slices > 1 ? QR * a.ks : 0)) +
                        (size_t)QR * a.ps + QR;
  const size_t smem = sizeof(float) * floats;
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  const auto kernel = row_attention<T, O, NI, W>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(batch * a.n_heads, (a.t_len + QR - 1) / QR), kRowAttnThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename O, int W>
cudaError_t launch_row_attention_w(const RowAttnArgs& a, int batch, int rows,
                                   cudaStream_t stream) {
  return rows == 64 ? launch_row_attention_tile<T, O, 4, W>(a, batch, stream)
                    : launch_row_attention_tile<T, O, 1, W>(a, batch, stream);
}

// merged [B*T, D] of O = the heads' attention over qkv [B*T, 3D] of T; any
// head width (heads wider than 128 in 128-wide slices), and any T whose score
// panel fits a block's shared memory (every T <= 256, the blocks' gate).
template <typename T, typename O>
cudaError_t launch_row_attention(const T* qkv, O* merged, int b, int t, int d, int h,
                                 int causal, float scale, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d % h != 0)
    return cudaErrorInvalidValue;
  RowAttnArgs a{};
  a.qkv = qkv;
  a.merged = merged;
  a.t_len = t;
  a.d = d;
  a.n_heads = h;
  a.dh = d / h;
  a.causal = causal;
  a.scale = scale;
  a.vec = std::is_same_v<T, float> && a.dh % 4 == 0 && aligned16(qkv);
  const int w = a.dh <= 64 ? 64 : kRowAttnMaxW;
  a.n_slices = (a.dh + w - 1) / w;
  a.ks = tile_stride(a.dh < w ? a.dh : w);
  a.ps = (t + kTile - 1) / kTile * kTile + 4;
  int rows = 16;
  const cudaError_t err = row_attention_rows(b * h, t, causal, a.n_slices, &rows);
  if (err != cudaSuccess) return err;
  return w == 64 ? launch_row_attention_w<T, O, 64>(a, b, rows, stream)
                 : launch_row_attention_w<T, O, kRowAttnMaxW>(a, b, rows, stream);
}

}  // namespace cct
