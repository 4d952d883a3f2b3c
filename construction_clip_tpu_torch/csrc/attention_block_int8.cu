// K7: fused pre-norm attention block with int8 weights and int8 activations
// (serving forward only),
//   out = x + W_out . MHA(split_heads(W_qkv . LN(x))) with per-row dynamic
//   activation quantization in front of both weight products.
//
// Replaces construction_clip_tpu/ops/pallas_attention_block_int8.py:_kernel
// (launched by _forward's pl.pallas_call). W_qkv [D, 3D] and W_out [D, D] are
// int8 with one fp32 scale per output column (ops/quant.quantize_weight);
// x, the LN parameters, the biases and the output are T (fp32 or bf16).
// Rounding points follow that kernel:
//   h32 = (x32 - mean) * rsqrt(var + eps) * ln_s + ln_b in fp32, not rounded;
//   hs = amax(|h32| over the row) / 127 (1 for a zero row),
//   hq = clip(round_half_even(h32 / hs), +-127);
//   qkv = T(float(hq . W_qkv) * hs * s_qkv + b_qkv), the product in int32;
//   merged32 = per-head attention (row_attention.cuh, or tc_block_fwd of
//   attention_tc.cuh on the tensor-core route) written in fp32;
//   ms, mq from merged32 as hs, hq from h32 (the row spans every head);
//   out = T((x32 + float(mq . W_out) * ms * s_out) + b_out).
// The scale epilogues and LN's affine step use __fmul_rn/__fadd_rn, so nvcc
// contracts none of them into an FMA; the division by the scale is an IEEE
// division (the build passes no --use_fast_math), and rounding is rintf
// (half to even, as jnp.round).
//
// What bounds it on the H100: at [8,50,768] the two products are 1.9 G int8
// operations against ~2.4 MB of int8 weights, under a microsecond at the
// tensor cores' 1,979 TOP/s and ~1 us of HBM traffic at 3.35 TB/s; it is bound
// by memory, and in practice by its five dependent launches.
//
// Design: five launches from one C entry, with the quantized rows, their
// scales, qkv and the fp32 merged heads in device scratch the wrapper
// allocates (a Hopper block has 227 KB of shared memory, not the TPU's VMEM
// that holds both weight matrices):
//   (a) quantize_rows<LN>: one block per row: LN in fp32, then the row's int8
//       values and scale;
//   (b) the qkv product with the qkv epilogue: gemm_s8 (gemm_s8.cuh: wgmma
//       s8 -> s32 on the tensor cores, TMA-fed int8 tiles, the weight read
//       K-major where it lies) where D % 16 == 0 (TMA's row pitch), else
//       int8_gemm below (64x64 tiles, 32 bytes of K per stage, __dp4a on the
//       CUDA cores); the int32 sums are exact, so both give the same bits;
//   (c) per-head attention into fp32 merged rows;
//   (d) quantize_rows<no LN> over the fp32 merged rows;
//   (e) the out product with the residual epilogue, as (b).
// Two routes, chosen by ops/attention_block_int8.py:route (a launch on one
// never retries the other):
//   cct_attention_block_int8 (fp32, and bf16 at head widths other than 64):
//     (c) is row_attention<T, float> (row_attention.cuh, K1's SIMT pass:
//     blocks of 16 or 64 query rows of a head, register micro-tiles, fp32 FMA
//     on the CUDA cores: fp32 on the tensor cores would be TF32);
//   cct_attention_block_int8_tc (bf16 at dh = 64, T <= 256): (c) is
//     tc_block_fwd<float> (attention_tc.cuh, K1's wgmma pass, q, k and v read
//     at column offsets of qkv through a 3-D TMA map), stored in fp32.
// The rounding points are the same on both routes; bf16(p) is the operand
// wgmma takes anyway. No library GEMM or attention is called.
#include <cstdint>

#include "attention_tc.cuh"
#include "common.cuh"
#include "gemm_s8.cuh"
#include "row_attention.cuh"

namespace cct {
namespace {

constexpr int kRowThreads = 256, kRowWarps = kRowThreads / 32;
constexpr int kQBM = 64, kQBN = kQBM, kQBK = 32, kQWords = kQBK / 4, kQThreads = 256;
constexpr size_t kRowSmemLimit = 48 * 1024;  // the row buffer, without an opt-in

// Sum (or max) over the block of one value per thread, in a fixed order.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kRowWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

// One block per row of `in` [M, D]: (LN then) per-row int8 quantization.
template <typename In, typename P, bool kLn>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows(const In* __restrict__ in, const P* __restrict__ ln_s,
              const P* __restrict__ ln_b, int8_t* __restrict__ q,
              float* __restrict__ scale, int d, float eps) {
  extern __shared__ float row[];
  __shared__ float red[kRowWarps];
  const In* src = in + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += kRowThreads) row[c] = to_f(src[c]);
  if constexpr (kLn) {
    float s = 0.f;
    for (int c = threadIdx.x; c < d; c += kRowThreads) s += row[c];
    const float mean = block_reduce<false>(s, red) / d;
    float v = 0.f;
    for (int c = threadIdx.x; c < d; c += kRowThreads) {
      const float dv = row[c] - mean;
      v += dv * dv;
    }
    const float rstd = 1.f / sqrtf(block_reduce<false>(v, red) / d + eps);
    for (int c = threadIdx.x; c < d; c += kRowThreads)
      row[c] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(row[c], mean), rstd), to_f(ln_s[c])),
                         to_f(ln_b[c]));
  }
  float a = 0.f;
  for (int c = threadIdx.x; c < d; c += kRowThreads) a = fmaxf(a, fabsf(row[c]));
  float s = __fdiv_rn(block_reduce<true>(a, red), 127.f);
  s = s > 0.f ? s : 1.f;
  int8_t* dst = q + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += kRowThreads)
    dst[c] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(row[c], s)), -127.f), 127.f);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) | ((int)((unsigned)b3 << 24));
}

// tile[r][kw] = the 4 bytes src[row0 + r, k0 + 4 kw ...] of an int8 [rows, K]
// matrix, K contiguous, packed in one word (zeros past the edges); consecutive
// threads read consecutive words of a row.
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ src, int rows, int row0,
                                          int K, int k0, int (*tile)[kQWords + 1]) {
  for (int i = threadIdx.x; i < kQBM * kQWords; i += kQThreads) {
    const int r = i / kQWords, kw = i % kQWords, row = row0 + r, k = k0 + 4 * kw;
    int b[4] = {0, 0, 0, 0};
    if (row < rows) {
      const int8_t* p = src + (size_t)row * K;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < K) b[j] = p[k + j];
    }
    tile[r][kw] = pack4(b[0], b[1], b[2], b[3]);
  }
}

// out[M, N] = epilogue(int32(a [M, K] . w [K, N])), with a row-major and w
// stored K-contiguous (w_t [N, K] row-major: the layout ops/quant.py keeps
// quantized weights in). Each of the 256 threads owns a 4x4 set of outputs
// strided by 16.
template <int EPI, typename T>
__global__ void __launch_bounds__(kQThreads)
int8_gemm(const int8_t* __restrict__ a, const float* __restrict__ a_scale,
          const int8_t* __restrict__ w_t, const float* __restrict__ w_scale,
          const T* __restrict__ bias, const T* __restrict__ resid, T* __restrict__ out,
          int M, int N, int K) {
  __shared__ int a_s[kQBM][kQWords + 1];  // 4 consecutive k of one row per word
  __shared__ int w_s[kQBN][kQWords + 1];  // 4 consecutive k of one column per word
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kQBM, n0 = blockIdx.x * kQBN;
  const int tx = tid % 16, ty = tid / 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kQBK) {
    load_tile(a, M, m0, K, k0, a_s);
    load_tile(w_t, N, n0, K, k0, w_s);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kQWords; ++kw) {
      int av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w_s[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float sa = a_scale[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sa), w_scale[n]);
      if constexpr (EPI == kInt8Qkv)
        out[o] = from_f<T>(__fadd_rn(y, to_f(bias[n])));
      else
        out[o] = from_f<T>(__fadd_rn(__fadd_rn(to_f(resid[o]), y), to_f(bias[n])));
    }
  }
}

// out = epilogue(a . w_t^T) (w_t [N, K] row-major) on the tensor cores where
// TMA takes the rows (K % 16 == 0), else on the __dp4a GEMM: chosen by shape,
// never after a failure.
template <int EPI, typename T>
cudaError_t int8_product(const int8_t* a, const float* a_scale, const void* w_t,
                         const void* w_scale, const void* bias, const void* resid, void* out,
                         int M, int N, int K, cudaStream_t stream) {
  const int8_t* w = static_cast<const int8_t*>(w_t);
  const float* ws = static_cast<const float*>(w_scale);
  const T* b = static_cast<const T*>(bias);
  const T* r = static_cast<const T*>(resid);
  T* o = static_cast<T*>(out);
  if (K % 16 == 0) return launch_gemm_s8<EPI, T>(a, a_scale, w, ws, b, r, o, M, N, K, stream);
  int8_gemm<EPI, T><<<dim3((N + kQBN - 1) / kQBN, (M + kQBM - 1) / kQBM), kQThreads, 0,
                      stream>>>(a, a_scale, w, ws, b, r, o, M, N, K);
  return cudaGetLastError();
}

#define CCT_TRY(expr)                      \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

// The five launches; TC picks the attention pass (c): tc_block_fwd<float>
// (bf16, dh = 64) or row_attention<T, float>.
template <typename T, bool TC>
cudaError_t run_block_int8(const void* x, const void* ln_s, const void* ln_b,
                           const void* w_qkv, const void* s_qkv, const void* b_qkv,
                           const void* w_out, const void* s_out, const void* b_out,
                           void* q8, void* rs, void* qkv, void* merged, void* out, int b,
                           int t, int d, int h, int causal, float eps, float scale,
                           cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d % h != 0) return cudaErrorInvalidValue;
  if (TC && (d / h != kTcDh || n_tiles(t) > kBlockMaxTiles)) return cudaErrorInvalidValue;
  const int m = b * t;
  const size_t row_smem = sizeof(float) * (size_t)d;
  if (row_smem > kRowSmemLimit) return cudaErrorInvalidValue;
  int8_t* q = static_cast<int8_t*>(q8);
  float* r = static_cast<float*>(rs);

  quantize_rows<T, T, true><<<m, kRowThreads, row_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ln_s), static_cast<const T*>(ln_b), q,
      r, d, eps);
  CCT_TRY(cudaGetLastError());
  CCT_TRY((int8_product<kInt8Qkv, T>(q, r, w_qkv, s_qkv, b_qkv, nullptr, qkv, m, 3 * d, d,
                                     stream)));
  if constexpr (TC) {
    CUtensorMap mqkv;  // [B, T, 3D] in 64 x 64 boxes, zeros past T
    CCT_TRY(hopper::tile_map(&mqkv, qkv, b, t, 3 * d, kBoxRows));
    CCT_TRY(tc_launch(tc_block_fwd<float, kTcDh>, tc_block_smem_bytes<kTcDh>(t), b * h, t,
                      stream, mqkv,
                      TcGeom{h, {0, d, 2 * d, 0}},
                      TcOutOf<float>{static_cast<float*>(merged), (long long)t * d, d}, t,
                      causal, scale));
  } else {
    CCT_TRY((launch_row_attention<T, float>(static_cast<const T*>(qkv),
                                            static_cast<float*>(merged), b, t, d, h, causal,
                                            scale, stream)));
  }
  quantize_rows<float, T, false><<<m, kRowThreads, row_smem, stream>>>(
      static_cast<const float*>(merged), nullptr, nullptr, q, r, d, eps);
  CCT_TRY(cudaGetLastError());
  return int8_product<kInt8Residual, T>(q, r, w_out, s_out, b_out, x, out, m, d, d, stream);
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means a launch was refused. Scratch from the
// wrapper: q8 int8 [B*T, D] and rs fp32 [B*T] (the quantized rows of LN(x),
// then of the merged heads), qkv [B*T, 3D] of the input type, merged fp32
// [B*T, D]. x, ln_s, ln_b, b_qkv, b_out and out have the input type and are
// contiguous; w_qkv [D, 3D] and w_out [D, D] are int8 stored K-contiguous
// (their transposes are contiguous); s_qkv and s_out are contiguous fp32.
// The tensor-core route reads q8, the weights and qkv through TMA maps: their
// bases 16-byte aligned.
// The SIMT attention route.
extern "C" int cct_attention_block_int8(int dtype, const void* x, const void* ln_s,
                                        const void* ln_b, const void* w_qkv,
                                        const void* s_qkv, const void* b_qkv,
                                        const void* w_out, const void* s_out,
                                        const void* b_out, void* q8, void* rs, void* qkv,
                                        void* merged, void* out, int b, int t, int d, int h,
                                        int causal, float eps, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_block_int8<float, false>(x, ln_s, ln_b, w_qkv, s_qkv, b_qkv, w_out,
                                               s_out, b_out, q8, rs, qkv, merged, out, b, t, d,
                                               h, causal, eps, scale, s);
    case cct::kBFloat16:
      return cct::run_block_int8<__nv_bfloat16, false>(x, ln_s, ln_b, w_qkv, s_qkv, b_qkv,
                                                       w_out, s_out, b_out, q8, rs, qkv, merged,
                                                       out, b, t, d, h, causal, eps, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core attention route, same arguments: bf16 at dh = 64 and
// T <= 256 only (anything else is refused, never run on the other route).
extern "C" int cct_attention_block_int8_tc(int dtype, const void* x, const void* ln_s,
                                           const void* ln_b, const void* w_qkv,
                                           const void* s_qkv, const void* b_qkv,
                                           const void* w_out, const void* s_out,
                                           const void* b_out, void* q8, void* rs, void* qkv,
                                           void* merged, void* out, int b, int t, int d, int h,
                                           int causal, float eps, float scale, void* stream) {
  if (dtype != cct::kBFloat16) return cudaErrorInvalidValue;
  return cct::run_block_int8<__nv_bfloat16, true>(x, ln_s, ln_b, w_qkv, s_qkv, b_qkv, w_out,
                                                  s_out, b_out, q8, rs, qkv, merged, out, b, t,
                                                  d, h, causal, eps, scale,
                                                  static_cast<cudaStream_t>(stream));
}
