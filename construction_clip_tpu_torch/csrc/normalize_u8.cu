// K6: uint8 RGB -> normalized float in one pass,
//   out = ((x * (1/255)) - mean[c]) * inv_std[c],   c = channel of the element
//
// Replaces construction_clip_tpu/ops/pallas_preprocess.py:_normalize_kernel
// (launched by normalize_u8's pl.pallas_call). Rounding points follow it: the
// byte times the fp32 constant 1/255 (a multiply, not a division), minus the
// fp32 mean, times the fp32 reciprocal of std, each rounded (__fmul_rn,
// __fsub_rn), then one cast to the output type.
//
// The TPU kernel flattens NHWC to [B*H, W*3] lane panels with the 3-periodic
// constants tiled along a row. Here the image is a flat byte array: each
// thread loads 4 bytes (one uchar4 when aligned) and takes each byte's
// channel as its index modulo 3.
#include <cstdint>

#include "common.cuh"

namespace cct {
namespace {

constexpr int kNormThreads = 256;

template <typename Out>
__device__ __forceinline__ void store4(Out* out, long long base, const float (&r)[4]);

template <>
__device__ __forceinline__ void store4<float>(float* out, long long base,
                                              const float (&r)[4]) {
  *reinterpret_cast<float4*>(out + base) = make_float4(r[0], r[1], r[2], r[3]);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* out, long long base,
                                                      const float (&r)[4]) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + base);
  o[0] = __floats2bfloat162_rn(r[0], r[1]);
  o[1] = __floats2bfloat162_rn(r[2], r[3]);
}

template <typename Out>
__global__ void __launch_bounds__(kNormThreads)
normalize_u8_kernel(const uint8_t* __restrict__ in, Out* __restrict__ out, long long n,
                    bool aligned, float scale, float m0, float m1, float m2, float s0,
                    float s1, float s2) {
  const long long i = blockIdx.x * (long long)kNormThreads + threadIdx.x;
  const long long base = 4 * i;
  if (base >= n) return;
  const bool full = base + 3 < n;
  uint8_t v[4] = {0, 0, 0, 0};
  if (full && aligned) {
    const uchar4 u = reinterpret_cast<const uchar4*>(in)[i];
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    for (int j = 0; j < 4 && base + j < n; ++j) v[j] = in[base + j];
  }
  float r[4];
  int c = (int)(base % 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float mean = c == 0 ? m0 : (c == 1 ? m1 : m2);
    const float inv_std = c == 0 ? s0 : (c == 1 ? s1 : s2);
    r[j] = __fmul_rn(__fsub_rn(__fmul_rn((float)v[j], scale), mean), inv_std);
    c = c == 2 ? 0 : c + 1;
  }
  if (full) {
    store4<Out>(out, base, r);   // out is the wrapper's own allocation: aligned
  } else {
    for (int j = 0; j < 4 && base + j < n; ++j) out[base + j] = from_f<Out>(r[j]);
  }
}

template <typename Out>
cudaError_t run_normalize(const void* in, void* out, long long n, float scale,
                          const float* mean, const float* inv_std, cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const long long threads = (n + 3) / 4;
  const long long blocks = (threads + kNormThreads - 1) / kNormThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 4 == 0;
  normalize_u8_kernel<Out><<<(unsigned)blocks, kNormThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<Out*>(out), n, aligned, scale, mean[0],
      mean[1], mean[2], inv_std[0], inv_std[1], inv_std[2]);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means the launch was refused. `in` holds n
// bytes of NHWC images with 3 channels, `out` n elements of out_dtype
// (csrc/common.cuh: DType), both contiguous; `scale` is the fp32 1/255.
extern "C" int cct_normalize_u8(int out_dtype, const void* in, void* out, long long n,
                                float scale, float m0, float m1, float m2, float s0, float s1,
                                float s2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float mean[3] = {m0, m1, m2}, inv_std[3] = {s0, s1, s2};
  switch (out_dtype) {
    case cct::kFloat32:
      return cct::run_normalize<float>(in, out, n, scale, mean, inv_std, s);
    case cct::kBFloat16:
      return cct::run_normalize<__nv_bfloat16>(in, out, n, scale, mean, inv_std, s);
    default:
      return cudaErrorInvalidValue;
  }
}
