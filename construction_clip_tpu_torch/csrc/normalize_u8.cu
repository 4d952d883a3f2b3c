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
// constants tiled along a row. Here the image is a flat byte array.
//
// Bound: bytes (three fp32 operations for 3 or 5 bytes moved), and most of
// them are the output's. So each thread writes 16 bytes: 8 elements of bf16
// from one 8-byte load, or 4 of fp32 from one 4-byte load; a warp's store is
// then 512 contiguous bytes and its load 256 or 128. The channel of a
// thread's first element is its group's index times 8 (or 4) modulo 3, taken
// once in 32 bits; the three means and stds are rotated by it with selects,
// so that every element's constants are fixed at compile time. A thread that
// takes 48 bytes (three 16-byte loads, the channel fixed at compile time)
// measured 2.9x (bf16) and 5.9x (fp32) slower at [256,224,224,3] on an H100
// (chip_smoke.py phase 18): each of its 16-byte stores lands 96 or 192 bytes
// from its neighbour's, so every store instruction of a warp writes parts of
// 32 lines. The grid covers the work, one block for every 256 groups, with a
// grid-stride loop only past the grid's limit (a grid of one resident wave
// was slower in a bench on the H100). A tail of fewer than 8 (or 4)
// elements, and an input off an 8-byte (4-byte) boundary (a view with an odd
// storage offset), take a scalar path of one element a thread.
//
// No TMA: the pass reuses nothing, so a copy through shared memory would add a
// step and save no byte of device-memory traffic.
#include <cstdint>

#include "common.cuh"

namespace cct {
namespace {

constexpr int kNormThreads = 256;
constexpr long long kMaxBlocks = 0x7fffffffLL;

struct Consts {
  float scale, mean[3], inv_std[3];
};

__device__ __forceinline__ float normalize(uint32_t byte, float scale, float mean,
                                           float inv_std) {
  return __fmul_rn(__fsub_rn(__fmul_rn((float)byte, scale), mean), inv_std);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Elements a thread writes as one 16-byte store, and the load that reads them.
template <typename Out>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const uint8_t* in, long long g, uint32_t (&w)[2]) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(in) + g);
    w[1] = 0;
  }
  __device__ static void store(float* out, long long g, const float (&r)[4]) {
    reinterpret_cast<float4*>(out)[g] = make_float4(r[0], r[1], r[2], r[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void load(const uint8_t* in, long long g, uint32_t (&w)[2]) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(in) + g);
    w[0] = v.x;
    w[1] = v.y;
  }
  __device__ static void store(__nv_bfloat16* out, long long g, const float (&r)[8]) {
    reinterpret_cast<uint4*>(out)[g] = make_uint4(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]),
                                                  pack_bf16(r[4], r[5]), pack_bf16(r[6], r[7]));
  }
};

// Groups of Vec<Out>::kElems elements (`in` aligned to a group's bytes), then
// the tail of n % kElems elements one a thread in block 0.
template <typename Out>
__global__ void __launch_bounds__(kNormThreads)
normalize_u8_kernel(const uint8_t* __restrict__ in, Out* __restrict__ out, long long n,
                    Consts k) {
  constexpr int E = Vec<Out>::kElems;
  const long long groups = n / E;
  for (long long g = blockIdx.x * (long long)kNormThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kNormThreads) {
    uint32_t w[2];
    Vec<Out>::load(in, g, w);
    const int c = (int)((unsigned)(g % 3) * (unsigned)E % 3u);   // channel of element 0
    const float m[3] = {c == 0 ? k.mean[0] : c == 1 ? k.mean[1] : k.mean[2],
                        c == 0 ? k.mean[1] : c == 1 ? k.mean[2] : k.mean[0],
                        c == 0 ? k.mean[2] : c == 1 ? k.mean[0] : k.mean[1]};
    const float s[3] = {c == 0 ? k.inv_std[0] : c == 1 ? k.inv_std[1] : k.inv_std[2],
                        c == 0 ? k.inv_std[1] : c == 1 ? k.inv_std[2] : k.inv_std[0],
                        c == 0 ? k.inv_std[2] : c == 1 ? k.inv_std[0] : k.inv_std[1]};
    float r[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      r[j] = normalize((w[j / 4] >> (8 * (j % 4))) & 0xffu, k.scale, m[j % 3], s[j % 3]);
    }
    Vec<Out>::store(out, g, r);
  }
  const long long i = groups * E + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const int c = (int)(i % 3);
    out[i] = from_f<Out>(normalize(in[i], k.scale, k.mean[c], k.inv_std[c]));
  }
}

// One element a thread, for an input off a group's boundary.
template <typename Out>
__global__ void __launch_bounds__(kNormThreads)
normalize_u8_scalar_kernel(const uint8_t* __restrict__ in, Out* __restrict__ out, long long n,
                           Consts k) {
  for (long long i = blockIdx.x * (long long)kNormThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kNormThreads) {
    const int c = (int)(i % 3);
    out[i] = from_f<Out>(normalize(in[i], k.scale, k.mean[c], k.inv_std[c]));
  }
}

template <typename Out>
cudaError_t run_normalize(const void* in, void* out, long long n, const Consts& k,
                          cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  constexpr int E = Vec<Out>::kElems;
  const bool aligned = reinterpret_cast<uintptr_t>(in) % E == 0;   // E bytes of input a group
  const long long work = aligned ? n / E : n;   // groups, or elements
  long long blocks = (work + kNormThreads - 1) / kNormThreads;
  blocks = blocks < 1 ? 1 : (blocks < kMaxBlocks ? blocks : kMaxBlocks);
  auto* kernel = aligned ? normalize_u8_kernel<Out> : normalize_u8_scalar_kernel<Out>;
  kernel<<<(unsigned)blocks, kNormThreads, 0, stream>>>(static_cast<const uint8_t*>(in),
                                                       static_cast<Out*>(out), n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means the launch was refused. `in` holds n
// bytes of NHWC images with 3 channels, `out` n elements of out_dtype
// (csrc/common.cuh: DType), both contiguous, `out` 16-byte aligned; `scale`
// is the fp32 1/255.
extern "C" int cct_normalize_u8(int out_dtype, const void* in, void* out, long long n,
                                float scale, float m0, float m1, float m2, float s0, float s1,
                                float s2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cct::Consts k{scale, {m0, m1, m2}, {s0, s1, s2}};
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorInvalidValue;
  switch (out_dtype) {
    case cct::kFloat32:
      return cct::run_normalize<float>(in, out, n, k, s);
    case cct::kBFloat16:
      return cct::run_normalize<__nv_bfloat16>(in, out, n, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}
