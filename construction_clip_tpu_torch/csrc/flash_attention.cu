// K4 and K5: attention over [B, H, T, dh] without a [T, T] panel in device
// memory, forward and backward.
//
// K4 replaces construction_clip_tpu/ops/pallas_attention.py:_attn_kernel
// (launched by _forward's pl.pallas_call): o = softmax(q k^T scale, causal) v,
// with p = exp(s - m) rounded to the input type for p . v and the sum
// normalised by the fp32 row sum of p afterwards. Here the keys stream through
// shared memory in 64-row tiles with an online softmax (m and l carried across
// tiles, the partial sum rescaled), so a block's shared memory is the same at
// T = 50 and T = 1024.
//
// K5 replaces pallas_attention.py:_bwd_kernel (launched by _bwd_pallas's
// pl.pallas_call): p recomputed from q and k in fp32, then dv = p^T dO,
// dp = dO v^T, ds = p (dp - rowsum(dp p)) scale, dq = ds k, dk = ds^T q, all
// in fp32 and rounded once at the output. Three launches: per-row statistics
// (m, l and D = rowsum(dp p) = dO . o), then dq over key tiles, then dk and dv
// over query tiles (attention_tiles.cuh); the [T, T] panels stay in registers,
// as the Pallas kernel keeps them in VMEM.
//
// What bounds them on the H100: 4 T^2 dh FLOPs forward and 10 T^2 dh
// backward per head against 4 T dh (7 T dh) values moved, so at T = 257 they
// are compute-bound; this first version runs the products on the CUDA cores
// in fp32 FMA, not on the tensor cores.
#include "attention_tiles.cuh"
#include "common.cuh"

namespace cct {
namespace {

AttnArgs bhtd_args(const void* q, const void* k, const void* v, int h, int t, int dh,
                   int causal, float scale) {
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.in = HeadView{(long long)h * t * dh, (long long)t * dh, dh};
  a.dov = a.ov = a.o2v = a.in;
  a.n_heads = h;
  a.t_len = t;
  a.dh = dh;
  a.causal = causal;
  a.scale = scale;
  return a;
}

#define CCT_TRY(expr)                      \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

template <typename T>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, int b, int h, int t,
                    int dh, int causal, float scale, cudaStream_t stream) {
  if (b <= 0) return cudaErrorInvalidValue;
  AttnArgs a = bhtd_args(q, k, v, h, t, dh, causal, scale);
  a.out = o;
  return launch_tiles(attn_rows<T, kFwd, false>, a, b, stream);
}

template <typename T>
cudaError_t run_bwd(const void* q, const void* k, const void* v, const void* g, float* work,
                    void* dq, void* dk, void* dv, int b, int h, int t, int dh, int causal,
                    float scale, cudaStream_t stream) {
  if (b <= 0) return cudaErrorInvalidValue;
  AttnArgs a = bhtd_args(q, k, v, h, t, dh, causal, scale);
  const size_t n = (size_t)b * h * t;
  a.dout = g;
  a.m = work;
  a.l = work + n;
  a.dsum = work + 2 * n;
  CCT_TRY(launch_tiles(attn_rows<T, kStats, false>, a, b, stream));
  a.out = dq;
  CCT_TRY(launch_tiles(attn_rows<T, kDq, false>, a, b, stream));
  a.out = dk;
  a.out2 = dv;
  return launch_tiles(attn_cols<T, false>, a, b, stream);
}

}  // namespace
}  // namespace cct

// Returns a cudaError_t; nonzero means a launch was refused. q, k, v, o are
// contiguous [B, H, T, dh] of one type.
extern "C" int cct_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                       void* o, int b, int h, int t, int dh, int causal,
                                       float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_fwd<float>(q, k, v, o, b, h, t, dh, causal, scale, s);
    case cct::kBFloat16:
      return cct::run_fwd<__nv_bfloat16>(q, k, v, o, b, h, t, dh, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// work: fp32 scratch of 3 * B * H * T elements (per-row m, l, D).
extern "C" int cct_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* g, void* work, void* dq, void* dk, void* dv,
                                       int b, int h, int t, int dh, int causal, float scale,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  switch (dtype) {
    case cct::kFloat32:
      return cct::run_bwd<float>(q, k, v, g, w, dq, dk, dv, b, h, t, dh, causal, scale, s);
    case cct::kBFloat16:
      return cct::run_bwd<__nv_bfloat16>(q, k, v, g, w, dq, dk, dv, b, h, t, dh, causal,
                                         scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
