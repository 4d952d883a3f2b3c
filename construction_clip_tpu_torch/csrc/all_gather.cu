// K10: the data-parallel feature all-gather, as a one-shot pull over CUDA IPC.
//
//   out[p * chunk + i] = x_p[i]   for every rank p and byte i < chunk_bytes
//
// Replaces construction_clip_tpu/ops/pallas_collectives.py:ring_all_gather
// (its pl.pallas_call, body _ring_kernel): a ring of n-1 remote DMAs around
// the TPU's ICI, one chunk a step. The cards of a Hopper node are joined all
// to all (NVLink through NVSwitch, or one card's own HBM when the ranks share
// it), so a ring would only add n-2 serial hops: here every rank pulls every
// peer's chunk in one launch.
//
// Each rank owns a staging buffer of two slots (its own cudaMalloc: a tensor
// of PyTorch's caching allocator is a sub-block that an IPC handle cannot
// name) and maps every peer's buffer with cudaIpcOpenMemHandle. A call
// (ops/collectives.py: all_gather) copies x into the slot of the call's
// parity, synchronises, meets the other ranks at a host barrier and then
// launches gather_kernel: a grid of (tiles, ranks) in which block (t, p)
// copies rank p's chunk from its slot into rank p's rows of `out`. Two slots
// make one barrier a call enough: a peer rewrites a slot only after the next
// call's barrier, which this rank reaches only once its read has finished.
//
// Bound: bytes. Each rank reads n * chunk_bytes and writes as many; there is
// no arithmetic. At the training path's shapes (a few KB a rank) the call is
// bound by its launch and the barrier, not by the copy.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace cct {
namespace {

constexpr int kGatherThreads = 256;
constexpr long long kMaxTiles = 1024;

// The widest of 16, 8, 4, 2 and 1 bytes that divides the chunk: every rank's
// rows start at out + p * chunk_bytes, so a wider unit would leave some
// ranks' destinations misaligned. A slot starts on a 256-byte boundary.
template <int W>
struct Unit;
template <>
struct Unit<16> { using T = int4; };
template <>
struct Unit<8> { using T = int2; };
template <>
struct Unit<4> { using T = int; };
template <>
struct Unit<2> { using T = short; };
template <>
struct Unit<1> { using T = char; };

template <int W>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const unsigned long long* __restrict__ slots, long long slot_offset,
              char* __restrict__ out, long long chunk_bytes) {
  using T = typename Unit<W>::T;
  const int p = blockIdx.y;
  const T* src = reinterpret_cast<const T*>(
      reinterpret_cast<const char*>(slots[p]) + slot_offset);
  T* dst = reinterpret_cast<T*>(out + p * chunk_bytes);
  const long long units = chunk_bytes / W;
  for (long long i = blockIdx.x * (long long)kGatherThreads + threadIdx.x; i < units;
       i += (long long)gridDim.x * kGatherThreads) {
    dst[i] = src[i];
  }
}

template <int W>
cudaError_t launch_gather(const unsigned long long* slots, long long slot_offset, void* out,
                          long long chunk_bytes, int ranks, cudaStream_t stream) {
  const long long units = chunk_bytes / W;
  long long tiles = (units + kGatherThreads - 1) / kGatherThreads;
  tiles = tiles < kMaxTiles ? tiles : kMaxTiles;
  gather_kernel<W><<<dim3((unsigned)tiles, (unsigned)ranks), kGatherThreads, 0, stream>>>(
      slots, slot_offset, static_cast<char*>(out), chunk_bytes);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cct

// Every entry returns a cudaError_t (0 is success).

// A staging buffer of `bytes` on the current device, for IPC export.
extern "C" int cct_peer_alloc(long long bytes, void** ptr) {
  return cudaMalloc(ptr, (size_t)bytes);
}

extern "C" int cct_peer_free(void* ptr) { return cudaFree(ptr); }

// The 64-byte IPC handle of a cct_peer_alloc buffer, into `handle`.
extern "C" int cct_peer_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return err;
}

// Maps a peer's buffer from its 64-byte handle (a handle of this process is
// refused by the runtime: a rank uses its own pointer instead).
extern "C" int cct_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int cct_peer_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

// This rank's chunk into its slot, on `stream`.
extern "C" int cct_peer_put(void* slot, const void* src, long long bytes, void* stream) {
  if (bytes <= 0) return cudaSuccess;
  return cudaMemcpyAsync(slot, src, (size_t)bytes, cudaMemcpyDeviceToDevice,
                         static_cast<cudaStream_t>(stream));
}

// `slots`: a device array of the ranks' buffer bases; `slot_offset`: the byte
// offset of this call's slot in each; `out`: ranks * chunk_bytes bytes,
// 16-byte aligned.
extern "C" int cct_all_gather(const void* slots, long long slot_offset, void* out,
                              long long chunk_bytes, int ranks, void* stream) {
  if (ranks <= 0 || ranks > 65535 || chunk_bytes < 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || slot_offset % 256 != 0) {
    return cudaErrorInvalidValue;
  }
  if (chunk_bytes == 0) return cudaSuccess;
  const auto* s = static_cast<const unsigned long long*>(slots);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk_bytes % 16 == 0) return cct::launch_gather<16>(s, slot_offset, out, chunk_bytes, ranks, st);
  if (chunk_bytes % 8 == 0) return cct::launch_gather<8>(s, slot_offset, out, chunk_bytes, ranks, st);
  if (chunk_bytes % 4 == 0) return cct::launch_gather<4>(s, slot_offset, out, chunk_bytes, ranks, st);
  if (chunk_bytes % 2 == 0) return cct::launch_gather<2>(s, slot_offset, out, chunk_bytes, ranks, st);
  return cct::launch_gather<1>(s, slot_offset, out, chunk_bytes, ranks, st);
}
