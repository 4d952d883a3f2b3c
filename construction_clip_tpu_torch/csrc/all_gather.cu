// K10: the data-parallel feature all-gather, as a one-shot pull over CUDA IPC
// that synchronises the ranks on the device.
//
//   out[p * chunk + i] = x_p[i]   for every rank p and byte i < chunk_bytes
//
// Replaces construction_clip_tpu/ops/pallas_collectives.py:ring_all_gather
// (its pl.pallas_call, body _ring_kernel): a ring of n-1 remote DMAs around
// the TPU's ICI, one chunk a step, each DMA paired with a send and a receive
// semaphore inside the kernel. The cards of a Hopper node are joined all to
// all (NVLink through NVSwitch, or one card's own HBM when the ranks share
// it), so a ring would only add n-2 serial hops: here every rank pulls every
// peer's chunk in one launch. The semaphores become flags in device memory.
//
// Each rank owns one cudaMalloc (a tensor of PyTorch's caching allocator is a
// sub-block that an IPC handle cannot name): two slots of `capacity` bytes,
// then a 256-byte signal pad of 32 words: word p is the flag of rank p, the
// generation of the last chunk that p published, written by p; word 31 is the
// put's count of finished blocks. The buffer is zeroed before the ranks
// exchange its IPC handle, and every rank maps every peer's buffer once
// (cudaIpcOpenMemHandle).
//
// A call of generation g (1, 2, ...: every rank calls in the same order, so g
// is the same on every rank) queues on the caller's stream, with no host
// synchronisation:
//   1. put_kernel: x into this rank's slot g % 2; the last of its blocks to
//      finish publishes g in word `me` of every rank's pad (one
//      __threadfence_system, then st.relaxed.sys: a release at system
//      scope). No block of it waits.
//   2. one cuStreamWaitValue64 a peer p on word p of this rank's own pad
//      (>= g): the stream's front end waits, and no SM is held. Ranks that
//      time-slice one card then hand the card over at once, where a spinning
//      block would hold it to the end of its time slice (measured on an H100
//      with 2 and 4 ranks on one card: a whole slice a call, PERF.md).
//   3. gather_kernel: block (t, p) copies tile t of rank p's chunk into rank
//      p's rows of `out`; this rank's own rows come straight from x. For a
//      peer, thread 0 first reads word p with ld.acquire.sys until it reaches
//      g (at once after step 2), polled with __nanosleep backoff, with a
//      deadline of kWaitDeadlineNs on %globaltimer, then __trap().
// This rank's publish of g is complete before its gather starts (stream
// order), so no waiting block can hold an SM that the publish still needs.
// The front end's wait has no deadline of its own: ops/collectives.py
// records an event after step 1 and one after step 3 and, when a call has
// waited past its deadline since the first completed, writes kPoison into
// this rank's flags, which releases step 2 and makes step 3 trap. Either way
// a lost peer fails the process (a launch failure at its next
// synchronisation) instead of hanging it. That needs the host free while the
// stream waits: a module loaded lazily at a kernel's first launch blocks it
// until the wait clears, so the ranks load every module when CUDA starts
// (CUDA_MODULE_LOADING=EAGER, core/mesh.py), and cct_all_gather_load refuses
// to run under lazy loading.
//
// Two slots are enough. A rank q rewrites slot g % 2 at call g + 2 only after
// its own gather of g + 1 has finished (stream order). That gather waited for
// every peer's flag to reach g + 1, and each peer p published g + 1 only after
// its own gather of g, the one read of q's slot g % 2 at generation g, had
// finished. So no rank reads a slot that its owner is rewriting, and a flag
// that reaches g names the data of g in slot g % 2 (a flag is at most one
// generation ahead of a waiting reader, whose slot is the other one).
//
// Bound: bytes. Each rank reads n * chunk_bytes and writes as many; there is
// no arithmetic. At the training path's shapes (a few KB a rank) a call is
// bound by its two launches and, where the ranks are out of step, by the wait.
#include <cuda.h>  // the driver's types for cuStreamWaitValue64 (no -lcuda)

#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace cct {
namespace {

constexpr int kGatherThreads = 256;
constexpr long long kMaxTiles = 1024;
constexpr unsigned long long kWaitDeadlineNs = 10ull * 1000 * 1000 * 1000;   // 10 s
constexpr unsigned kMaxBackoffNs = 1024;
constexpr int kPadWords = 32;   // flags of up to 31 ranks, then the put's count
constexpr unsigned long long kPoison = 1ull << 62;   // a flag no generation reaches

// The widest of 16, 8, 4, 2 and 1 bytes that divides the chunk and x's
// address: every rank's rows start at out + p * chunk_bytes, so a wider unit
// would leave some ranks' destinations misaligned. A slot starts on a
// 256-byte boundary, `out` on a 16-byte one.
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

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// After a fence.sc.sys (__threadfence_system), a release pattern.
__device__ __forceinline__ void store_relaxed_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Polls `flag` until it reaches `generation`; traps at the deadline, or at
// once on kPoison.
__device__ void wait_for(const unsigned long long* flag, unsigned long long generation) {
  const unsigned long long deadline = global_timer_ns() + kWaitDeadlineNs;
  unsigned backoff = 32;
  for (;;) {
    const unsigned long long v = load_acquire_sys(flag);
    if (v >= kPoison) __trap();
    if (v >= generation) return;
    if (global_timer_ns() > deadline) __trap();
    __nanosleep(backoff);
    backoff = backoff < kMaxBackoffNs ? 2 * backoff : kMaxBackoffNs;
  }
}

template <int W>
__global__ void __launch_bounds__(kGatherThreads)
put_kernel(const unsigned long long* __restrict__ bases, long long slot_offset,
           long long pad_offset, const char* __restrict__ x, long long chunk_bytes, int ranks,
           int me, unsigned long long generation) {
  using T = typename Unit<W>::T;
  char* own = reinterpret_cast<char*>(bases[me]);
  const T* src = reinterpret_cast<const T*>(x);
  T* dst = reinterpret_cast<T*>(own + slot_offset);
  const long long units = chunk_bytes / W;
  for (long long i = blockIdx.x * (long long)kGatherThreads + threadIdx.x; i < units;
       i += (long long)gridDim.x * kGatherThreads) {
    dst[i] = src[i];
  }
  __syncthreads();   // the block's stores, before thread 0's fence
  if (threadIdx.x == 0) {
    // The last block is on this card: a fence at gpu scope orders this
    // block's part before its count; the last block's fence at system scope
    // then orders every part before the flags (one fence for all of them).
    __threadfence();
    auto* count = reinterpret_cast<unsigned long long*>(own + pad_offset) + kPadWords - 1;
    if (atomicAdd(count, 1ull) == gridDim.x - 1) {   // every block's part is written
      *count = 0;   // the next call's put runs after this launch (stream order)
      __threadfence_system();
      for (int r = 0; r < ranks; ++r) {
        store_relaxed_sys(reinterpret_cast<unsigned long long*>(
                              reinterpret_cast<char*>(bases[r]) + pad_offset) + me,
                          generation);
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const unsigned long long* __restrict__ bases, long long slot_offset,
              long long pad_offset, const char* __restrict__ x, char* __restrict__ out,
              long long chunk_bytes, int me, unsigned long long generation) {
  using T = typename Unit<W>::T;
  const int p = blockIdx.y;
  T* dst = reinterpret_cast<T*>(out + p * chunk_bytes);
  const long long units = chunk_bytes / W;
  const long long first = blockIdx.x * (long long)kGatherThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kGatherThreads;
  if (p == me) {
    const T* src = reinterpret_cast<const T*>(x);
    for (long long i = first; i < units; i += stride) dst[i] = src[i];
    return;
  }
  if (threadIdx.x == 0) {
    const char* own = reinterpret_cast<const char*>(bases[me]);
    wait_for(reinterpret_cast<const unsigned long long*>(own + pad_offset) + p, generation);
  }
  __syncthreads();   // thread 0's acquire, before every thread's reads
  const T* src = reinterpret_cast<const T*>(reinterpret_cast<const char*>(bases[p]) + slot_offset);
  for (long long i = first; i < units; i += stride) dst[i] = __ldcg(src + i);
}

using StreamValue64Fn = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t, unsigned int);
using LoadingModeFn = CUresult (*)(CUmoduleLoadingMode*);

// An entry of the driver the runtime has loaded; null where the driver
// lacks it.
void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                                           &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? p : nullptr;
}

StreamValue64Fn wait_value64() {
  static const auto fn = reinterpret_cast<StreamValue64Fn>(driver_entry("cuStreamWaitValue64"));
  return fn;
}

StreamValue64Fn write_value64() {
  static const auto fn = reinterpret_cast<StreamValue64Fn>(driver_entry("cuStreamWriteValue64"));
  return fn;
}

template <int W>
cudaError_t load_kernels() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, put_kernel<W>);
  return err == cudaSuccess ? cudaFuncGetAttributes(&attr, gather_kernel<W>) : err;
}

// Step 2 and 3 of a call: a wait on the stream's front end for every peer's
// flag, then the gather.
template <int W>
cudaError_t gather(const unsigned long long* bases, const unsigned long long* host_bases,
                   long long slot_offset, long long pad_offset, const void* x, void* out,
                   long long chunk_bytes, int ranks, int me, unsigned long long generation,
                   long long tiles, cudaStream_t stream) {
  const StreamValue64Fn wait = wait_value64();
  if (wait == nullptr) return cudaErrorNotSupported;
  const CUdeviceptr flags = (CUdeviceptr)(host_bases[me] + pad_offset);
  for (int p = 0; p < ranks; ++p) {
    if (p != me && wait(reinterpret_cast<CUstream>(stream), flags + 8 * p, generation,
                        CU_STREAM_WAIT_VALUE_GEQ) != CUDA_SUCCESS) {
      return cudaErrorUnknown;
    }
  }
  gather_kernel<W><<<dim3((unsigned)tiles, (unsigned)ranks), kGatherThreads, 0, stream>>>(
      bases, slot_offset, pad_offset, static_cast<const char*>(x), static_cast<char*>(out),
      chunk_bytes, me, generation);
  return cudaGetLastError();
}

bool bad_call(long long slot_offset, long long pad_offset, long long chunk_bytes, int ranks,
              int me, unsigned long long generation) {
  return ranks <= 0 || ranks >= kPadWords || me < 0 || me >= ranks || chunk_bytes < 0 ||
         generation == 0 || generation >= kPoison || slot_offset % 256 != 0 ||
         pad_offset % 256 != 0 || slot_offset + chunk_bytes > pad_offset;
}

// The widest unit that divides the chunk and x's address, and the grid's
// tiles for it.
int unit_bytes(const void* x, long long chunk_bytes) {
  const uintptr_t a = static_cast<uintptr_t>(chunk_bytes) | reinterpret_cast<uintptr_t>(x);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : a % 2 == 0 ? 2 : 1;
}

long long tiles_for(long long chunk_bytes, int w) {
  const long long tiles = (chunk_bytes / w + kGatherThreads - 1) / kGatherThreads;
  return tiles < 1 ? 1 : (tiles < kMaxTiles ? tiles : kMaxTiles);
}

}  // namespace
}  // namespace cct

// Every entry returns a cudaError_t (0 is success).

// A staging buffer of `bytes` on the current device, for IPC export, zeroed
// (the signal pad must read 0 before any peer maps it).
extern "C" int cct_peer_alloc(long long bytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return err;
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

// A call of generation `generation` (>= 1) on `stream` is two entries, in
// this order (ops/collectives.py records an event between them, from which
// it measures the wait):
//   cct_all_gather_put: x (chunk_bytes) into this rank's slot, then g into
//     every rank's flag `me` (step 1);
//   cct_all_gather_gather: the front end's waits for the peers' flags, then
//     every rank's chunk into `out` (ranks * chunk_bytes bytes, 16-byte
//     aligned) (steps 2 and 3).
// `bases`: a device array of the ranks' buffer bases (this rank's own at
// `me`), `host_bases` the same addresses in host memory; `slot_offset`: the
// byte offset of slot generation % 2 in each; `pad_offset`: that of the
// signal pad.
extern "C" int cct_all_gather_put(const void* bases, long long slot_offset,
                                  long long pad_offset, const void* x, long long chunk_bytes,
                                  int ranks, int me, unsigned long long generation,
                                  void* stream) {
  if (cct::bad_call(slot_offset, pad_offset, chunk_bytes, ranks, me, generation)) {
    return cudaErrorInvalidValue;
  }
  const int w = cct::unit_bytes(x, chunk_bytes);
  auto* put = w == 16 ? cct::put_kernel<16> : w == 8 ? cct::put_kernel<8>
              : w == 4 ? cct::put_kernel<4> : w == 2 ? cct::put_kernel<2> : cct::put_kernel<1>;
  put<<<(unsigned)cct::tiles_for(chunk_bytes, w), cct::kGatherThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(static_cast<const unsigned long long*>(bases),
                                             slot_offset, pad_offset,
                                             static_cast<const char*>(x), chunk_bytes, ranks,
                                             me, generation);
  return cudaGetLastError();
}

extern "C" int cct_all_gather_gather(const void* bases, const unsigned long long* host_bases,
                                     long long slot_offset, long long pad_offset,
                                     const void* x, void* out, long long chunk_bytes, int ranks,
                                     int me, unsigned long long generation, void* stream) {
  if (cct::bad_call(slot_offset, pad_offset, chunk_bytes, ranks, me, generation) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int w = cct::unit_bytes(x, chunk_bytes);
  auto* gather = w == 16 ? cct::gather<16> : w == 8 ? cct::gather<8> : w == 4 ? cct::gather<4>
                 : w == 2 ? cct::gather<2> : cct::gather<1>;
  return gather(static_cast<const unsigned long long*>(bases), host_bases, slot_offset,
                pad_offset, x, out, chunk_bytes, ranks, me, generation,
                cct::tiles_for(chunk_bytes, w), static_cast<cudaStream_t>(stream));
}

// Loads every kernel of this file and finds the driver's stream-memory
// entries, so that no later call loads a module lazily; `*eager` is 1 where
// the process loads every module when CUDA starts (CUDA_MODULE_LOADING=EAGER),
// else 0. A module loaded lazily, of this file or of any kernel the caller
// launches behind a call, while this rank's stream waits on its front end,
// blocks the host until the wait clears, and with it the poison that would
// clear it.
extern "C" int cct_all_gather_load(int* eager) {
  const auto mode_of = reinterpret_cast<cct::LoadingModeFn>(
      cct::driver_entry("cuModuleGetLoadingMode"));
  CUmoduleLoadingMode mode{};
  if (cct::wait_value64() == nullptr || cct::write_value64() == nullptr || mode_of == nullptr ||
      mode_of(&mode) != CUDA_SUCCESS) {
    return cudaErrorNotSupported;
  }
  *eager = mode == CU_MODULE_EAGER_LOADING;
  for (cudaError_t err : {cct::load_kernels<16>(), cct::load_kernels<8>(), cct::load_kernels<4>(),
                          cct::load_kernels<2>(), cct::load_kernels<1>()}) {
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Fails this rank's pending and later calls: kPoison into its flags of the
// `ranks` ranks but `me` (its pad at `pad`) by cuStreamWriteValue64 on
// `stream`, which must not wait behind the calls' stream (a non-blocking
// stream). The front end's waits then pass and the gather's blocks trap.
extern "C" int cct_all_gather_poison(void* pad, int ranks, int me, void* stream) {
  const cct::StreamValue64Fn write = cct::write_value64();
  if (ranks <= 0 || ranks >= cct::kPadWords || write == nullptr) return cudaErrorInvalidValue;
  for (int p = 0; p < ranks; ++p) {
    if (p != me && write(static_cast<CUstream>(stream),
                         reinterpret_cast<CUdeviceptr>(pad) + 8 * p, cct::kPoison,
                         CU_STREAM_WRITE_VALUE_DEFAULT) != CUDA_SUCCESS) {
      return cudaErrorUnknown;
    }
  }
  return cudaSuccess;
}
