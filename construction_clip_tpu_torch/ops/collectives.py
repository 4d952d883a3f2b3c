"""The data-parallel feature all-gather (counterpart of
construction_clip_tpu/ops/pallas_collectives.py: ring_all_gather).

Every rank holds x [chunk, D]; every rank gets [world * chunk, D], rank p's
rows at p * chunk (JAX's tiled all_gather over the "data" axis).

`all_gather` launches csrc/all_gather.cu (K10) on CUDA tensors and runs
`all_gather_plain` on CPU tensors. K10 is a one-shot pull over CUDA IPC that
synchronises the ranks on the device: `PeerBuffers` gives every rank a
two-slot staging buffer and a pad of flags of its own and maps every peer's;
a call of generation g copies x into this rank's slot g % 2 and publishes g
in every rank's flag of this rank; the stream then waits (on its front end)
for every peer's flag in this rank's pad to reach g, and one launch copies
every rank's slot into its rows of the output. A call only queues work on the
current stream: it neither synchronises nor meets a host barrier. Ranks on
different cards read each other's HBM over NVLink; ranks that share one card
(chip_smoke.py's rehearsal) read the same card's HBM.

The front end's wait has no deadline of its own, so `WaitWatchdog` gives it
one: a thread that watches every call's events and, when a call has waited
longer than WAIT_DEADLINE_S since its put completed, poisons this rank's
flags, so that the gather's blocks trap and the process fails at its next
synchronisation. Every rank must therefore reach each call within
WAIT_DEADLINE_S of its peers. The thread can only act while the host is
free: the ranks load every CUDA module when CUDA starts
(CUDA_MODULE_LOADING=EAGER, set by core/mesh.py), since a module loaded
lazily while the stream waits blocks the host until the wait clears, and
`PeerBuffers` refuses to run under lazy loading.

`all_gather_plain` is `dist.all_gather` on the gloo group and `torch.cat`;
gloo gathers host tensors only, so a CUDA tensor goes through the host.
"""

from __future__ import annotations

import collections
import ctypes
import sys
import threading
import time

import torch
import torch.distributed as dist

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build

_SLOT_ALIGN = 256
_PAD_BYTES = 256    # the signal pad: a flag of each rank, the put's count of blocks
MAX_RANKS = 31      # flags in the pad
WAIT_DEADLINE_S = 10.0   # as the gather's own wait (csrc/all_gather.cu)


class WaitWatchdog:
    """Fails a rank whose gather waits too long: a daemon thread looks at the
    calls' events (`watch`: the event after its put, the event after its
    gather), oldest call first, every `poll_s`; when the oldest pending call
    has waited `deadline_s` since its put completed (a peer that never
    publishes, or one that is that far behind), it calls `fail` once and
    stops. Work queued on the stream before a call does not count."""

    def __init__(self, fail, deadline_s: float = WAIT_DEADLINE_S, poll_s: float = 0.25):
        self.fail, self.deadline_s, self.poll_s = fail, deadline_s, poll_s
        self.pending: collections.deque = collections.deque()
        self.fired = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="k10-watchdog", daemon=True)
        self._thread.start()

    def watch(self, put_done, done) -> None:
        self.pending.append((put_done, done))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def _run(self) -> None:
        oldest, since = None, None
        while not self._stop.wait(self.poll_s):
            while self.pending and self.pending[0][1].query():
                self.pending.popleft()
            if not self.pending:
                continue
            if self.pending[0] is not oldest:
                oldest, since = self.pending[0], None
            if since is None:
                if oldest[0].query():
                    since = time.monotonic()
            elif time.monotonic() - since > self.deadline_s:
                self.fired = True
                self.fail()
                return


class PeerBuffers:
    """K10's staging buffers: two slots of `capacity_bytes` and a signal pad
    in a cudaMalloc of this rank's (a tensor of PyTorch's caching allocator
    is a sub-block of a larger one, which an IPC handle cannot name), zeroed,
    its IPC handle exchanged with every rank over `dp.cpu_group`, and every
    peer's buffer mapped here. A rank's own handle is not opened (the runtime
    refuses a handle of the same process): it uses its own pointer. `calls`
    counts this rank's calls, so call g's generation is the same on every
    rank. Collective: every rank of `dp` constructs it, and closes it, at the
    same point."""

    def __init__(self, dp, capacity_bytes: int):
        if dp.world > MAX_RANKS:
            raise ValueError(f"all_gather's pad holds the flags of {MAX_RANKS} ranks, "
                             f"not {dp.world}")
        self.dp = dp
        self.capacity = -(-int(capacity_bytes) // _SLOT_ALIGN) * _SLOT_ALIGN
        self.pad_offset = 2 * self.capacity
        self.calls = 0
        self._own = None
        self._opened: list[int] = []
        lib = _build.load_library()
        with torch.cuda.device(dp.device):
            eager = ctypes.c_int()
            _build.check(lib.cct_all_gather_load(ctypes.byref(eager)),
                         "loading the gather's kernels")
            if not eager.value:
                raise RuntimeError("all_gather needs every CUDA module loaded when CUDA "
                                   "starts: set CUDA_MODULE_LOADING=EAGER before the first "
                                   "CUDA call (init_data_parallel sets it, too late where "
                                   "CUDA has already started)")
            ptr = ctypes.c_void_p()
            _build.check(lib.cct_peer_alloc(self.pad_offset + _PAD_BYTES, ctypes.byref(ptr)),
                         "cudaMalloc of the gather's staging buffer")
            self._own = ptr.value
            handle = ctypes.create_string_buffer(64)
            _build.check(lib.cct_peer_handle(self._own, ctypes.addressof(handle)),
                         "cudaIpcGetMemHandle")
            handles = [None] * dp.world
            dist.all_gather_object(handles, handle.raw, group=dp.cpu_group)
            bases = []
            for rank, raw in enumerate(handles):
                if rank == dp.rank:
                    bases.append(self._own)
                    continue
                buf = ctypes.create_string_buffer(raw, 64)
                peer = ctypes.c_void_p()
                _build.check(lib.cct_peer_open(ctypes.addressof(buf), ctypes.byref(peer)),
                             f"cudaIpcOpenMemHandle of rank {rank}'s buffer")
                self._opened.append(peer.value)
                bases.append(peer.value)
            self.bases = torch.tensor(bases, dtype=torch.int64, device=dp.device)
            self.host_bases = (ctypes.c_ulonglong * dp.world)(*bases)
            self._side = torch.cuda.Stream(dp.device)   # non-blocking: the watchdog's
        self.watchdog = WaitWatchdog(self._poison)

    def _poison(self) -> None:
        """The watchdog's `fail`: kPoison into this rank's flags of its peers,
        on a stream that does not wait behind the calls'."""
        print(f"all_gather: rank {self.dp.rank}: a call has waited more than "
              f"{self.watchdog.deadline_s} s for a peer's flag; failing it", file=sys.stderr,
              flush=True)
        torch.cuda.set_device(self.dp.device)
        _build.check(_build.load_library().cct_all_gather_poison(
            self._own + self.pad_offset, self.dp.world, self.dp.rank, self._side.cuda_stream),
            "all_gather: poisoning the flags")

    def close(self) -> None:
        """Unmaps the peers' buffers once every rank has finished reading,
        and frees this rank's once every rank has unmapped it."""
        if self._own is None:
            return
        lib = _build.load_library()
        with torch.cuda.device(self.dp.device):
            torch.cuda.synchronize(self.dp.device)   # (the watchdog still watching)
            self.watchdog.stop()
            self.dp.barrier()
            for ptr in self._opened:
                _build.check(lib.cct_peer_close(ptr), "cudaIpcCloseMemHandle")
            self.dp.barrier()
            _build.check(lib.cct_peer_free(self._own), "cudaFree of the staging buffer")
        self._own, self._opened = None, []


def _check(x) -> None:
    if x.dim() != 2:
        raise ValueError(f"all_gather takes [chunk, D] rows, got {tuple(x.shape)}")


def all_gather_plain(x, dp):
    """[chunk, D] on every rank -> [world * chunk, D]: `dist.all_gather` on
    the gloo group, through the host for a CUDA tensor."""
    _check(x)
    host = x.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(dp.world)]
    dist.all_gather(parts, host, group=dp.cpu_group)
    return torch.cat(parts).to(x.device)


def all_gather(x, dp, peers: PeerBuffers | None = None):
    """[chunk, D] on every rank -> [world * chunk, D], rank p's rows at
    p * chunk. Collective: every rank calls it with the same shape, in the
    same order. On the card, through `peers` (dp.peers when None); a chunk
    larger than a slot is an error. It queues K10 on the current stream and
    returns: a peer that never makes the call fails this rank's process at
    the wait's deadline (csrc/all_gather.cu)."""
    if _build.on_cpu(x, "all_gather"):
        return all_gather_plain(x, dp)
    _check(x)
    peers = dp.peers if peers is None else peers
    if peers is None:
        raise RuntimeError("all_gather on the card needs the ranks' PeerBuffers "
                           "(init_data_parallel makes them for a CUDA device)")
    x = x.detach().contiguous()
    chunk_bytes = x.numel() * x.element_size()
    if chunk_bytes > peers.capacity:
        raise ValueError(f"all_gather: a chunk of {chunk_bytes} bytes exceeds the "
                         f"{peers.capacity}-byte slot")
    out = torch.empty((dp.world * x.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    peers.calls += 1
    g = peers.calls
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        slot = (g % 2) * peers.capacity
        _build.check(lib.cct_all_gather_put(peers.bases.data_ptr(), slot, peers.pad_offset,
                                            x.data_ptr(), chunk_bytes, dp.world, dp.rank, g,
                                            stream.cuda_stream), "all_gather")
        put_done = stream.record_event()
        _build.check(lib.cct_all_gather_gather(
            peers.bases.data_ptr(), peers.host_bases, slot, peers.pad_offset, x.data_ptr(),
            out.data_ptr(), chunk_bytes, dp.world, dp.rank, g, stream.cuda_stream),
            "all_gather")
        tracing.count("k10")
        peers.watchdog.watch(put_done, stream.record_event())
    return out
