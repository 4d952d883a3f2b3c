"""The data-parallel feature all-gather (counterpart of
construction_clip_tpu/ops/pallas_collectives.py: ring_all_gather).

Every rank holds x [chunk, D]; every rank gets [world * chunk, D], rank p's
rows at p * chunk (JAX's tiled all_gather over the "data" axis).

`all_gather` launches csrc/all_gather.cu (K10) on CUDA tensors and runs
`all_gather_plain` on CPU tensors. K10 is a one-shot pull over CUDA IPC:
`PeerBuffers` gives every rank a two-slot staging buffer of its own and maps
every peer's; a call copies x into this rank's slot, meets the others at a
gloo barrier, and one launch copies every rank's slot into its rows of the
output. Ranks on different cards read each other's HBM over NVLink; ranks
that share one card (chip_smoke.py's rehearsal) read the same card's HBM.

`all_gather_plain` is `dist.all_gather` on the gloo group and `torch.cat`;
gloo gathers host tensors only, so a CUDA tensor goes through the host.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from construction_clip_tpu_torch.ops import _build

_SLOT_ALIGN = 256


class PeerBuffers:
    """K10's staging buffers: two slots of `capacity_bytes` in a cudaMalloc
    of this rank's (a tensor of PyTorch's caching allocator is a sub-block
    of a larger one, which an IPC handle cannot name), its IPC handle
    exchanged with every rank over `dp.cpu_group`, and every peer's buffer
    mapped here. A rank's own handle is not opened (the runtime refuses a
    handle of the same process): it uses its own pointer. Collective: every
    rank of `dp` constructs it, and closes it, at the same point."""

    def __init__(self, dp, capacity_bytes: int):
        self.dp = dp
        self.capacity = -(-int(capacity_bytes) // _SLOT_ALIGN) * _SLOT_ALIGN
        self.calls = 0
        self._own = None
        self._opened: list[int] = []
        lib = _build.load_library()
        with torch.cuda.device(dp.device):
            ptr = ctypes.c_void_p()
            _build.check(lib.cct_peer_alloc(2 * self.capacity, ctypes.byref(ptr)),
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
            self.slots = torch.tensor(bases, dtype=torch.int64, device=dp.device)

    def slot(self, parity: int) -> int:
        """The address of this rank's slot `parity`."""
        return self._own + parity * self.capacity

    def close(self) -> None:
        """Unmaps the peers' buffers once every rank has finished reading,
        and frees this rank's once every rank has unmapped it."""
        if self._own is None:
            return
        lib = _build.load_library()
        with torch.cuda.device(self.dp.device):
            torch.cuda.synchronize(self.dp.device)
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
    p * chunk. Collective: every rank calls it with the same shape. On the
    card, through `peers` (dp.peers when None); a chunk larger than a slot
    is an error."""
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
    parity = peers.calls % 2
    peers.calls += 1
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib.cct_peer_put(peers.slot(parity), x.data_ptr(), chunk_bytes, stream),
                     "all_gather: copy into the slot")
        torch.cuda.synchronize(x.device)   # the slot is written before any peer reads it
        dp.barrier()
        err = lib.cct_all_gather(peers.slots.data_ptr(), parity * peers.capacity,
                                 out.data_ptr(), chunk_bytes, dp.world, stream)
    _build.check(err, "all_gather")
    all_gather.launches += 1
    return out


all_gather.launches = 0   # K10
