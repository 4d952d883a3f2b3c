"""Data-parallel process layout (counterpart of construction_clip_tpu/core/mesh.py).

The JAX package runs one SPMD program over a Mesh whose "data" axis spans
the chips. The port runs one process per rank, as `torchrun` starts them: each
holds the whole model on its own device, takes its own rows of the global
batch (`shard_batch`), and meets the other ranks in `torch.distributed`
collectives, which take the place of the JAX package's psum / pmean /
all_gather over the axis. Only the "data" axis is ported.

`DataParallel` records what a rank needs: its rank, the world size, its
device, the process group of the gradients (NCCL across cards; gloo on the
CPU and for ranks that share one card, where NCCL refuses), a gloo group for
barriers and handle exchange, and, on a CUDA device, the staging buffers of
the feature all-gather (ops/collectives.py, K10).

`spawn_ranks` starts `world` such processes on one machine and collects
what each returns: the tests and the one-card rehearsal of chip_smoke.py run
data-parallel code through it. A real job is started by `torchrun`.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

DATA_AXIS = "data"
GATHER_CAPACITY = 4 << 20   # bytes a rank may gather in one call (K10's slot)


@dataclasses.dataclass
class DataParallel:
    rank: int
    world: int
    device: torch.device
    group: Any               # gradients and the InfoNCE backward
    cpu_group: Any           # gloo: barriers, IPC handles, the plain gather
    peers: Any = None        # ops.collectives.PeerBuffers on a CUDA device

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)

    def close(self) -> None:
        """Closes the gather's buffers (behind a barrier), then meets every
        rank at a barrier and closes the process group. Collective. Without
        the barrier a rank that finished first would tear its connections
        down while a peer may still be inside gloo's full-mesh handshake of
        the group's construction, and that peer fails with "connection closed
        by peer"."""
        if self.peers is not None:
            self.peers.close()
            self.peers = None
        if dist.is_initialized():
            self.barrier()
            dist.destroy_process_group()


def eager_module_loading() -> None:
    """Has CUDA load every module when it starts (CUDA_MODULE_LOADING=EAGER),
    as K10's deadline needs: a kernel loaded lazily at its first launch, behind
    a gather whose stream waits for a peer, blocks the host until the wait
    clears, and with it the watchdog that fails a lost peer's call
    (ops/collectives.py). Takes effect only before the process's first CUDA
    call; `PeerBuffers` checks the mode CUDA started in."""
    os.environ["CUDA_MODULE_LOADING"] = "EAGER"


def init_data_parallel(*, rank: int | None = None, world: int | None = None, device=None,
                       backend: str | None = None, init_method: str = "env://") -> DataParallel:
    """Joins the process group. Rank, world size and device come from the
    arguments or from `torchrun`'s environment (RANK, WORLD_SIZE, and
    cuda:LOCAL_RANK). `backend` is that of the gradients' group: NCCL for a
    CUDA device unless asked otherwise, gloo on the CPU; ranks that share one
    card must ask for gloo."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        eager_module_loading()
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    cpu_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    dp = DataParallel(rank=rank, world=world, device=device, group=dist.group.WORLD,
                      cpu_group=cpu_group)
    if device.type == "cuda":
        from construction_clip_tpu_torch.ops.collectives import PeerBuffers

        dp.peers = PeerBuffers(dp, GATHER_CAPACITY)
    return dp


def shard_batch(dp: DataParallel, batch: dict) -> dict:
    """This rank's rows of a global batch (a dict of arrays or tensors with
    the batch first): the rank-th of `world` equal blocks."""
    def rows(x):
        if x.shape[0] % dp.world:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over {dp.world} ranks")
        n = x.shape[0] // dp.world
        return x[dp.rank * n:(dp.rank + 1) * n]

    return {k: rows(v) for k, v in batch.items()}


def replicate(dp: DataParallel, tree):
    """Rank 0's values in every rank's tensors of `tree` (a nested dict or a
    ParamTree), in place; returns `tree`."""
    from construction_clip_tpu_torch.core.params import as_tree, tree_leaves

    with torch.no_grad():
        for leaf in tree_leaves(as_tree(tree)):
            dist.broadcast(leaf, src=0, group=dp.group)
    return tree


def _rank_main(fn, rank, world, init_method, device, args, results):
    torch.set_num_threads(1)
    try:
        dp = init_data_parallel(rank=rank, world=world, device=device, backend="gloo",
                                init_method=init_method)
        out = fn(dp, *args)
        dp.close()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))   # the parent raises it
        raise


def spawn_ranks(fn: Callable, world: int, args: tuple = (), *, device,
                timeout: float = 60.0) -> list:
    """Runs `fn(dp, *args)` in `world` spawned processes on `device`, which the
    caller names ("cuda:0" or "cpu"; all ranks on the same one, so every group
    is gloo: NCCL refuses two ranks on one card) and returns their results by
    rank. `fn` and its results must
    pickle, and `fn`'s module must import without side effects.
    A rank's exception, a rank that dies, or `timeout` seconds without every
    result stops every rank and raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cct_rdzv_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, f"file://{tmp}/rdzv", str(device), args, results))
             for r in range(world)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks: no result from "
                                       f"{sorted(set(range(world)) - set(out))} in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
