"""Process layouts (counterpart of construction_clip_tpu/core/mesh.py).

The JAX package runs one SPMD program over a Mesh whose named axes span the
chips. The port runs one process per rank, as `torchrun` starts them, and
meets the other ranks in `torch.distributed` collectives, which take the
place of the JAX package's psum / pmean / all_gather over an axis.

Data parallelism alone: `init_data_parallel` joins the world as one "data"
axis. `DataParallel` records what a rank needs: its rank, the world size,
its device, the process group of the gradients (NCCL across cards; gloo on
the CPU and for ranks that share one card, where NCCL refuses), a gloo
group for barriers and handle exchange, and, on a CUDA device, the staging
buffers of the feature all-gather (ops/collectives.py, K10). Each rank
holds the whole model on its own device and takes its own rows of the
global batch (`shard_batch`).

Several axes: `create_mesh` lays the world out as JAX's `create_mesh` lays
out its devices, rank r at `np.unravel_index(r, sizes)` (the row-major
reshape of the device list), and holds, for every axis, the process group
of each line of ranks along it. `Mesh.axis(name)` is a `DataParallel` view
of this rank's line: its rank and world are the line's, its groups the
line's, so that parallel/infonce.py, train/grads.py and `shard_batch` run
over the "data" line unchanged, and on a CUDA device the data view's K10
buffers join that line alone. The tensor-, pipeline- and expert-parallel
modules (parallel/sharding.py, pipeline.py, expert.py) run over the
"model", "pipe" and "expert" lines.

`spawn_ranks` starts `world` processes on one machine, each with a
DataParallel or, given axis sizes, a Mesh, and collects what each returns:
the tests and the one-card rehearsal of chip_smoke.py run parallel code
through it. A real job is started by `torchrun`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
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


def resolve_axis_sizes(axis_sizes: Mapping[str, int] | None, world: int) -> dict:
    """JAX's create_mesh rules over `world` ranks: no sizes put every rank on
    "data" (with "model" of size 1); one size may be -1, inferred."""
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: world, MODEL_AXIS: 1}
    names, sizes = list(axis_sizes.keys()), list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if world % known:
            raise ValueError(f"cannot infer axis: {world} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = world // known
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {world} ranks")
    return dict(zip(names, sizes))


def axis_lines(shape: Mapping[str, int], name: str) -> list:
    """Every line of ranks along axis `name` of a mesh of `shape`, in a fixed
    order, each line's global ranks by their coordinate on the axis (rank r
    sits at np.unravel_index(r, sizes))."""
    sizes = tuple(shape.values())
    ranks = np.arange(math.prod(sizes)).reshape(sizes)
    along = np.moveaxis(ranks, list(shape).index(name), -1)
    return [[int(r) for r in line] for line in along.reshape(-1, shape[name])]


@dataclasses.dataclass
class Mesh:
    """This rank's place in a named process mesh (create_mesh)."""
    shape: dict              # axis name -> size, in the mesh's order (JAX's mesh.shape)
    rank: int                # in the world
    world: int
    device: torch.device
    coords: dict             # axis name -> this rank's coordinate
    lines: dict              # axis name -> DataParallel view of this rank's line
    line_ranks: dict         # axis name -> the global ranks of this rank's line
    cpu_group: Any           # gloo over the world
    owns_world: bool         # create_mesh joined the world (and close leaves it)

    def axis(self, name: str) -> DataParallel:
        """The DataParallel view of this rank's line along `name`."""
        if name not in self.lines:
            raise KeyError(f"the mesh has no axis {name!r}; its axes are {list(self.shape)}")
        return self.lines[name]

    def size(self, name: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have (JAX's
        mesh.shape.get(name, 1))."""
        return self.shape.get(name, 1)

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)

    def close(self) -> None:
        """Closes the data line's gather buffers, meets every rank at a
        barrier and, where create_mesh joined the world, leaves it (see
        DataParallel.close). Collective."""
        for view in self.lines.values():
            if view.peers is not None:
                view.peers.close()
                view.peers = None
        if dist.is_initialized():
            self.barrier()
            if self.owns_world:
                dist.destroy_process_group()


def create_mesh(axis_sizes: Mapping[str, int] | None = None, *, rank: int | None = None,
                world: int | None = None, device=None, backend: str | None = None,
                init_method: str = "env://") -> Mesh:
    """This rank's Mesh over the world, laid out as the JAX package's
    create_mesh lays out its devices (axis order and -1 inference as there).
    Joins the process group as init_data_parallel does (rank, world size and
    device from the arguments or `torchrun`'s environment; `backend` that of
    the lines' groups: NCCL for a CUDA device unless asked otherwise, gloo on
    the CPU; ranks that share one card must ask for gloo), or, where the
    world is already joined, lays a further mesh over it.

    Collective: every rank calls it with the same sizes. For every axis it
    creates the groups of every line along it, on every rank in the same
    order (torch.distributed wants every rank in each `new_group` call, also
    the ranks outside the group), each with a gloo group of the same line
    for barriers and handle exchange. On a CUDA device the "data" line's
    view gets K10's buffers."""
    owns = not dist.is_initialized()
    if owns:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world = int(os.environ["WORLD_SIZE"]) if world is None else world
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
    shape = resolve_axis_sizes(axis_sizes, world)
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        eager_module_loading()
        torch.cuda.set_device(device)
    if owns:
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    else:
        backend = backend or dist.get_backend()
    cpu_group = dist.group.WORLD if dist.get_backend() == "gloo" else \
        dist.new_group(backend="gloo")
    coords = dict(zip(shape, (int(c) for c in np.unravel_index(rank, tuple(shape.values())))))
    lines, line_ranks = {}, {}
    for name in shape:
        for members in axis_lines(shape, name):
            group = dist.new_group(members, backend=backend)
            gloo = group if backend == "gloo" else dist.new_group(members, backend="gloo")
            if rank in members:
                line_ranks[name] = tuple(members)
                lines[name] = DataParallel(rank=coords[name], world=len(members),
                                           device=device, group=group, cpu_group=gloo)
    mesh = Mesh(shape=shape, rank=rank, world=world, device=device, coords=coords,
                lines=lines, line_ranks=line_ranks, cpu_group=cpu_group, owns_world=owns)
    data = lines.get(DATA_AXIS)
    if device.type == "cuda" and data is not None and data.world > 1:
        from construction_clip_tpu_torch.ops.collectives import PeerBuffers

        data.peers = PeerBuffers(data, GATHER_CAPACITY)
    return mesh


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


def _rank_main(payload, rank, world, init_method, device, results, axes):
    torch.set_num_threads(1)
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)   # written by spawn_ranks
        if axes is None:
            dp = init_data_parallel(rank=rank, world=world, device=device, backend="gloo",
                                    init_method=init_method)
        else:
            dp = create_mesh(axes, rank=rank, world=world, device=device, backend="gloo",
                             init_method=init_method)
        out = fn(dp, *args)
        dp.close()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))   # the parent raises it
        raise


def spawn_ranks(fn: Callable, world: int, args: tuple = (), *, device,
                timeout: float = 60.0, axes: Mapping[str, int] | None = None) -> list:
    """Runs `fn(dp, *args)` in `world` spawned processes on `device`, which the
    caller names ("cuda:0" or "cpu"; all ranks on the same one, so every group
    is gloo: NCCL refuses two ranks on one card) and returns their results by
    rank. `dp` is the rank's DataParallel, or, given the mesh's axis sizes
    `axes`, its Mesh (create_mesh). `fn` and its results must
    pickle, and `fn`'s module must import without side effects.
    A rank's exception, a rank that dies, or `timeout` seconds without every
    result stops every rank and raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cct_rdzv_")
    # the function and its arguments go through a file: a spawned process reads
    # what it is started with only after importing the parent's main module, so
    # arguments larger than a pipe's buffer would start the ranks one at a time
    payload = os.path.join(tmp, "args.pkl")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(payload, r, world, f"file://{tmp}/rdzv", str(device), results,
                               None if axes is None else dict(axes)))
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
