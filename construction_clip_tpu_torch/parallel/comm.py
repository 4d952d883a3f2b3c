"""Point-to-point transfers over one line of a mesh (core/mesh.Mesh.axis: a
DataParallel view whose rank and world are the line's), for the pipeline's
stages. The other collectives of the parallel modules call torch.distributed
on the line's group directly.

Across cards the lines' groups are NCCL, which takes CUDA tensors in every
collective. Ranks that share one card (chip_smoke.py's rehearsal) and the
CPU use gloo. On an H100 with torch 2.11, gloo's all_reduce (fp32 and
bf16), broadcast, all_gather and all_to_all_single take CUDA tensors, and
its send and recv do not: a CUDA send fails in gloo's socket write ("Bad
address") and takes the process down. So `send` and `recv`, for gloo
alone, copy a CUDA tensor through pinned host memory. That is a transport,
not a fallback: the compute stays on the card, and nothing is retried on
another path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def global_rank(line, rank: int) -> int:
    """The world rank of the line's rank `rank`."""
    return dist.get_global_rank(line.group, rank)


def _p2p_via_host(device, line) -> bool:
    return device.type == "cuda" and dist.get_backend(line.group) == "gloo"


def send(x, dst: int, line, tag: int = 0) -> None:
    """Sends x to the line's rank `dst`."""
    x = x.contiguous()
    if _p2p_via_host(x.device, line):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        x = host.copy_(x)
    dist.send(x, global_rank(line, dst), group=line.group, tag=tag)


def recv(shape, dtype, device, src: int, line, tag: int = 0):
    """Receives a tensor of `shape` and `dtype` from the line's rank `src`,
    onto `device`."""
    device = torch.device(device)
    if _p2p_via_host(device, line):
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(host, global_rank(line, src), group=line.group, tag=tag)
        return host.to(device)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, global_rank(line, src), group=line.group, tag=tag)
    return out
