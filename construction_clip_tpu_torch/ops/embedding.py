"""Token lookup whose backward is a hand-written segment sum (csrc/embedding_bwd.cu).

`embedding(table, ids)` is `table[ids]`, a negative id wrapping as the gather
wraps it. On a CUDA table under the "kernel" impl (ops/attention.resolve_impl)
it runs as a `torch.autograd.Function`: the forward is the same gather, bit for
bit, and the backward launches `embedding_backward`, which sorts the ids'
rows (`cct_embedding_keys`, then a stable `torch.sort`), sums the gradient rows
of each id in fp32 and rounds once to the gradient's type. PyTorch's own
backward of the gather, `index_put_(accumulate=True)`, adds a run of equal ids
one row after another, rounding at every add, so its time follows the longest
run: zero padding after EOT puts most of a text batch on id 0. On a CPU table,
or under the "plain" impl, the lookup is `table[ids]` as it stands, and
autograd's own backward runs.

No TPU kernel is replaced: the JAX package's lookup is an XLA gather
(construction_clip_tpu/models/clip/model.py). `embedding_backward_plain` is the
same function in plain PyTorch, its sums in fp64 and rounded once (the sum the
kernel's fp32 sums approach), for the CPU and for the checks on the card.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops.attention import resolve_impl

_GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}   # csrc/common.cuh: DType
_ID_CODES = {torch.int32: 0, torch.int64: 1}
_MAX_INT = 2 ** 31 - 1


def _check(ids, grad, num_rows: int) -> None:
    if ids.dtype not in _ID_CODES:
        raise ValueError(f"embedding_backward takes int32 or int64 ids, not {ids.dtype}")
    if grad.dtype not in _GRAD_CODES:
        raise ValueError(f"embedding_backward takes a float32, bfloat16 or float16 gradient, "
                         f"not {grad.dtype}")
    if grad.dim() != ids.dim() + 1 or grad.shape[:-1] != ids.shape:
        raise ValueError(f"embedding_backward: grad {tuple(grad.shape)} is not ids "
                         f"{tuple(ids.shape)} by a width")
    if grad.shape[-1] % 8 or grad.shape[-1] == 0:
        raise ValueError(f"embedding_backward takes a width that is a multiple of 8, "
                         f"not {grad.shape[-1]}")
    if not 1 <= num_rows < _MAX_INT or ids.numel() > _MAX_INT:
        raise ValueError(f"embedding_backward: {ids.numel()} ids into {num_rows} rows is "
                         f"out of range")


def embedding_backward_plain(ids, grad, num_rows: int):
    """[num_rows, D] in grad's dtype: row v the fp64 sum of grad's rows whose id is
    v (or v - num_rows), rounded once; rows no id names are 0."""
    _check(ids, grad, num_rows)
    d = grad.shape[-1]
    flat = ids.reshape(-1).long()
    out = torch.zeros((num_rows, d), dtype=torch.float64, device=grad.device)
    out.index_add_(0, torch.where(flat < 0, flat + num_rows, flat), grad.reshape(-1, d).double())
    return out.to(grad.dtype)


def embedding_backward(ids, grad, num_rows: int):
    """The gradient of `table[ids]` for a table of num_rows rows: ids [...] int32
    or int64, grad [..., D] -> [num_rows, D] in grad's dtype."""
    if _build.on_cpu(grad, "embedding_backward"):
        return embedding_backward_plain(ids, grad, num_rows)
    _check(ids, grad, num_rows)
    if ids.device != grad.device:
        raise ValueError("embedding_backward wants ids and grad on one device")
    d = grad.shape[-1]
    flat_ids = ids.reshape(-1).contiguous()
    g = grad.reshape(-1, d).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    n = flat_ids.numel()
    lib = _build.load_library()
    keys = torch.empty(n, dtype=torch.int32, device=grad.device)
    out = torch.empty((num_rows, d), dtype=grad.dtype, device=grad.device)
    work = torch.empty(lib.cct_embedding_bwd_work_bytes(n, d, num_rows), dtype=torch.uint8,
                       device=grad.device)
    with tracing.span("embed_backward"), torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        _build.check(lib.cct_embedding_keys(_ID_CODES[flat_ids.dtype], flat_ids.data_ptr(),
                                            keys.data_ptr(), n, num_rows, stream),
                     "embedding_backward")
        keys, rows = torch.sort(keys, stable=True)   # each id's rows in row order
        err = lib.cct_embedding_bwd(
            _GRAD_CODES[g.dtype], keys.data_ptr(), rows.data_ptr(), g.data_ptr(),
            out.data_ptr(), work.data_ptr(), n, d, num_rows, stream)
    _build.check(err, "embedding_backward")
    tracing.count("embed_bwd")
    return out


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return embedding_backward(ids, grad, ctx.num_rows), None


def embedding(table, ids):
    """table [V, D], ids [...] int32 or int64 -> table[ids], [..., D]; on a CUDA
    table under the "kernel" impl its backward is `embedding_backward`."""
    if table.dim() != 2 or ids.dtype not in _ID_CODES:
        raise ValueError(f"embedding takes a [V, D] table and int32 or int64 ids, not "
                         f"{tuple(table.shape)} and {ids.dtype}")
    if _build.on_cpu(table, "embedding") or resolve_impl() != "kernel":
        return table[ids]
    return _Lookup.apply(table, ids)
