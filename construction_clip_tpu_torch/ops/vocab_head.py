"""Streaming vocab-head GEMV for small-batch decode steps (counterpart of
construction_clip_tpu/ops/pallas_vocab_head.py).

x [B <= MAX_ROWS, D] times the LM head's table [D, V], bf16 or int8 with an fp32
per-column scale [V], gives fp32 logits [B, V]. The rounding points are the
Pallas kernel's: x is rounded to bf16, the products are summed in fp32, an int8
table's scale multiplies the fp32 sum, and the logits are never rounded to
bf16.

`vocab_head_logits` launches csrc/vocab_head.cu (K8) on CUDA tensors and runs
`vocab_head_logits_plain` on CPU tensors. The Pallas kernel's V-tile rule
(`_pick_tile`) and `pad_to_tile` are TPU lane constraints: K8 takes any V.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build

MAX_ROWS = 8          # the small-B regime of the JAX gate; K8's largest row count
_TABLE_CODES = {torch.bfloat16: 1, torch.int8: 2}   # csrc/common.cuh: DType


def supported(batch: int, table) -> bool:
    """The JAX gate without its TPU tile rule: small B, a 2-D bf16 or int8 table."""
    return batch <= MAX_ROWS and table.dim() == 2 and table.dtype in _TABLE_CODES


def _check(x, table, scale) -> None:
    if x.dim() != 2 or table.dim() != 2 or x.shape[1] != table.shape[0]:
        raise ValueError(f"vocab_head_logits: x {tuple(x.shape)} does not fit the table "
                         f"{tuple(table.shape)}")
    if table.dtype not in _TABLE_CODES:
        raise ValueError(f"vocab_head_logits takes a bf16 or int8 table, not {table.dtype}")
    if (table.dtype == torch.int8) != (scale is not None):
        raise ValueError("an int8 table needs its scale, and a bf16 table takes none")
    if scale is not None and tuple(scale.shape) != (table.shape[1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit V={table.shape[1]}")


def vocab_head_logits_plain(x, table, scale=None):
    _check(x, table, scale)
    out = x.to(torch.bfloat16).float() @ table.float()
    return out * scale.float() if scale is not None else out


def vocab_head_logits(x, table, scale=None):
    """x [B, D], table [D, V] bf16 or int8 (+ scale [V]) -> [B, V] fp32 logits."""
    if _build.on_cpu(x, "vocab_head_logits"):
        return vocab_head_logits_plain(x, table, scale)
    _check(x, table, scale)
    rows, d = x.shape
    v = table.shape[1]
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"vocab_head_logits: B={rows}, the kernel takes 1..{MAX_ROWS} rows")
    x16 = x.to(torch.bfloat16).contiguous()
    scale32 = scale.float().contiguous() if scale is not None else None
    if any(a is not None and a.device != x.device for a in (table, scale32)):
        raise ValueError("vocab_head_logits wants x, table and scale on one device")
    if not table.is_contiguous():
        raise ValueError("vocab_head_logits wants a contiguous table")
    lib = _build.load_library()
    out = torch.empty((rows, v), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.cct_vocab_head(
            _TABLE_CODES[table.dtype], x16.data_ptr(), table.data_ptr(),
            scale32.data_ptr() if scale32 is not None else None, out.data_ptr(), rows, d, v,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "vocab_head_logits")
    tracing.count("k8")
    return out
