"""Decode-step (t == 1) attention over the stacked KV cache, with lazy beam
ancestry (counterpart of construction_clip_tpu/ops/pallas_decode_attention.py
and of the t == 1 branch of construction_clip_tpu/models/gpt2._attn_over_cache).

q [R, H, Dh] attends over layer `layer` of the stacked caches [L, R, H, T_max, Dh];
key position t is valid when t <= cache_len (the token just written included).
With ancestry [R, T_max] int32, row r reads position t from cache row
ancestry[r, t]: the beam's ancestor at that step. Logits, softmax and the p.v sum
are fp32; the output has q's dtype.

`decode_step_attention` launches csrc/decode_attention.cu (K2) on CUDA tensors
and runs `decode_step_attention_plain` on CPU tensors. K2 reads the positions
in one pass with an online softmax, split into `chunk_count` chunks a (row,
head), a thread-block cluster that merges their partials in chunk order.
"""

from __future__ import annotations

import math

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops.attention import NEG_INF

MAX_DH = 128
# K2's chunking: at least two blocks of 128 threads for each of the H100's 132
# SMs, no chunk shorter than half a sweep of a block's lane groups, and at most
# a portable cluster's 8 blocks
TARGET_BLOCKS = 264
MIN_CHUNK = 32
MAX_CHUNKS = 8


def decode_step_attention_plain(q, ck_all, cv_all, layer: int, cache_len: int,
                                ancestry=None, attn_bias=None):
    ck, cv = ck_all[layer], cv_all[layer]                        # [R, H, T, Dh]
    if ancestry is not None:
        idx = ancestry.long()[:, None, :, None].expand(-1, ck.shape[1], -1, ck.shape[3])
        ck = torch.gather(ck, 0, idx)
        cv = torch.gather(cv, 0, idx)
    qf = q.float() * q.shape[-1] ** -0.5
    logits = (qf[:, :, None, :] * ck.float()).sum(dim=-1)         # [R, H, T]
    k_pos = torch.arange(ck.shape[2], device=q.device)
    logits = torch.where(k_pos <= cache_len, logits, NEG_INF)
    if attn_bias is not None:
        b32 = attn_bias.float()
        logits = logits + (b32[..., 0, :] if b32.dim() >= 2 else b32)  # drop the query axis
    probs = torch.softmax(logits, dim=-1)
    return (probs[..., None] * cv.float()).sum(dim=2).to(q.dtype)


def chunk_count(rows: int, heads: int, n_valid: int) -> int:
    """Blocks K2 splits each (row, head)'s n_valid positions into: 1 where
    rows x heads blocks already fill the card, else up to TARGET_BLOCKS in all,
    with chunks of at least MIN_CHUNK positions and at most MAX_CHUNKS of them;
    never an empty chunk."""
    want = min(math.ceil(TARGET_BLOCKS / (rows * heads)), math.ceil(n_valid / MIN_CHUNK),
               MAX_CHUNKS)
    size = math.ceil(n_valid / want)
    return math.ceil(n_valid / size)


def decode_step_attention(q, ck_all, cv_all, layer: int, cache_len: int,
                          ancestry=None, attn_bias=None):
    if q.device.type == "cpu":
        return decode_step_attention_plain(q, ck_all, cv_all, layer, cache_len, ancestry,
                                           attn_bias)
    if q.device.type != "cuda":
        raise ValueError(f"decode_step_attention runs on cpu or cuda, not {q.device}")
    if attn_bias is not None:
        raise NotImplementedError("the decode attention kernel does not take attn_bias yet")
    n_layers, rows, n_heads, t_max, dh = ck_all.shape
    if tuple(q.shape) != (rows, n_heads, dh) or dh > MAX_DH or \
            dh * q.element_size() % 16:
        raise ValueError(f"decode_step_attention: q {tuple(q.shape)} does not fit "
                         f"the cache {tuple(ck_all.shape)} (Dh <= {MAX_DH}, rows a multiple "
                         f"of 16 bytes)")
    if not 0 <= layer < n_layers or cache_len < 0:
        raise ValueError(f"layer {layer} / cache_len {cache_len} out of range")
    for a in (q, ck_all, cv_all):
        if a.device != q.device or a.dtype != q.dtype or not a.is_contiguous():
            raise ValueError("decode_step_attention wants contiguous q and caches of "
                             "one dtype on one device")
    if tuple(cv_all.shape) != tuple(ck_all.shape):
        raise ValueError("k and v caches differ in shape")
    if any(a.data_ptr() % 16 for a in (ck_all, cv_all)):
        raise ValueError("decode_step_attention wants caches on 16-byte boundaries")
    if q.data_ptr() % 16:
        q = q.clone()   # a fresh allocation: 16-byte loads
    anc_ptr = None
    if ancestry is not None:
        if ancestry.dtype != torch.int32 or tuple(ancestry.shape) != (rows, t_max) \
                or ancestry.device != q.device or not ancestry.is_contiguous():
            raise ValueError(f"ancestry must be contiguous int32 [{rows}, {t_max}] "
                             f"on {q.device}")
        anc_ptr = ancestry.data_ptr()
    lib = _build.load_library()
    out = torch.empty_like(q)
    chunks = chunk_count(rows, n_heads, min(cache_len + 1, t_max))
    with torch.cuda.device(q.device):
        err = lib.cct_decode_attention(
            _build.dtype_code(q.dtype), q.data_ptr(), ck_all.data_ptr(),
            cv_all.data_ptr(), anc_ptr, out.data_ptr(), rows, n_heads, t_max, dh,
            int(layer), int(cache_len), chunks, float(dh ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_step_attention")
    tracing.count("k2")
    return out
