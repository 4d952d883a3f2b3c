"""Multi-head attention in plain PyTorch (counterpart of
construction_clip_tpu/ops/attention.py): the path for every attention that is
not one of the port's kernels, and the reference the kernels are held against.

Logits and softmax are fp32 whatever the input dtype; probabilities are cast to
v's dtype for the product with v, which accumulates in fp32.

`set_impl`/`resolve_impl` choose, as in the JAX package, whether the models take
the hand-written kernels ("kernel", the default: ops/attention_block.py,
ops/flash_attention.py and ops/decode_attention.py, whose wrappers run their
plain version on CPU tensors) or the plain versions on any device ("plain", for
holding one path against the other on the card). Under "kernel", `mha` hands
every call that `flash_attention.supported` takes to the flash kernels, as the
JAX package's `mha` does under "pallas".
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_IMPL = "kernel"


def set_impl(name: str) -> None:
    global _IMPL
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown attention impl {name!r}")
    _IMPL = name


def resolve_impl() -> str:
    return _IMPL


@contextlib.contextmanager
def use_impl(name: str):
    previous = resolve_impl()
    set_impl(name)
    try:
        yield
    finally:
        set_impl(previous)


NEG_INF = torch.finfo(torch.float32).min


def causal_mask(q_len: int, kv_len: int, *, offset: int = 0, device=None):
    """Additive fp32 causal bias [q_len, kv_len]; `offset` = position of query 0."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return torch.where(q_pos >= k_pos, 0.0, NEG_INF).to(torch.float32)


def mha(q, k, v, *, bias=None, is_causal: bool = False, scale: Optional[float] = None):
    """Scaled dot-product attention over [B, H, T, Dh] tensors. bias: additive,
    broadcastable to [B, H, Tq, Tk]. Output in q.dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if resolve_impl() == "kernel":
        from construction_clip_tpu_torch.ops import flash_attention as fa

        if fa.supported(q, k, v, bias=bias):
            return fa.flash_attention(q, k, v, is_causal=is_causal, scale=scale)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        logits = logits + causal_mask(q.shape[2], k.shape[2], device=q.device)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def split_heads(x, n_heads: int):
    """[B, T, D] -> [B, H, T, D/H]"""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).permute(0, 2, 1, 3)


def merge_heads(x):
    """[B, H, T, Dh] -> [B, T, H*Dh]"""
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


def qkv_attention(x, params, n_heads: int, *, bias=None, is_causal: bool = False):
    """Self-attention layer: fused-qkv projection -> mha -> output projection.
    params: {"w_qkv": [D, 3D], "b_qkv": [3D], "w_out": [D, D], "b_out": [D]}
    (input-major weights: y = x @ W + b)."""
    qkv = x @ params["w_qkv"] + params["b_qkv"]
    q, k, v = (split_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
    out = mha(q, k, v, bias=bias, is_causal=is_causal)
    return merge_heads(out) @ params["w_out"] + params["b_out"]
