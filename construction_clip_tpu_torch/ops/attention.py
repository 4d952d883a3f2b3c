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
every call that `flash_attention.supported` takes to the flash kernels, except
one that asks for the probabilities or carries a probe, as the JAX package's
`mha` does under "pallas".
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


def mha(q, k, v, *, bias=None, is_causal: bool = False, scale: Optional[float] = None,
        return_probs: bool = False, probs_probe=None):
    """Scaled dot-product attention over [B, H, T, Dh] tensors. bias: additive,
    broadcastable to [B, H, Tq, Tk]. Output in q.dtype.

    return_probs: also return the fp32 attention probabilities [B, H, Tq, Tk].
    probs_probe: zeros [B, H, Tq, Tk] added to the probabilities before the
    product with v, a differentiation port: the gradient with respect to the
    probe is the gradient with respect to the probabilities (infer/explain.py).
    Either one keeps the call off the flash kernels, as in the JAX package."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if resolve_impl() == "kernel" and not return_probs and probs_probe is None:
        from construction_clip_tpu_torch.ops import flash_attention as fa

        if fa.supported(q, k, v, bias=bias):
            return fa.flash_attention(q, k, v, is_causal=is_causal, scale=scale)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        logits = logits + causal_mask(q.shape[2], k.shape[2], device=q.device)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    if probs_probe is not None:
        probs = probs + probs_probe.float()
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float()).to(q.dtype)
    return (out, probs) if return_probs else out


def split_heads(x, n_heads: int):
    """[B, T, D] -> [B, H, T, D/H]"""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).permute(0, 2, 1, 3)


def merge_heads(x):
    """[B, H, T, Dh] -> [B, T, H*Dh]"""
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


def qkv_attention(x, params, n_heads: int, *, kv_x=None, bias=None, is_causal: bool = False,
                  return_probs: bool = False, probs_probe=None):
    """Attention layer: qkv projection -> mha -> output projection.
    params: {"w_qkv": [D, 3D], "b_qkv": [3D], "w_out": [D, D], "b_out": [D]}
    (input-major weights: y = x @ W + b). Self-attention when kv_x is None;
    cross-attention takes q from x and k, v from kv_x through the split w_qkv.
    With return_probs, returns (y, fp32 probabilities [B, H, Tq, Tk])."""
    if kv_x is None:
        qkv = x @ params["w_qkv"] + params["b_qkv"]
        q, k, v = qkv.chunk(3, dim=-1)
    else:
        wq, wk, wv = params["w_qkv"].chunk(3, dim=-1)
        bq, bk, bv = params["b_qkv"].chunk(3, dim=-1)
        q, k, v = x @ wq + bq, kv_x @ wk + bk, kv_x @ wv + bv
    q, k, v = (split_heads(t, n_heads) for t in (q, k, v))
    out = mha(q, k, v, bias=bias, is_causal=is_causal, return_probs=return_probs,
              probs_probe=probs_probe)
    out, probs = out if return_probs else (out, None)
    y = merge_heads(out) @ params["w_out"] + params["b_out"]
    return (y, probs) if return_probs else y
