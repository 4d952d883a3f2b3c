"""GPT-2 decoder (HF-compatible) with a KV-cache decode path (counterpart of
construction_clip_tpu/models/gpt2.py), over the JAX parameter layout
(`[in, out]` weights as HF's Conv1D, blocks stacked along a leading axis).

  - KVCache [L, B, H, T_max, Dh] in the compute dtype. The port writes each
    layer's new k/v rows into it IN PLACE (the JAX package threads an
    immutable cache through its scan), so a decode step moves only the rows it
    adds; `gpt2_forward` returns the same tensors with the length advanced.
  - Multi-token cached calls are prefill only (fresh cache): they attend over the
    chunk's fresh q/k/v in plain PyTorch (gpt2.py:284-296 of the JAX package).
  - The t == 1 step reads the cache through decode_step_attention (kernel K2),
    following the beam ancestry row when one is given.
  - `inputs_embeds` is the door the ClipCap prefix comes in by.
  - `quantize_gpt2` makes the int8 serving tree: the four block GEMMs and a
    transposed logits copy of wte become {"q", "s"} leaves, which `_linear`
    and `_lm_logits` run through ops/quant.int8_linear; the forward then
    leaves the tree as the quantizer made it (no policy cast), as the JAX
    package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from construction_clip_tpu_torch.core.configs import GPT2Config
from construction_clip_tpu_torch.core.params import as_tree, layer, tree_map
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.ops import decode_attention as dec
from construction_clip_tpu_torch.ops.activations import gelu_new
from construction_clip_tpu_torch.ops.attention import (
    NEG_INF, merge_heads, resolve_impl, split_heads)
from construction_clip_tpu_torch.ops.norms import layer_norm
from construction_clip_tpu_torch.ops.quant import (
    gemm_layout, int8_linear, quantize_tree, quantize_weight)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, H, T_max, Dh]
    v: torch.Tensor  # [L, B, H, T_max, Dh]
    length: int      # number of valid positions

    @staticmethod
    def create(cfg: GPT2Config, batch: int, max_len: int, *, dtype=torch.float32,
               device=None) -> "KVCache":
        shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.n_embd // cfg.n_head)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def _attn_uncached(q, k, v, attn_bias):
    """Causal attention within one chunk, [B, H, T, Dh]."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    t = q.shape[2]
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(keep, logits, NEG_INF)
    if attn_bias is not None:
        logits = logits + attn_bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float()).to(q.dtype)


def _linear(h, w, b):
    """h @ W + b, or, for a {"q", "s"} leaf of quantize_gpt2, the int8 product
    with per-row activation quantization in h's dtype."""
    if isinstance(w, dict):
        return int8_linear(h, w["q"], w["s"], b, out_dtype=h.dtype)
    return h @ w + b


def quantize_gpt2(params, dtype=torch.bfloat16):
    """Inference-quantized GPT-2 params: the four block GEMM weights and a
    transposed logits copy of wte ([n_embd, vocab], quantized from the
    unrounded table) become int8 {"q", "s"} leaves; other float leaves are cast
    to `dtype`. wte itself stays float for the embedding lookups."""
    params = as_tree(params)
    p = tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)
    p = quantize_tree(p, (("blocks", "attn", "c_attn_w"), ("blocks", "attn", "c_proj_w"),
                          ("blocks", "mlp", "c_fc_w"), ("blocks", "mlp", "c_proj_w")))
    q, s = quantize_weight(params["wte"].T, axis=0)
    p["wte_logits"] = {"q": gemm_layout(q), "s": s}
    return p


def _is_quantized(params) -> bool:
    return isinstance(params["blocks"]["attn"]["c_attn_w"], dict)


def _lm_logits(p, x):
    # fp32 logits: the int8 head's rescale, or the compute-dtype head cast as
    # the JAX package's (x @ wte.T).astype(float32)
    if "wte_logits" in p:
        return int8_linear(x, p["wte_logits"]["q"], p["wte_logits"]["s"],
                           out_dtype=torch.float32)
    return (x @ p["wte"].T).float()


def _mlp(lp, h, cfg):
    y = layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps=cfg.layer_norm_epsilon)
    y = gelu_new(_linear(y, lp["mlp"]["c_fc_w"], lp["mlp"]["c_fc_b"]))
    return h + _linear(y, lp["mlp"]["c_proj_w"], lp["mlp"]["c_proj_b"])


def _qkv(lp, h, cfg):
    y = layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps=cfg.layer_norm_epsilon)
    qkv = _linear(y, lp["attn"]["c_attn_w"], lp["attn"]["c_attn_b"])
    return (split_heads(z, cfg.n_head) for z in qkv.chunk(3, dim=-1))


def _proj(lp, h, out):
    return h + _linear(merge_heads(out), lp["attn"]["c_proj_w"], lp["attn"]["c_proj_b"])


def gpt2_forward(params, cfg: GPT2Config, *, tokens=None, inputs_embeds=None,
                 attn_bias=None, cache: Optional[KVCache] = None,
                 cache_ancestry=None, policy: Policy = DEFAULT_POLICY):
    """Returns (logits [B, T, V] fp32, cache | None). tokens XOR inputs_embeds.

    With a cache the new positions start at cache.length. cache_ancestry
    [B, T_max] int32 (t == 1 steps): row i reads cache position t from row
    ancestry[i, t] (lazy beam reorder, infer/decode.beam_decode). A quantized
    tree is used as the quantizer left it: its bf16 leaves and fp32 scales are
    not cast, so token embeddings are bf16 while `inputs_embeds` take the
    policy's dtype, as in the JAX package."""
    p = params if _is_quantized(params) else policy.cast_to_compute(params)
    x = p["wte"][tokens.long()] if inputs_embeds is None else inputs_embeds.to(
        policy.compute_dtype)
    start = cache.length if cache is not None else 0
    t = x.shape[1]
    if start + t > cfg.n_positions:
        raise ValueError(f"positions up to {start + t} exceed n_positions={cfg.n_positions}")
    x = x + p["wpe"][start: start + t]
    if cache is not None and t > 1 and start != 0:
        raise ValueError("multi-token cached calls are prefill only (fresh cache)")

    for index in range(cfg.n_layer):
        lp = layer(p["blocks"], index)
        q, k, v = _qkv(lp, x, cfg)
        if cache is None or t > 1:
            if cache is not None:
                cache.k[index, :, :, :t] = k
                cache.v[index, :, :, :t] = v
            out = _attn_uncached(q, k, v, attn_bias)
        else:
            cache.k[index, :, :, start] = k[:, :, 0]
            cache.v[index, :, :, start] = v[:, :, 0]
            attend = (dec.decode_step_attention if resolve_impl() == "kernel"
                      else dec.decode_step_attention_plain)
            # the attention reads q in the cache's dtype (exact: a quantized
            # tree's bf16 steps over an fp32 cache) and answers in q's
            out = attend(q[:, :, 0].to(cache.k.dtype).contiguous(), cache.k, cache.v, index,
                         start, cache_ancestry, attn_bias)[:, :, None].to(q.dtype)
        x = _mlp(lp, _proj(lp, x, out), cfg)

    x = layer_norm(x, p["ln_f"]["scale"], p["ln_f"]["bias"], eps=cfg.layer_norm_epsilon)
    logits = _lm_logits(p, x)
    if cache is None:
        return logits, None
    return logits, KVCache(k=cache.k, v=cache.v, length=start + t)


def embed_tokens(params, tokens, *, policy: Policy = DEFAULT_POLICY):
    """wte lookup: the ClipCap prompt concatenates these with the mapped prefix."""
    return params["wte"][tokens.long()].to(policy.compute_dtype)
