"""mT5 encoder-decoder (HF-compatible, defaults google/mt5-small) with a cached
decode path (counterpart of construction_clip_tpu/models/t5.py), over the JAX
parameter layout (`[in, out]` weights, blocks stacked along a leading axis).

What the JAX module pins holds here too: RMSNorm (eps 1e-6), attention without
1/sqrt(d_kv) and bias-free projections, inner width num_heads * d_kv, a bucketed
relative position bias computed once per stack and shared by every block
(bidirectional in the encoder, causal in the decoder, none in cross-attention),
a gated-GELU feedforward and mT5's untied LM head.

  - T5Cache holds the decoder's self-attention k/v [L, B, H, T_max, d_kv] in the
    compute dtype; the port writes each step's rows into it IN PLACE (the JAX
    package threads an immutable cache through its scan). The cross-attention
    k/v are computed once by `t5_init_cache`.
  - A one-token query (the decode step) attends in fp32 by broadcast
    multiply-reduce, with no bf16 rounding of the probabilities, as the JAX
    package does; longer queries go through ops/attention.mha with scale 1.
  - The LM head of a cached one-token step at B <= 8 with a bf16 or int8 table
    is ops/vocab_head.vocab_head_logits (kernel K8 on the card); every other
    head is a plain matmul, as XLA computes it in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from construction_clip_tpu_torch.core.configs import T5Config
from construction_clip_tpu_torch.core.params import as_tree, layer
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.ops import vocab_head as vh
from construction_clip_tpu_torch.ops.activations import gelu_gated
from construction_clip_tpu_torch.ops.attention import NEG_INF, mha, resolve_impl
from construction_clip_tpu_torch.ops.norms import rms_norm
from construction_clip_tpu_torch.ops.quant import quantize_weight


# ---------------------------------------------------------------- rel-pos bias

def relative_position_bucket(rel_pos, *, bidirectional: bool, num_buckets: int,
                             max_distance: int):
    """HF T5 bucketing of rel_pos = key_pos - query_pos (int tensor)."""
    ret = torch.zeros_like(rel_pos)
    n = rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = torch.clamp(-n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(rel_pos.dtype)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)


def compute_position_bias(rel_emb, q_pos, k_pos, cfg: T5Config, *, bidirectional: bool):
    """rel_emb [num_buckets, H]; q_pos [Tq], k_pos [Tk] -> bias [1, H, Tq, Tk]."""
    rel = k_pos[None, :] - q_pos[:, None]
    buckets = relative_position_bucket(
        rel, bidirectional=bidirectional, num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)
    return rel_emb[buckets].permute(2, 0, 1)[None]


def _mask_bias(mask):
    """[B, T] keep-mask -> additive fp32 bias [B, 1, 1, T]."""
    return torch.where(mask.bool(), 0.0, NEG_INF)[:, None, None, :]


# --------------------------------------------------------------------- attention

def _heads(z, cfg: T5Config):
    b = z.shape[0]
    return z.reshape(b, -1, cfg.num_heads, cfg.d_kv).permute(0, 2, 1, 3)


def _merge(z):
    b, h, t, dk = z.shape
    return z.permute(0, 2, 1, 3).reshape(b, t, h * dk)


def _attend(q, k, v, bias):
    """q [B, H, t, dk] over k/v [B, H, T, dk] with an additive bias, unscaled."""
    if q.shape[2] == 1:
        # the decode step: fp32 multiply-reduce, probabilities kept in fp32
        logits = (q[:, :, 0, :].float()[:, :, None, :] * k.float()).sum(dim=-1)  # [B, H, T]
        if bias is not None:
            b32 = bias.float()
            logits = logits + (b32[..., 0, :] if b32.dim() >= 2 else b32)
        probs = torch.softmax(logits, dim=-1)
        out = (probs[..., None] * v.float()).sum(dim=2)
        return out[:, :, None, :].to(q.dtype)
    return mha(q, k, v, bias=bias, scale=1.0)


def _t5_attention(x, ap, cfg: T5Config, *, bias=None):
    """Encoder self-attention: x [B, T, D]; bias additive."""
    q, k, v = (_heads(x @ ap[n], cfg) for n in ("q", "k", "v"))
    return _merge(_attend(q, k, v, bias)) @ ap["o"]


def _ffn(x, fp):
    return gelu_gated(x @ fp["wi_0"], x @ fp["wi_1"]) @ fp["wo"]


def _promoted_mm(a, w):
    """a @ w in the promoted dtype of the two (jnp's rule for bf16 with fp32)."""
    dtype = torch.promote_types(a.dtype, w.dtype)
    return a.to(dtype) @ w.to(dtype)


# ----------------------------------------------------------------------- encoder

def t5_encode(params, cfg: T5Config, input_ids, *, attention_mask=None,
              policy: Policy = DEFAULT_POLICY):
    """-> encoder hidden states [B, T, d_model] in the compute dtype."""
    p = _cast_params(params, policy)
    x = p["shared"][input_ids.long()]
    pos = torch.arange(x.shape[1], device=x.device)
    bias = compute_position_bias(p["enc_rel_emb"].float(), pos, pos, cfg, bidirectional=True)
    if attention_mask is not None:
        bias = bias + _mask_bias(attention_mask)
    eps = cfg.layer_norm_epsilon
    for index in range(cfg.num_layers):
        bp = layer(p["encoder"], index)
        x = x + _t5_attention(rms_norm(x, bp["ln_attn"], eps=eps), bp["attn"], cfg, bias=bias)
        x = x + _ffn(rms_norm(x, bp["ln_ffn"], eps=eps), bp["ffn"])
    return rms_norm(x, p["enc_final_ln"], eps=eps)


# ----------------------------------------------------------------------- decoder

@dataclasses.dataclass
class T5Cache:
    k: torch.Tensor        # [L, B, H, T_max, d_kv] decoder self-attention keys
    v: torch.Tensor
    cross_k: torch.Tensor  # [L, B, H, T_enc, d_kv], computed once
    cross_v: torch.Tensor
    length: int            # number of valid self-attention positions


def t5_init_cache(params, cfg: T5Config, encoder_hidden, max_len: int,
                  *, policy: Policy = DEFAULT_POLICY) -> T5Cache:
    p = _cast_params(params, policy)
    ck, cv = [], []
    for index in range(cfg.num_decoder_layers):
        cross = layer(p["decoder"], index)["cross_attn"]
        ck.append(_heads(_promoted_mm(encoder_hidden, cross["k"]), cfg))
        cv.append(_heads(_promoted_mm(encoder_hidden, cross["v"]), cfg))
    shape = (cfg.num_decoder_layers, encoder_hidden.shape[0], cfg.num_heads, max_len, cfg.d_kv)
    zeros = dict(dtype=policy.compute_dtype, device=encoder_hidden.device)
    return T5Cache(k=torch.zeros(shape, **zeros), v=torch.zeros(shape, **zeros),
                   cross_k=torch.stack(ck), cross_v=torch.stack(cv), length=0)


def t5_decode(params, cfg: T5Config, decoder_input_ids, encoder_hidden, *,
              encoder_mask=None, cache: Optional[T5Cache] = None,
              policy: Policy = DEFAULT_POLICY):
    """Teacher-forced (cache=None) or incremental (cache) decoding.
    Returns (logits [B, T, V] fp32, cache | None); the cache's self-attention
    tensors are updated in place."""
    p = _cast_params(params, policy)
    x = p["shared"][decoder_input_ids.long()]
    t = decoder_input_ids.shape[1]
    dev = x.device
    start = cache.length if cache is not None else 0
    eps = cfg.layer_norm_epsilon

    rel = p["dec_rel_emb"].float()
    q_pos = start + torch.arange(t, device=dev)
    k_pos = torch.arange(cache.k.shape[3] if cache is not None else t, device=dev)
    self_bias = compute_position_bias(rel, q_pos, k_pos, cfg, bidirectional=False)
    self_bias = self_bias + torch.where(q_pos[:, None] >= k_pos[None, :], 0.0, NEG_INF)[None, None]
    cross_bias = _mask_bias(encoder_mask) if encoder_mask is not None else None

    for index in range(cfg.num_decoder_layers):
        bp = layer(p["decoder"], index)
        y = rms_norm(x, bp["ln_self"], eps=eps)
        q, k, v = (_heads(y @ bp["self_attn"][n], cfg) for n in ("q", "k", "v"))
        if cache is not None:
            cache.k[index, :, :, start:start + t] = k
            cache.v[index, :, :, start:start + t] = v
            k, v = cache.k[index].to(y.dtype), cache.v[index].to(y.dtype)
            xk, xv = cache.cross_k[index].to(y.dtype), cache.cross_v[index].to(y.dtype)
        else:
            cross = bp["cross_attn"]
            enc = encoder_hidden.to(y.dtype)
            xk, xv = _heads(enc @ cross["k"], cfg), _heads(enc @ cross["v"], cfg)
        x = x + _merge(_attend(q, k, v, self_bias)) @ bp["self_attn"]["o"]
        y = rms_norm(x, bp["ln_cross"], eps=eps)
        qx = _heads(y @ bp["cross_attn"]["q"], cfg)
        x = x + _merge(_attend(qx, xk, xv, cross_bias)) @ bp["cross_attn"]["o"]
        x = x + _ffn(rms_norm(x, bp["ln_ffn"], eps=eps), bp["ffn"])

    x = rms_norm(x, p["dec_final_ln"], eps=eps)
    if cfg.tie_word_embeddings:
        logits = ((x * cfg.d_model ** -0.5) @ p["shared"].T).float()
    else:
        logits = _head_logits(p["lm_head"], x, cfg.vocab_size,
                              cached_step=cache is not None and t == 1)
    if cache is None:
        return logits, None
    return logits, dataclasses.replace(cache, length=start + t)


def _head_logits(head, x, vocab: int, *, cached_step: bool):
    """LM-head projection with the decode-step path: a cached one-token step at
    B <= MAX_ROWS with a bf16 or int8 table goes to the vocab-head GEMV (K8 on
    the card, its plain version on the CPU or under the "plain" impl); anything
    else is a matmul in the compute dtype, cast to fp32. head is a [D, V] table
    or {"q": int8 [D, V], "s": fp32 [V]} from quantize_t5_head. Logits are
    sliced to `vocab` columns."""
    quant = isinstance(head, dict)
    table = head["q"] if quant else head
    scale = head["s"] if quant else None
    if cached_step and vh.supported(x.shape[0], table):
        gemv = vh.vocab_head_logits if resolve_impl() == "kernel" else vh.vocab_head_logits_plain
        return gemv(x[:, 0], table, scale)[:, None, :vocab]
    if quant:
        # the dequant folds into the epilogue: the read stays int8
        return ((x @ table.to(x.dtype)).float() * scale.float())[..., :vocab]
    return (x @ table).float()[..., :vocab]


def quantize_t5_head(params):
    """Weight-only int8 LM head (the serving configuration): halves the table
    that every decode step reads. Quantize after any cast to the compute dtype:
    `_cast_params` keeps the int8 table and its fp32 scale as they are."""
    params = as_tree(params)
    if "lm_head" not in params:
        raise ValueError("quantize_t5_head: params have no untied lm_head")
    q, s = quantize_weight(params["lm_head"], axis=0)
    return dict(params, lm_head={"q": q, "s": s})


def _cast_params(params, policy: Policy):
    """policy.cast_to_compute that leaves a quantized lm_head intact (the int8
    table is not cast, and its fp32 scale must not be rounded to bf16)."""
    params = as_tree(params)
    if isinstance(params.get("lm_head"), dict):
        rest = {k: v for k, v in params.items() if k != "lm_head"}
        return dict(policy.cast_to_compute(rest), lm_head=params["lm_head"])
    return policy.cast_to_compute(params)


def t5_forward(params, cfg: T5Config, *, input_ids, decoder_input_ids, attention_mask=None,
               policy: Policy = DEFAULT_POLICY):
    """Full seq2seq forward -> (logits, encoder_hidden)."""
    encoder_hidden = t5_encode(params, cfg, input_ids, attention_mask=attention_mask,
                               policy=policy)
    logits, _ = t5_decode(params, cfg, decoder_input_ids, encoder_hidden,
                          encoder_mask=attention_mask, policy=policy)
    return logits, encoder_hidden


# -------------------------------------------------------------------- converter

def from_hf_state_dict(sd, cfg: T5Config) -> dict:
    """A HF (M)T5ForConditionalGeneration state dict -> the numpy tree
    (`convert.init_t5`'s layout), as the JAX package's from_hf_state_dict:
    Linear weights transposed to [in, out], blocks stacked, the relative
    position tables of block 0; a checkpoint without `lm_head.weight` (tied
    T5) takes `shared` there, as the JAX converter does."""
    import numpy as np

    from construction_clip_tpu_torch.core.params import stack_trees

    def a(k):
        x = sd[k]
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.asarray(x)

    def lin(k):
        return np.ascontiguousarray(a(k).T)   # torch Linear [out, in] -> [in, out]

    def attn(b, name):
        return {n: lin(f"{b}.{name}.{n}.weight") for n in ("q", "k", "v", "o")}

    def ffn(b):
        return {n: lin(f"{b}.DenseReluDense.{n}.weight") for n in ("wi_0", "wi_1", "wo")}

    def enc_block(i):
        b = f"encoder.block.{i}"
        return {"ln_attn": a(f"{b}.layer.0.layer_norm.weight"),
                "attn": attn(f"{b}.layer.0", "SelfAttention"),
                "ln_ffn": a(f"{b}.layer.1.layer_norm.weight"),
                "ffn": ffn(f"{b}.layer.1")}

    def dec_block(i):
        b = f"decoder.block.{i}"
        return {"ln_self": a(f"{b}.layer.0.layer_norm.weight"),
                "self_attn": attn(f"{b}.layer.0", "SelfAttention"),
                "ln_cross": a(f"{b}.layer.1.layer_norm.weight"),
                "cross_attn": attn(f"{b}.layer.1", "EncDecAttention"),
                "ln_ffn": a(f"{b}.layer.2.layer_norm.weight"),
                "ffn": ffn(f"{b}.layer.2")}

    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    return {
        "shared": a("shared.weight"),
        "enc_rel_emb": a(f"encoder.{rel}"),
        "dec_rel_emb": a(f"decoder.{rel}"),
        "encoder": stack_trees([enc_block(i) for i in range(cfg.num_layers)]),
        "enc_final_ln": a("encoder.final_layer_norm.weight"),
        "decoder": stack_trees([dec_block(i) for i in range(cfg.num_decoder_layers)]),
        "dec_final_ln": a("decoder.final_layer_norm.weight"),
        "lm_head": lin("lm_head.weight") if "lm_head.weight" in sd else a("shared.weight"),
    }
