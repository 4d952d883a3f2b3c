"""ClipCap prefix captioning (counterpart of construction_clip_tpu/models/clipcap/
model.py): CLIP embedding -> mapper -> GPT-2 prefix, the training forward over
[prefix ‖ attribute ‖ caption] and its caption loss.

The mappers (ClipCapConfig.mapper):
  - "mlp": Linear(clip_dim -> n_embd*prefix/2) -> tanh -> Linear(-> n_embd*prefix),
    reshaped to [B, prefix_length, n_embd];
  - "transformer": Linear(clip_dim -> clip_length*n_embd) and the learned
    prefix constant [prefix_length, n_embd], through `mapper_layers` pre-norm
    blocks (8 heads, MLP ratio 2, ReLU; models/blocks.apply_stack, so K1 and
    K3 on the card), keeping the last prefix_length rows.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models import gpt2 as gpt2_lib
from construction_clip_tpu_torch.models.blocks import apply_stack

MAPPER_HEADS = 8   # the transformer mapper's heads (reference train.py:234-248)


def map_prefix(mapper_params, ccfg: ClipCapConfig, gcfg: GPT2Config, clip_embed, *,
               policy: Policy = DEFAULT_POLICY):
    """clip_embed [B, clip_dim] -> prefix embeddings [B, prefix_length, n_embd]."""
    p = policy.cast_to_compute(mapper_params)
    x = clip_embed.to(policy.compute_dtype)
    d = gcfg.n_embd
    if ccfg.mapper == "mlp":
        h = torch.tanh(x @ p["w1"] + p["b1"])
        out = h @ p["w2"] + p["b2"]
        return out.reshape(x.shape[0], ccfg.prefix_length, d)
    if ccfg.mapper != "transformer":
        raise ValueError(f"unknown mapper {ccfg.mapper!r}")
    proj = (x @ p["proj"] + p["proj_b"]).reshape(x.shape[0], ccfg.clip_length, d)
    const = p["prefix_const"].expand(x.shape[0], ccfg.prefix_length, d)
    seq = apply_stack(p["blocks"], torch.cat([proj, const], dim=1), n_heads=MAPPER_HEADS,
                      act=torch.relu)
    return seq[:, ccfg.clip_length:]


def clipcap_forward(params, ccfg: ClipCapConfig, gcfg: GPT2Config, *, tokens, clip_embed,
                    attribute_tokens, policy: Policy = DEFAULT_POLICY, remat=False):
    """Training forward: fp32 logits [B, P + A + T, V] over the concatenated
    [prefix ‖ wte(attribute) ‖ wte(tokens)] through the uncached GPT-2
    (remat: gpt2_forward's, per layer)."""
    prefix = map_prefix(params["mapper"], ccfg, gcfg, clip_embed, policy=policy)
    attr_emb = gpt2_lib.embed_tokens(params["gpt"], attribute_tokens, policy=policy)
    tok_emb = gpt2_lib.embed_tokens(params["gpt"], tokens, policy=policy)
    embeds = torch.cat([prefix.to(tok_emb.dtype), attr_emb, tok_emb], dim=1)
    return gpt2_lib.gpt2_forward(params["gpt"], gcfg, inputs_embeds=embeds, policy=policy,
                                 remat=remat)[0]


def caption_loss_parts(logits, tokens, ccfg: ClipCapConfig, *, ignore_id: int = 0):
    """(sum of the masked token NLL, count of valid tokens): next-token CE of
    logits[:, P + A - 1 : -1] against the caption tokens in fp32, id
    `ignore_id` masked out. Kept apart so that data-parallel ranks divide by
    the global count."""
    offset = ccfg.prefix_length + ccfg.attribute_length
    logp = torch.log_softmax(logits[:, offset - 1: -1].float(), dim=-1)
    nll = -logp.gather(-1, tokens.long()[..., None])[..., 0]
    mask = (tokens != ignore_id).float()
    return (nll * mask).sum(), mask.sum()


def caption_loss(logits, tokens, ccfg: ClipCapConfig, *, ignore_id: int = 0):
    """The token-mean CE over the valid caption tokens."""
    total, count = caption_loss_parts(logits, tokens, ccfg, ignore_id=ignore_id)
    return total / count.clamp(min=1.0)
