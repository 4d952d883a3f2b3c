"""ClipCap prefix mapper (counterpart of construction_clip_tpu/models/clipcap/
model.py:map_prefix): CLIP embedding -> GPT-2 prefix embeddings.

Only the default MLP mapper is ported: Linear(clip_dim -> n_embd*prefix/2) ->
tanh -> Linear(-> n_embd*prefix), reshaped to [B, prefix_length, n_embd].
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy


def map_prefix(mapper_params, ccfg: ClipCapConfig, gcfg: GPT2Config, clip_embed, *,
               policy: Policy = DEFAULT_POLICY):
    """clip_embed [B, clip_dim] -> prefix embeddings [B, prefix_length, n_embd]."""
    if ccfg.mapper != "mlp":
        raise NotImplementedError(f"mapper {ccfg.mapper!r} is not ported yet (only 'mlp')")
    p = policy.cast_to_compute(mapper_params)
    x = clip_embed.to(policy.compute_dtype)
    h = torch.tanh(x @ p["w1"] + p["b1"])
    out = h @ p["w2"] + p["b2"]
    return out.reshape(x.shape[0], ccfg.prefix_length, gcfg.n_embd)
