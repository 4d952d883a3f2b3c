"""ClipCap mT5 variant (counterpart of construction_clip_tpu/models/clipcap/
t5_model.py): the mapped CLIP prefix is concatenated in front of the T5
encoder states of the attribute tokens, and the decoder attends over both.

The training loss waits for the training slice of the port.
"""

from __future__ import annotations

import types

import torch

from construction_clip_tpu_torch.core.configs import ClipCapConfig, T5Config
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models import t5 as t5_lib
from construction_clip_tpu_torch.models.clipcap.model import map_prefix


def mapper_shape(tcfg: T5Config):
    """The mappers are sized by an `n_embd` attribute; T5's width is d_model."""
    return types.SimpleNamespace(n_embd=tcfg.d_model)


def encode_with_prefix(params, ccfg: ClipCapConfig, tcfg: T5Config, *,
                       input_ids, attention_mask, clip_embed,
                       policy: Policy = DEFAULT_POLICY):
    """-> (encoder_hidden [B, prefix+T, d], full_mask [B, prefix+T])."""
    params = as_tree(params)
    enc = t5_lib.t5_encode(params["t5"], tcfg, input_ids, attention_mask=attention_mask,
                           policy=policy)
    prefix = map_prefix(params["mapper"], ccfg, mapper_shape(tcfg), clip_embed,
                        policy=policy).to(enc.dtype)
    hidden = torch.cat([prefix, enc], dim=1)
    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, dtype=torch.int32, device=enc.device)
    full_mask = torch.cat(
        [torch.ones((input_ids.shape[0], ccfg.prefix_length), dtype=attention_mask.dtype,
                    device=enc.device), attention_mask], dim=1)
    return hidden, full_mask


def clipcap_t5_forward(params, ccfg: ClipCapConfig, tcfg: T5Config, *,
                       input_ids, attention_mask, clip_embed,
                       policy: Policy = DEFAULT_POLICY):
    """Training forward: decoder_input_ids = [prefix_length zeros ‖ input_ids].
    Returns logits [B, prefix_length + T, V]."""
    params = as_tree(params)
    hidden, full_mask = encode_with_prefix(
        params, ccfg, tcfg, input_ids=input_ids, attention_mask=attention_mask,
        clip_embed=clip_embed, policy=policy)
    dec_in = torch.cat([torch.zeros((input_ids.shape[0], ccfg.prefix_length),
                                    dtype=input_ids.dtype, device=input_ids.device),
                        input_ids], dim=1)
    logits, _ = t5_lib.t5_decode(params["t5"], tcfg, dec_in, hidden, encoder_mask=full_mask,
                                 policy=policy)
    return logits
