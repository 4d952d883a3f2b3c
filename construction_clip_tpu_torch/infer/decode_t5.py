"""T5 autoregressive decoding over the self- and cross-attention cache
(counterpart of construction_clip_tpu/infer/decode_t5.py:t5_generate).

Sampling (the reference's `generate(do_sample=True, max_length=32)`) or greedy.
T5's conventions: the decoder starts from the pad id 0 and EOS is 1. The JAX
package's `lax.while_loop` is a Python loop here that checks its stop rule on
the host once per step, with the same rule: go on while step < max_steps and
some row is not done; a finished row takes token 0. Random draws come from an
explicit `torch.Generator` in place of a JAX key, so sampled tokens differ from
the JAX package's; greedy tokens are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from construction_clip_tpu_torch.core.configs import T5Config
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.infer.decode import DecodeResult, _lengths, _top_p_filter
from construction_clip_tpu_torch.models.t5 import _cast_params, t5_decode, t5_init_cache

START_ID = 0   # T5 starts the decoder from the pad id


@torch.inference_mode()
def t5_generate(params, tcfg: T5Config, encoder_hidden, *,
                generator: Optional[torch.Generator] = None, encoder_mask=None,
                max_steps: int = 32, eos_id: int = 1,
                do_sample: bool = True, top_p: float = 1.0, temperature: float = 1.0,
                policy: Policy = DEFAULT_POLICY) -> DecodeResult:
    """encoder_hidden [B, T_enc, d_model] (the prefix-concatenated states) ->
    tokens [B, max_steps] and lengths (up to and including EOS)."""
    b, dev = encoder_hidden.shape[0], encoder_hidden.device
    params = _cast_params(params, policy)   # once, not per step
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = t5_init_cache(params, tcfg, encoder_hidden, max_len=max_steps + 1, policy=policy)
    logits, cache = t5_decode(params, tcfg,
                              torch.full((b, 1), START_ID, dtype=torch.int32, device=dev),
                              encoder_hidden, encoder_mask=encoder_mask, cache=cache,
                              policy=policy)
    last = logits[:, 0]
    toks = torch.zeros((b, max_steps), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    step = 0
    while step < max_steps and not bool(done.all()):
        logits32 = last.float() / temperature
        if do_sample:
            if top_p < 1.0:
                logits32 = _top_p_filter(logits32, top_p)
            probs = torch.softmax(logits32, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0].int()
        else:
            nxt = logits32.argmax(dim=-1).int()
        nxt = torch.where(done, 0, nxt)
        toks[:, step] = nxt
        done = done | (nxt == eos_id)
        logits, cache = t5_decode(params, tcfg, nxt[:, None], encoder_hidden,
                                  encoder_mask=encoder_mask, cache=cache, policy=policy)
        last = logits[:, 0]
        step += 1
    return DecodeResult(tokens=toks, lengths=_lengths(toks, eos_id, max_steps),
                        scores=torch.zeros((b,), device=dev))
