"""KV-cached greedy, nucleus-sampled and beam decode for the captioner
(counterpart of construction_clip_tpu/infer/decode.py:greedy_decode,
sample_decode, beam_decode).

The JAX package runs these as `lax.while_loop`s; here the loop is a Python loop
that checks the stop condition on the host once per step. The arithmetic and the
tie rules are transcribed exactly:
  - greedy: argmax (first index on ties), finished rows forced to token 0;
  - sample: the top-p filter of the temperature-scaled logits, then a draw from
    an explicit `torch.Generator` (in place of the JAX key, so the draws
    differ from the JAX package's), finished rows forced to token 0;
  - beam: temperature before log_softmax, stopped beams forced to token 0 at zero
    score, running scores length-normalised for a flat top-k over beam*vocab
    (lowest flat index first on ties, as lax.top_k), beams folded into the batch,
    a lazy ancestry map instead of reordering the cache, and a final stable sort
    by normalised score (jnp.argsort is stable).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from construction_clip_tpu_torch.core.configs import GPT2Config
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.gpt2 import KVCache, _is_quantized, gpt2_forward

NEG_INF = torch.finfo(torch.float32).min


class DecodeResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_steps] (beam: [B, beam, max_steps])
    lengths: torch.Tensor  # [B] (beam: [B, beam]): generated tokens incl. stop token
    scores: torch.Tensor   # beam: [B, beam] length-normalised log-prob, sorted desc


def _precast(params, policy):
    """The params cast to the compute dtype once per decode call; a quantized
    tree passes through untouched (its fp32 scales must not be rounded)."""
    return params if _is_quantized(params) else policy.cast_to_compute(params)


def _prefill(params, gcfg, embeds, max_steps, policy):
    b, t0, _ = embeds.shape
    cache = KVCache.create(gcfg, b, t0 + max_steps, dtype=policy.compute_dtype,
                           device=embeds.device)
    logits, cache = gpt2_forward(params, gcfg, inputs_embeds=embeds, cache=cache,
                                 policy=policy)
    return logits[:, -1], cache


def _top_k(x, k: int):
    """Top k along the last axis, the lower index first among equal values
    (the order lax.top_k gives)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _top_p_filter(logits, top_p: float):
    """Mask logits outside the smallest set whose cumulative probability
    exceeds top_p; the first token above the threshold is kept
    (construction_clip_tpu/infer/decode.py:_top_p_filter)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) <= top_p   # keep while the mass before a token <= p
    thresh = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits, NEG_INF)


def _lengths(toks, stop_token: int, max_steps: int):
    hit = (toks == stop_token).int()
    return torch.where(hit.any(dim=-1), hit.argmax(dim=-1) + 1, max_steps).int()


@torch.inference_mode()
def greedy_decode(params, gcfg: GPT2Config, embeds, *, max_steps: int = 67,
                  stop_token: int = 102, policy: Policy = DEFAULT_POLICY) -> DecodeResult:
    """embeds: [B, T0, n_embd] prompt embeddings. Greedy argmax decode."""
    b = embeds.shape[0]
    params = _precast(params, policy)
    last, cache = _prefill(params, gcfg, embeds, max_steps, policy)
    toks = torch.zeros((b, max_steps), dtype=torch.int32, device=embeds.device)
    done = torch.zeros((b,), dtype=torch.bool, device=embeds.device)
    step = 0
    while step < max_steps and not bool(done.all()):
        nxt = torch.where(done, 0, last.argmax(dim=-1).int())
        toks[:, step] = nxt
        done = done | (nxt == stop_token)
        logits, cache = gpt2_forward(params, gcfg, tokens=nxt[:, None], cache=cache,
                                     policy=policy)
        last = logits[:, 0]
        step += 1
    return DecodeResult(tokens=toks, lengths=_lengths(toks, stop_token, max_steps),
                        scores=torch.zeros((b,), device=embeds.device))


@torch.inference_mode()
def sample_decode(params, gcfg: GPT2Config, embeds, generator: torch.Generator, *,
                  max_steps: int = 67, stop_token: int = 102, top_p: float = 0.8,
                  temperature: float = 1.0, policy: Policy = DEFAULT_POLICY) -> DecodeResult:
    """embeds: [B, T0, n_embd] prompt embeddings. Nucleus (top-p) sampling with
    draws from `generator` (on embeds' device)."""
    b = embeds.shape[0]
    params = _precast(params, policy)
    last, cache = _prefill(params, gcfg, embeds, max_steps, policy)
    toks = torch.zeros((b, max_steps), dtype=torch.int32, device=embeds.device)
    done = torch.zeros((b,), dtype=torch.bool, device=embeds.device)
    step = 0
    while step < max_steps and not bool(done.all()):
        probs = torch.softmax(_top_p_filter(last.float() / temperature, top_p), dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0].int()
        nxt = torch.where(done, 0, nxt)
        toks[:, step] = nxt
        done = done | (nxt == stop_token)
        logits, cache = gpt2_forward(params, gcfg, tokens=nxt[:, None], cache=cache,
                                     policy=policy)
        last = logits[:, 0]
        step += 1
    return DecodeResult(tokens=toks, lengths=_lengths(toks, stop_token, max_steps),
                        scores=torch.zeros((b,), device=embeds.device))


@torch.inference_mode()
def beam_decode(params, gcfg: GPT2Config, embeds, *, beam_size: int = 3,
                max_steps: int = 100, stop_token: int = 102, temperature: float = 0.5,
                policy: Policy = DEFAULT_POLICY) -> DecodeResult:
    """Batched beam search with a lazy beam-ancestry cache: each beam writes its
    new k/v rows at its own fixed cache row, and anc[b, beam, t] records which row
    holds the beam's history at position t; attention reads through it
    (ops/decode_attention.py). Returns beams sorted by normalised score."""
    b, dev = embeds.shape[0], embeds.device
    v = gcfg.vocab_size
    params = _precast(params, policy)
    last, cache = _prefill(params, gcfg, embeds, max_steps, policy)
    t_total = cache.k.shape[3]

    logp0 = torch.log_softmax(last.float() / temperature, dim=-1)
    scores, nxt = _top_k(logp0, beam_size)                       # [B, beam]
    cache = KVCache(k=cache.k.repeat_interleave(beam_size, dim=1),
                    v=cache.v.repeat_interleave(beam_size, dim=1), length=cache.length)
    toks = torch.zeros((b, beam_size, max_steps), dtype=torch.int32, device=dev)
    toks[:, :, 0] = nxt.int()
    seq_len = torch.ones((b, beam_size), dtype=torch.float32, device=dev)
    stopped = nxt == stop_token

    own = (torch.arange(b, device=dev)[:, None] * beam_size
           + torch.arange(beam_size, device=dev)[None, :]).int()
    anc = own[..., None].expand(b, beam_size, t_total).contiguous()
    stop_row = torch.full((v,), NEG_INF, device=dev)
    stop_row[0] = 0.0                                            # forced token 0, zero score

    step = 1
    while step < max_steps and not bool(stopped.all()):
        # this step's k/v rows land at each beam's own row, position cache.length
        anc2 = anc  # updated in place: the previous map is not read again
        anc2[:, :, cache.length] = own
        logits, cache = gpt2_forward(
            params, gcfg, tokens=toks[:, :, step - 1].reshape(b * beam_size, 1),
            cache=cache, cache_ancestry=anc2.reshape(b * beam_size, t_total), policy=policy)
        logp = torch.log_softmax(logits[:, 0].float() / temperature, dim=-1)
        logp = torch.where(stopped[..., None], stop_row, logp.reshape(b, beam_size, v))
        scores_sum = scores[..., None] + logp                    # [B, beam, V]
        seq_len = seq_len + (~stopped).float()
        avg = scores_sum / seq_len[..., None]
        top_avg, idx = _top_k(avg.reshape(b, beam_size * v), beam_size)
        src = idx // v                                           # [B, beam]
        tok = (idx % v).int()
        seq_len = torch.gather(seq_len, 1, src)
        toks = torch.gather(toks, 1, src[..., None].expand(-1, -1, max_steps))
        toks[:, :, step] = tok
        scores = top_avg * seq_len
        stopped = torch.gather(stopped, 1, src) | (tok == stop_token)
        # lazy reorder: new beam j inherits ancestor src[j]'s full ancestry row
        anc = torch.gather(anc2, 1, src[..., None].expand(-1, -1, t_total))
        step += 1

    norm = scores / seq_len
    order = torch.argsort(-norm, dim=1, stable=True)
    return DecodeResult(
        tokens=torch.gather(toks, 1, order[..., None].expand(-1, -1, max_steps)),
        lengths=torch.gather(seq_len, 1, order).int(),
        scores=torch.gather(norm, 1, order))
