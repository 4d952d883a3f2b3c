"""PyTorch port, GPT-2 and the decode loops against the JAX package (CPU, fp32):
logits of the uncached and cached forward, greedy and beam tokens exactly equal
to JAX's and to the gpt2_decode_tiny golden."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.infer import decode as jdecode
from construction_clip_tpu.models import gpt2 as jgpt2
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import GPT2Config
from construction_clip_tpu_torch.infer import decode
from construction_clip_tpu_torch.models import gpt2

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "gpt2_decode_tiny.npz")
# fp32 logits of a 2-layer model: sums in another order than XLA's
LOGITS = dict(rtol=1e-4, atol=1e-5)
GCFG = GPT2Config.tiny()


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_gpt2(jax.random.key(7), GCFG)
    return jparams, convert.to_params(jparams).tree()


def test_forward_uncached(params, rng):
    jparams, tparams = params
    toks = rng.integers(0, GCFG.vocab_size, (2, 9)).astype(np.int32)
    want, _ = jgpt2.gpt2_forward(jparams, GCFG, tokens=jnp.asarray(toks))
    got, cache = gpt2.gpt2_forward(tparams, GCFG, tokens=torch.from_numpy(toks))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_forward_cached_prefill_then_steps(params, rng):
    jparams, tparams = params
    emb = rng.standard_normal((3, 5, GCFG.n_embd)).astype(np.float32) * 0.1
    jcache = jgpt2.KVCache.create(GCFG, 3, 9)
    tcache = gpt2.KVCache.create(GCFG, 3, 9)
    want, jcache = jgpt2.gpt2_forward(jparams, GCFG, inputs_embeds=jnp.asarray(emb),
                                      cache=jcache)
    got, tcache = gpt2.gpt2_forward(tparams, GCFG, inputs_embeds=torch.from_numpy(emb),
                                    cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    anc = rng.integers(0, 3, (3, 9)).astype(np.int32)
    for step in range(3):
        tok = rng.integers(0, GCFG.vocab_size, (3, 1)).astype(np.int32)
        ancestry = anc if step == 2 else None
        want, jcache = jgpt2.gpt2_forward(
            jparams, GCFG, tokens=jnp.asarray(tok), cache=jcache,
            cache_ancestry=None if ancestry is None else jnp.asarray(ancestry))
        got, tcache = gpt2.gpt2_forward(
            tparams, GCFG, tokens=torch.from_numpy(tok), cache=tcache,
            cache_ancestry=None if ancestry is None else torch.from_numpy(ancestry))
        assert tcache.length == int(jcache.length)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **LOGITS)


def test_multi_token_append_is_refused(params):
    _, tparams = params
    cache = gpt2.KVCache.create(GCFG, 1, 8)
    _, cache = gpt2.gpt2_forward(tparams, GCFG, tokens=torch.zeros(1, 2, dtype=torch.int32),
                                 cache=cache)
    with pytest.raises(ValueError):
        gpt2.gpt2_forward(tparams, GCFG, tokens=torch.zeros(1, 2, dtype=torch.int32),
                          cache=cache)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_golden(params, mode):
    _, tparams = params
    golden = np.load(GOLDEN)
    embeds = gpt2.embed_tokens(tparams, torch.arange(6)[None])
    if mode == "greedy":
        res = decode.greedy_decode(tparams, GCFG, embeds, max_steps=12, stop_token=5)
        np.testing.assert_array_equal(res.tokens.numpy(), golden["greedy_tokens"])
    else:
        res = decode.beam_decode(tparams, GCFG, embeds, beam_size=3, max_steps=12,
                                 stop_token=5, temperature=0.5)
        np.testing.assert_array_equal(res.tokens.numpy(), golden["beam_tokens"])
        # the golden file's own tolerance (tests/test_goldens.py)
        np.testing.assert_allclose(res.scores.numpy(), golden["beam_scores"],
                                   rtol=1e-5, atol=1e-6)


def _prompt(rng, b):
    return rng.standard_normal((b, 4, GCFG.n_embd)).astype(np.float32) * 0.5


def _stop_token(jparams, emb):
    """A token the model emits early for row 0, so that rows and beams stop at
    different steps and the stopped-beam paths run."""
    g = jdecode.greedy_decode(jparams, GCFG, jnp.asarray(emb), max_steps=3, stop_token=-1)
    return int(np.asarray(g.tokens)[0, 1])


def test_greedy_matches_jax(params, rng):
    jparams, tparams = params
    emb = _prompt(rng, 3)
    stop = _stop_token(jparams, emb)
    want = jdecode.greedy_decode(jparams, GCFG, jnp.asarray(emb), max_steps=10,
                                 stop_token=stop)
    got = decode.greedy_decode(tparams, GCFG, torch.from_numpy(emb), max_steps=10,
                               stop_token=stop)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


@pytest.mark.parametrize("beam_size", [2, 3])
def test_beam_matches_jax(params, beam_size, rng):
    jparams, tparams = params
    emb = _prompt(rng, 3)
    stop = _stop_token(jparams, emb)
    want = jdecode.beam_decode(jparams, GCFG, jnp.asarray(emb), beam_size=beam_size,
                               max_steps=10, stop_token=stop, temperature=0.5)
    got = decode.beam_decode(tparams, GCFG, torch.from_numpy(emb), beam_size=beam_size,
                             max_steps=10, stop_token=stop, temperature=0.5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    # length-normalised fp32 log-probs summed over up to 10 steps
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5,
                               atol=1e-5)
