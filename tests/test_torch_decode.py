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


# ---- nucleus sampling ----------------------------------------------------------------------

def test_sample_decode_with_a_tiny_top_p_is_jax_greedy(params):
    """top_p 1e-6 keeps each row's most likely token alone, so the sampled
    tokens are JAX's greedy_decode's whatever the draws."""
    jparams, tparams = params
    emb = np.random.default_rng(8).standard_normal((3, 4, GCFG.n_embd)).astype(np.float32)
    want = jdecode.greedy_decode(jparams, GCFG, jnp.asarray(emb), max_steps=12, stop_token=5)
    got = decode.sample_decode(tparams, GCFG, torch.from_numpy(emb),
                               torch.Generator().manual_seed(0), max_steps=12, stop_token=5,
                               top_p=1e-6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def test_sample_decode_first_token_follows_the_softmax(params):
    """At top_p 1 and temperature 1 the first token of 4,000 rows of one prompt
    is drawn from the softmax of the prompt's last logits: the chi-square
    statistic of its counts (bins of fewer than 5 expected draws merged)
    below the 0.999 quantile for its degrees of freedom (a fixed generator,
    so the verdict does not change from run to run). The token table is
    scaled by 20 so that the softmax is far from uniform (a random tiny
    GPT-2's is nearly flat), and the same counts against a uniform draw
    must fail the bound."""
    from scipy import stats

    tparams = dict(params[1], wte=params[1]["wte"] * 20)
    emb = np.random.default_rng(9).standard_normal((1, 4, GCFG.n_embd)).astype(np.float32)
    rows = torch.from_numpy(emb).expand(4000, -1, -1).contiguous()
    res = decode.sample_decode(tparams, GCFG, rows, torch.Generator().manual_seed(1),
                               max_steps=1, top_p=1.0, temperature=1.0, stop_token=-1)
    logits, _ = gpt2.gpt2_forward(tparams, GCFG, inputs_embeds=torch.from_numpy(emb))
    expected = torch.softmax(logits[0, -1].double(), dim=-1).numpy() * 4000
    counts = np.bincount(res.tokens[:, 0].numpy(), minlength=GCFG.vocab_size)
    order = np.argsort(expected)
    small = order[np.cumsum(expected[order]) < 5]   # the rarest tokens, pooled
    big = np.setdiff1d(np.arange(GCFG.vocab_size), small)
    obs, exp = counts[big], expected[big]
    if len(small):
        obs, exp = np.append(obs, counts[small].sum()), np.append(exp, expected[small].sum())
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    bound = stats.chi2.ppf(0.999, len(obs) - 1)
    assert chi2 < bound, (chi2, len(obs))
    flat = 4000 / GCFG.vocab_size
    assert float(((counts - flat) ** 2 / flat).sum()) > stats.chi2.ppf(0.999, GCFG.vocab_size - 1)


def test_sample_decode_repeats_itself_with_a_fixed_generator(params):
    _, tparams = params
    emb = torch.from_numpy(
        np.random.default_rng(10).standard_normal((4, 3, GCFG.n_embd)).astype(np.float32))
    a, b, c = (decode.sample_decode(tparams, GCFG, emb, torch.Generator().manual_seed(seed),
                                    max_steps=10, top_p=0.9)
               for seed in (3, 3, 4))
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)
    assert not torch.equal(a.tokens, c.tokens)
