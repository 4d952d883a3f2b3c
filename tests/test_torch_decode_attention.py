"""PyTorch port, decode-step attention (K2): the plain version, which the wrapper
runs on CPU tensors, against the JAX package's t==1 cache read
(models/gpt2._attn_over_cache, with and without beam ancestry, and with a bias)
and against its Pallas kernel in interpret mode. The CUDA kernel is held against
the plain version on the card in tests/test_torch_kernels.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from construction_clip_tpu.models import gpt2 as jgpt2
from construction_clip_tpu.ops import pallas_decode_attention as jpda
from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import decode_attention as dec

# fp32 on both sides; sums over positions and Dh in another order.
TOL = dict(rtol=1e-5, atol=1e-6)
L, R, H, T, DH = 2, 6, 2, 10, 8


def _case(rng):
    ck = rng.standard_normal((L, R, H, T, DH)).astype(np.float32)
    cv = rng.standard_normal((L, R, H, T, DH)).astype(np.float32)
    q = rng.standard_normal((R, H, DH)).astype(np.float32)
    anc = rng.integers(0, R, (R, T), dtype=np.int32)
    return q, ck, cv, anc


@pytest.mark.parametrize("cache_len", [0, 5, T - 1])
@pytest.mark.parametrize("with_ancestry", [False, True])
def test_plain_matches_attn_over_cache(cache_len, with_ancestry, rng):
    q, ck, cv, anc = _case(rng)
    layer = 1
    ancestry = anc if with_ancestry else None
    want = jgpt2._attn_over_cache(
        jnp.asarray(q)[:, :, None, :], jnp.asarray(ck[layer]), jnp.asarray(cv[layer]),
        cache_len, None, None if ancestry is None else jnp.asarray(ancestry))
    got = dec.decode_step_attention(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), layer, cache_len,
        None if ancestry is None else torch.from_numpy(ancestry))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, 0], **TOL)


@pytest.mark.parametrize("cache_len", [3, T - 1])
def test_plain_matches_pallas_interpret(cache_len, rng):
    q, ck, cv, _ = _case(rng)
    want = jpda.decode_step_attention(jnp.asarray(q)[:, :, None, :], jnp.asarray(ck),
                                      jnp.asarray(cv), jnp.asarray(0, jnp.int32), cache_len,
                                      interpret=True)
    got = dec.decode_step_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                    torch.from_numpy(cv), 0, cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, 0], **TOL)


def test_plain_bias_matches_attn_over_cache(rng):
    q, ck, cv, anc = _case(rng)
    bias = np.where(rng.random((R, 1, 1, T)) > 0.2, 0.0,
                    np.finfo(np.float32).min).astype(np.float32)
    bias[..., 0] = 0.0
    want = jgpt2._attn_over_cache(jnp.asarray(q)[:, :, None, :], jnp.asarray(ck[0]),
                                  jnp.asarray(cv[0]), T - 1, jnp.asarray(bias),
                                  jnp.asarray(anc))
    got = dec.decode_step_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                    torch.from_numpy(cv), 0, T - 1, torch.from_numpy(anc),
                                    attn_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, 0], **TOL)


def test_wrapper_rejects_other_devices():
    q = torch.zeros(R, H, DH, device="meta")
    ck = torch.zeros(L, R, H, T, DH, device="meta")
    before = tracing.counters()
    with pytest.raises(ValueError):
        dec.decode_step_attention(q, ck, ck, 0, 3)
    assert tracing.counters() == before

