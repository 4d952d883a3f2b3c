"""PyTorch port, fused attention block (K1): the plain version, which the wrapper
runs on CPU tensors, against the JAX package's Pallas block in interpret mode and
against its composable reference `_ref_math`. The CUDA kernel is held against
the plain version on the card in tests/test_torch_kernels.py."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.models.blocks import init_block
from construction_clip_tpu.ops import pallas_attention_block as jfab
from construction_clip_tpu_torch.ops import attention_block as fab

# fp32 on both sides; the only difference is the order of the fp32 sums
# (the JAX package's own interpret-mode test uses the same bound).
TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))


def _case(seed, b, t, d, rng):
    params = init_block(jax.random.key(seed), d)
    # non-trivial LN affine and biases, so every term of the block is exercised
    params["ln_1"] = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(d), jnp.float32),
                      "bias": jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)}
    params["attn"]["b_qkv"] = jnp.asarray(0.1 * rng.standard_normal(3 * d), jnp.float32)
    params["attn"]["b_out"] = jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    ln = {k: torch.from_numpy(np.array(v)) for k, v in params["ln_1"].items()}
    attn = {k: torch.from_numpy(np.array(v)) for k, v in params["attn"].items()}
    return params, x, ln, attn


def _ref(params, x, h, causal):
    p = params
    return jfab._ref_math(jnp.asarray(x), p["ln_1"]["scale"], p["ln_1"]["bias"],
                          p["attn"]["w_qkv"], p["attn"]["b_qkv"], p["attn"]["w_out"],
                          p["attn"]["b_out"], h, causal, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(4, 12, 32, 2), (2, 50, 64, 4)])
def test_plain_matches_pallas_interpret(causal, shape, rng, interpret_mode):
    b, t, d, h = shape
    params, x, ln, attn = _case(0, b, t, d, rng)
    want = jfab.fused_attention_block(jnp.asarray(x), params["ln_1"], params["attn"],
                                      n_heads=h, causal=causal)
    got = fab.fused_attention_block(torch.from_numpy(x), ln, attn, n_heads=h, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_ref_math(causal, rng):
    params, x, ln, attn = _case(1, 3, 16, 32, rng)
    got = fab.fused_attention_block(torch.from_numpy(x), ln, attn, n_heads=4, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(_ref(params, x, 4, causal)), **TOL)


def test_supported_gates():
    assert fab.supported(torch.zeros(4, 12, 32), 2)
    assert not fab.supported(torch.zeros(4, 12, 33), 2)             # heads don't divide
    assert not fab.supported(torch.zeros(4, 512, 32), 2)            # T too long
    assert not fab.supported(torch.zeros(4, 12, 32, dtype=torch.int8), 2)
    assert fab.supported(torch.zeros(1, 256, 768), 12)              # ViT-L/14 text width
    # T=256 with Dh=128: K and V of one head no longer fit a block's shared memory
    assert not fab.supported(torch.zeros(1, 256, 256), 2)


def test_wrapper_rejects_other_devices():
    x = torch.zeros(2, 4, 8, device="meta")
    ln = {"scale": torch.ones(8), "bias": torch.zeros(8)}
    attn = {"w_qkv": torch.zeros(8, 24), "b_qkv": torch.zeros(24),
            "w_out": torch.zeros(8, 8), "b_out": torch.zeros(8)}
    before = fab.fused_attention_block.launches
    with pytest.raises(ValueError):
        fab.fused_attention_block(x, ln, attn, n_heads=2)
    assert fab.fused_attention_block.launches == before

