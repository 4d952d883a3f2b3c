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



def test_the_gpt2_mapper_width_takes_the_simt_route_at_dh_96():
    """GPT-2's transformer mapper (width 768, 8 heads: dh 96, T = 10 + 20 rows)
    passes the gate, with K1's shared memory for dh 96 under Hopper's limit,
    and takes the SIMT chain on the card in bf16 and fp32; mT5's (width 512,
    8 heads) takes the tensor cores in bf16."""
    assert fab.supported(torch.zeros(16, 30, 768), 8)
    assert fab.attention_smem_bytes(30, 96) <= fab.MAX_SMEM_BYTES
    assert fab.route(torch.bfloat16, 96) == fab.route(torch.float32, 96) == "simt"
    assert fab.route(torch.bfloat16, 512 // 8) == "tc"


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_and_backward_at_dh_96_match_jax(causal, interpret_mode):
    """K1's and K3's plain versions at a head width of 96 (2 heads of 96):
    the forward against the Pallas block in interpret mode, the gradients of
    every input through the autograd Function against jax.grad of the
    block's reference math."""
    b, t, d, h = 2, 30, 192, 2
    rng = np.random.default_rng(96)
    params, x, ln, attn = _case(2, b, t, d, rng)
    want = jfab.fused_attention_block(jnp.asarray(x), params["ln_1"], params["attn"],
                                      n_heads=h, causal=causal)
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        a.clone().requires_grad_() for a in (ln["scale"], ln["bias"], attn["w_qkv"],
                                             attn["b_qkv"], attn["w_out"], attn["b_out"])]
    got = fab.fused_attention_block(leaves[0], {"scale": leaves[1], "bias": leaves[2]},
                                    {"w_qkv": leaves[3], "b_qkv": leaves[4],
                                     "w_out": leaves[5], "b_out": leaves[6]},
                                    n_heads=h, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    g = rng.standard_normal((b, t, d)).astype(np.float32)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))

    def loss(*a):
        return jnp.sum(jfab._ref_math(*a, h, causal, 1e-5) * g)

    jargs = (jnp.asarray(x), params["ln_1"]["scale"], params["ln_1"]["bias"],
             params["attn"]["w_qkv"], params["attn"]["b_qkv"], params["attn"]["w_out"],
             params["attn"]["b_out"])
    jgrads = jax.grad(loss, argnums=tuple(range(7)))(*jargs)
    for a, w in zip(grads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
