"""PyTorch port, plain ops: layer_norm, activations, mha and qkv_attention
against the JAX package on the same inputs (CPU, fp32)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.ops import activations as jact
from construction_clip_tpu.ops import attention as jattn
from construction_clip_tpu.ops import norms as jnorms
from construction_clip_tpu_torch.core.precision import (
    BF16_POLICY, DEFAULT_POLICY, policy_from_name)
from construction_clip_tpu_torch.ops import activations, attention, norms

# Elementwise ops: XLA's and PyTorch's CPU transcendentals and reductions may
# differ by a few fp32 ulps.
ELEM = dict(rtol=1e-5, atol=1e-6)
# Attention: fp32 sums over the head and key axes taken in another order.
ATTN = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("shape", [(3, 5, 32), (2, 64)])
def test_layer_norm(shape, rng):
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=1e-5)
    got = norms.layer_norm(t(x), t(s), t(b), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ELEM)


def test_layer_norm_bf16_keeps_dtype(rng):
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    ones, zeros = torch.ones(16), torch.zeros(16)
    got = norms.layer_norm(x.bfloat16(), ones.bfloat16(), zeros.bfloat16())
    assert got.dtype == torch.bfloat16
    # statistics in fp32, one rounding to bf16 at the end: within a bf16 step
    ref = norms.layer_norm(x.bfloat16().float(), ones, zeros)
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("name", ["quick_gelu", "gelu_new"])
def test_activations(name, rng):
    x = rng.standard_normal((7, 33)).astype(np.float32) * 4
    want = getattr(jact, name)(jnp.asarray(x))
    got = getattr(activations, name)(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ELEM)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_mha(causal, with_bias, rng):
    q, k, v = (rng.standard_normal((2, 3, 7, 8)).astype(np.float32) for _ in range(3))
    bias = None
    if with_bias:
        mask = rng.random((2, 7)) > 0.3
        mask[:, 0] = True
        bias = np.asarray(jattn.make_attention_bias(jnp.asarray(mask)))
    want = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bias=None if bias is None else jnp.asarray(bias),
                     is_causal=causal, impl="xla")
    got = attention.mha(t(q), t(k), t(v), bias=None if bias is None else t(bias),
                        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


def test_split_merge_heads(rng):
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    heads = attention.split_heads(t(x), 3)
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jattn.split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(attention.merge_heads(heads).numpy(), x)


@pytest.mark.parametrize("causal", [False, True])
def test_qkv_attention(causal, rng):
    d, h = 16, 2
    params = {"w_qkv": rng.standard_normal((d, 3 * d)).astype(np.float32) * d ** -0.5,
              "b_qkv": rng.standard_normal(3 * d).astype(np.float32) * 0.1,
              "w_out": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
              "b_out": rng.standard_normal(d).astype(np.float32) * 0.1}
    x = rng.standard_normal((3, 6, d)).astype(np.float32)
    want = jattn.qkv_attention(jnp.asarray(x), jax.tree.map(jnp.asarray, params), h,
                               is_causal=causal, impl="xla")
    got = attention.qkv_attention(t(x), {k: t(v) for k, v in params.items()}, h,
                                  is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


def test_impl_switch_restores():
    assert attention.resolve_impl() == "kernel"
    with attention.use_impl("plain"):
        assert attention.resolve_impl() == "plain"
    assert attention.resolve_impl() == "kernel"
    with pytest.raises(ValueError):
        attention.set_impl("xla")


def test_policy_casts_floating_leaves_only():
    tree = {"w": torch.ones(2, 2), "ids": torch.arange(3), "sub": {"b": torch.zeros(2)}}
    cast = BF16_POLICY.cast_to_compute(tree)
    assert cast["w"].dtype == torch.bfloat16 and cast["sub"]["b"].dtype == torch.bfloat16
    assert cast["ids"].dtype == torch.int64
    same = DEFAULT_POLICY.cast_to_compute(tree)
    assert same["w"] is tree["w"]  # already in the compute dtype: no copy


def test_policy_from_name():
    assert policy_from_name("fp32") is DEFAULT_POLICY
    assert policy_from_name("float32") is DEFAULT_POLICY
    assert policy_from_name("bf16") is BF16_POLICY
    assert policy_from_name("bfloat16") is BF16_POLICY
    with pytest.raises(KeyError):   # no device-dependent choice: the caller names it
        policy_from_name("auto")
    assert torch.backends.cuda.matmul.allow_tf32 is False
