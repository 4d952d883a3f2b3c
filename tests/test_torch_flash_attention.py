"""PyTorch port, flash attention (K4 forward, K5 backward): the plain versions,
which the wrappers run on CPU tensors, against the JAX package's Pallas kernels
in interpret mode (`flash_attention` for the forward, `_bwd_pallas` for the
backward), T=257 (the ViT-L/14 image tower) included; the gradient through the
port's autograd Function against jax.grad; and the route a transformer block
takes through ops/attention. K4 and K5 themselves are held against the plain
versions on the card in tests/test_torch_kernels.py."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.ops import pallas_attention as jpa
from construction_clip_tpu_torch.models import blocks
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import flash_attention as fa
from construction_clip_tpu_torch.ops.activations import quick_gelu

# fp32 on both sides, the sums in another order; bf16: one rounding of p (fwd)
# or of the outputs, which a different order can flip by one bf16 step.
TOL = {np.float32: dict(rtol=2e-5, atol=2e-5), jnp.bfloat16: dict(rtol=1e-2, atol=1e-2)}
SHAPES = [(2, 2, 12, 16), (1, 2, 257, 16), (2, 1, 70, 32)]


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))


def _qkvg(shape, seed):
    gen = np.random.default_rng(seed)
    return [gen.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _t(a, dtype):
    return torch.from_numpy(a).to(torch.float32 if dtype == np.float32 else torch.bfloat16)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["t12", "t257", "t70"])
def test_forward_plain_matches_pallas_interpret(shape, causal, dtype, interpret_mode):
    q, k, v, _ = _qkvg(shape, 1)
    scale = shape[-1] ** -0.5
    want = jpa.flash_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                               is_causal=causal, scale=scale)
    got = fa.flash_attention(*(_t(a, dtype) for a in (q, k, v)), is_causal=causal,
                             scale=scale)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["t12", "t257", "t70"])
def test_backward_plain_matches_pallas_interpret(shape, causal, dtype):
    q, k, v, g = _qkvg(shape, 2)
    scale = shape[-1] ** -0.5
    want = jpa._bwd_pallas(*(jnp.asarray(a, dtype) for a in (q, k, v, g)), causal, scale,
                           interpret=True)
    got = fa.flash_attention_bwd(*(_t(a, dtype) for a in (q, k, v, g)), is_causal=causal,
                                 scale=scale)
    for a, b in zip(got, want):
        _close(a, b, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_gradient_matches_jax_grad(causal, interpret_mode):
    q, k, v, w = _qkvg((2, 2, 257, 16), 3)

    def jloss(q, k, v):
        return jnp.sum(jpa.flash_attention(q, k, v, is_causal=causal) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, is_causal=causal)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for a, b in zip(leaves, want):
        _close(a.grad, b, np.float32)


def test_supported_gates():
    x = torch.zeros(2, 4, 290, 64)
    assert fa.supported(x, x, x)
    assert not fa.supported(x, x, x, bias=torch.zeros(2, 1, 1, 290))
    assert not fa.supported(x[:, :, :1], x, x)                       # cross-length
    assert not fa.supported(*[torch.zeros(1, 1, 1025, 64)] * 3)       # T > 1024
    assert not fa.supported(*[torch.zeros(1, 1, 8, 256)] * 3)         # dh over the tiles
    assert not fa.supported(*[torch.zeros(1, 1, 8, 64, dtype=torch.float16)] * 3)


@pytest.mark.parametrize("t, bias, route", [(17, False, "fused"), (290, False, "flash"),
                                            (17, True, "plain")])
def test_block_route(t, bias, route, monkeypatch):
    """A ViT block takes the fused block (K1/K3) where its gate admits T, flash
    attention (K4/K5) beyond T=256, and the plain path with an attention bias."""
    calls = []
    for mod, name in ((fab, "fused_attention_block"), (fa, "flash_attention")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    d, h = 32, 2
    gen = np.random.default_rng(4)
    p = {"ln_1": {"scale": torch.ones(d), "bias": torch.zeros(d)},
         "ln_2": {"scale": torch.ones(d), "bias": torch.zeros(d)},
         "attn": {"w_qkv": torch.randn(d, 3 * d, generator=torch.Generator().manual_seed(0)),
                  "b_qkv": torch.zeros(3 * d), "w_out": torch.eye(d), "b_out": torch.zeros(d)},
         "mlp": {"w_fc": torch.eye(d), "b_fc": torch.zeros(d), "w_proj": torch.eye(d),
                 "b_proj": torch.zeros(d)}}
    x = torch.from_numpy(gen.standard_normal((2, t, d)).astype(np.float32))
    mask = torch.zeros(2, 1, 1, t) if bias else None
    out = blocks.apply_block(p, x, n_heads=h, act=quick_gelu, bias=mask)
    assert out.shape == x.shape
    want = {"fused": ["fused_attention_block"], "flash": ["flash_attention"], "plain": []}
    assert calls == want[route]
