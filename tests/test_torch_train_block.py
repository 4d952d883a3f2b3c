"""PyTorch port, gradient through the fused attention block (K1 forward, K3
backward): the port's autograd Function, which runs the plain versions on CPU
tensors, against jax.grad of the JAX package's Pallas block in interpret mode
(its custom_vjp runs the Pallas backward `_bwd_kernel`). K3 itself is held
against the plain backward on the card in tests/test_torch_kernels.py."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.ops import pallas_attention_block as jfab
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.ops import attention_block as fab

LEAVES = ("x", "scale", "bias", "w_qkv", "b_qkv", "w_out", "b_out")
# Relative to each gradient's largest element. fp32: the same math with the
# sums in another order (seen: <1e-6). bf16: both sides round h, qkv, p, dmg,
# ds and the outputs to bf16 (8 significant bits), and a different summation
# order can flip single roundings: about one bf16 step (2^-8) of headroom.
TOL = {np.float32: 1e-5, jnp.bfloat16: 1e-2}


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))


def _inputs(seed, b, t, d):
    gen = np.random.default_rng(seed)

    def arr(*shape, scale=1.0, offset=0.0):
        return (gen.standard_normal(shape) * scale + offset).astype(np.float32)

    vals = {"x": arr(b, t, d), "scale": arr(d, scale=0.1, offset=1.0),
            "bias": arr(d, scale=0.1), "w_qkv": arr(d, 3 * d, scale=d ** -0.5),
            "b_qkv": arr(3 * d, scale=0.1), "w_out": arr(d, d, scale=d ** -0.5),
            "b_out": arr(d, scale=0.1)}
    return vals, arr(b, t, d)


def _jax_grads(vals, w, h, causal, dtype):
    def loss(*leaves):
        x, s, bi, wq, bq, wo, bo = (a.astype(dtype) for a in leaves)
        out = jfab.fused_attention_block(x, {"scale": s, "bias": bi},
                                         {"w_qkv": wq, "b_qkv": bq, "w_out": wo, "b_out": bo},
                                         n_heads=h, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * w)

    args = [jnp.asarray(vals[k]) for k in LEAVES]
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=tuple(range(7)))(*args)]


def _torch_grads(vals, w, h, causal, dtype):
    leaves = [torch.from_numpy(vals[k]).requires_grad_() for k in LEAVES]
    x, s, bi, wq, bq, wo, bo = (a.to(dtype) for a in leaves)
    out = fab.fused_attention_block(x, {"scale": s, "bias": bi},
                                    {"w_qkv": wq, "b_qkv": bq, "w_out": wo, "b_out": bo},
                                    n_heads=h, causal=causal)
    assert out.grad_fn is not None
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [a.grad.numpy() for a in leaves]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 32, 2), (16, 8, 32, 2), (3, 50, 64, 4)],
                         ids=["small", "multi_tile", "t50"])
def test_block_gradients_match_pallas_interpret(shape, causal, dtype, interpret_mode):
    """b=16 runs the Pallas backward over two sequential grid steps, so its dLN
    sums are carried across tiles; the port sums over all rows at once."""
    b, t, d, h = shape
    vals, w = _inputs(b * t + d, b, t, d)
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    want = _jax_grads(vals, w, h, causal, dtype)
    got = _torch_grads(vals, w, h, causal, tdtype)
    for name, a, ref in zip(LEAVES, got, want):
        err = np.abs(a - ref).max() / np.abs(ref).max()
        assert err <= TOL[dtype], f"d{name}: relative max error {err}"


def test_trainable_params_get_gradients():
    """to_params(trainable=True) leaves require grad and receive .grad through
    the fused block; the serving default stays frozen."""
    vals, _ = _inputs(0, 2, 6, 16)
    tree = {"ln_1": {"scale": vals["scale"], "bias": vals["bias"]},
            "attn": {k: vals[k] for k in ("w_qkv", "b_qkv", "w_out", "b_out")}}
    frozen = convert.to_params(tree)
    assert not any(p.requires_grad for p in frozen.parameters())
    params = convert.to_params(tree, trainable=True)
    p = as_tree(params)
    out = fab.fused_attention_block(torch.from_numpy(vals["x"]), p["ln_1"], p["attn"],
                                    n_heads=2)
    out.square().sum().backward()
    for name, leaf in params.named_parameters():
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), name
        assert leaf.grad.abs().sum() > 0, name


def test_inference_mode_saves_nothing():
    vals, _ = _inputs(1, 2, 6, 16)
    args = [torch.from_numpy(vals[k]).requires_grad_() for k in LEAVES]
    with torch.inference_mode():
        out = fab.fused_attention_block(args[0], {"scale": args[1], "bias": args[2]},
                                        {"w_qkv": args[3], "b_qkv": args[4],
                                         "w_out": args[5], "b_out": args[6]}, n_heads=2)
    assert out.grad_fn is None
