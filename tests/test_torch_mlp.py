"""PyTorch port, fused MLP residual (K9): the plain version, which the wrapper
runs on CPU tensors, against the JAX package's Pallas MLP in interpret mode;
its gradient against jax.grad through the Pallas custom_vjp; and the towers and
a contrastive train step with USE_FUSED_MLP on in both packages. K9 itself is
held against the plain version on the card in tests/test_torch_kernels.py."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.core.configs import CLIPConfig as JCLIPConfig
from construction_clip_tpu.core.mesh import DATA_AXIS, MODEL_AXIS, create_mesh
from construction_clip_tpu.models import blocks as jblocks
from construction_clip_tpu.models import clip as jclip
from construction_clip_tpu.ops import attention as jattention
from construction_clip_tpu.ops import pallas_mlp as jmlp
from construction_clip_tpu.ops.activations import quick_gelu as j_quick_gelu
from construction_clip_tpu.train import contrastive as jcontrastive
from construction_clip_tpu.train import state as jstate
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.models import blocks
from construction_clip_tpu_torch.models.clip import model as clip
from construction_clip_tpu_torch.ops import mlp
from construction_clip_tpu_torch.ops.activations import quick_gelu
from construction_clip_tpu_torch.ops.attention import use_impl
from construction_clip_tpu_torch.train import contrastive, state

LEAVES = ("x", "scale", "bias", "w_fc", "b_fc", "w_proj", "b_proj")
# fp32: the same math with the GEMM and LN sums in another order
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
# gradients in fp32: the backward is autodiff of the same composable math on
# both sides (jax.vjp of _ref_math, torch.autograd.grad of its copy)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
# fp32 towers of two layers with the fused MLP: sums in another order
TOWER_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture
def fused_mlp_on(monkeypatch, interpret_mode):
    """USE_FUSED_MLP on in both packages, the JAX package on its Pallas path
    (interpret mode) and the port on its kernel path."""
    monkeypatch.setattr(jblocks, "USE_FUSED_MLP", True)
    monkeypatch.setattr(jattention, "_IMPL", "pallas")
    monkeypatch.setattr(blocks, "USE_FUSED_MLP", True)


def _inputs(seed, b, t, d, hidden):
    gen = np.random.default_rng(seed)

    def arr(*shape, scale=1.0, offset=0.0):
        return (gen.standard_normal(shape) * scale + offset).astype(np.float32)

    vals = {"x": arr(b, t, d), "scale": arr(d, scale=0.1, offset=1.0),
            "bias": arr(d, scale=0.1), "w_fc": arr(d, hidden, scale=d ** -0.5),
            "b_fc": arr(hidden, scale=0.1), "w_proj": arr(hidden, d, scale=hidden ** -0.5),
            "b_proj": arr(d, scale=0.1)}
    return vals, arr(b, t, d)


def _jax_call(vals, dtype):
    x, s, bi, wf, bf, wp, bp = (jnp.asarray(vals[k]).astype(dtype) for k in LEAVES)
    return jmlp.fused_mlp_residual(x, {"w_fc": wf, "b_fc": bf, "w_proj": wp, "b_proj": bp},
                                   {"scale": s, "bias": bi})


def _torch_args(vals, dtype):
    return [torch.from_numpy(vals[k]).to(dtype) for k in LEAVES]


SHAPES = [(2, 12, 32, 128), (3, 50, 64, 256), (1, 7, 48, 192)]


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "t50", "odd"])
def test_plain_matches_pallas_interpret_fp32(shape, interpret_mode):
    vals, _ = _inputs(sum(shape), *shape)
    want = np.asarray(_jax_call(vals, jnp.float32))
    got = mlp.fused_mlp_residual_plain(*_torch_args(vals, torch.float32))
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "t50", "odd"])
def test_plain_matches_pallas_op_by_op_bf16(shape, interpret_mode):
    """bf16: the Pallas kernel evaluated op by op (jax.disable_jit) rounds at
    the plain version's points; each element agrees to one bf16 step (the
    spacing of bf16 numbers at its magnitude), fp32 sums in another order
    being able to flip the output's rounding."""
    vals, _ = _inputs(sum(shape) + 1, *shape)
    with jax.disable_jit():
        want = np.asarray(_jax_call(vals, jnp.bfloat16).astype(jnp.float32))
    got = mlp.fused_mlp_residual_plain(*_torch_args(vals, torch.bfloat16)).float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= step), float((np.abs(got - want) / step).max())
    assert np.mean(got == want) > 0.99


def test_wrapper_runs_the_plain_version_on_cpu():
    vals, _ = _inputs(0, 2, 5, 16, 64)
    args = _torch_args(vals, torch.float32)
    before = tracing.counters()
    got = mlp.fused_mlp_residual(args[0], dict(zip(("w_fc", "b_fc", "w_proj", "b_proj"),
                                                   args[3:])),
                                 {"scale": args[1], "bias": args[2]})
    assert torch.equal(got, mlp.fused_mlp_residual_plain(*args))
    assert tracing.counters() == before


def test_ref_math_is_the_jax_ref_math():
    vals, _ = _inputs(3, 2, 6, 32, 128)
    want = jmlp._ref_math(*(jnp.asarray(vals[k]) for k in LEAVES), 1e-5)
    got = mlp._ref_math(*_torch_args(vals, torch.float32), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("shape", [(2, 12, 32, 128), (3, 50, 64, 256)], ids=["small", "t50"])
def test_gradients_match_jax_grad(shape, interpret_mode):
    vals, w = _inputs(7 + sum(shape), *shape)

    def loss(*leaves):
        x, s, bi, wf, bf, wp, bp = leaves
        out = jmlp.fused_mlp_residual(x, {"w_fc": wf, "b_fc": bf, "w_proj": wp, "b_proj": bp},
                                      {"scale": s, "bias": bi})
        return jnp.sum(out * w)

    want = jax.grad(loss, argnums=tuple(range(7)))(*(jnp.asarray(vals[k]) for k in LEAVES))
    leaves = [torch.from_numpy(vals[k]).requires_grad_() for k in LEAVES]
    x, s, bi, wf, bf, wp, bp = leaves
    out = mlp.fused_mlp_residual(x, {"w_fc": wf, "b_fc": bf, "w_proj": wp, "b_proj": bp},
                                 {"scale": s, "bias": bi})
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for name, leaf, ref in zip(LEAVES, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), err_msg=name,
                                   **GRAD_TOL)


def test_backward_returns_only_the_gradients_asked_for():
    vals, _ = _inputs(4, 2, 5, 16, 64)
    args = _torch_args(vals, torch.float32)
    args[3].requires_grad_()   # w_fc alone
    out = mlp._FusedMLP.apply(*args, 1e-5)
    (grad,) = torch.autograd.grad(out.sum(), [args[3]])
    assert grad.shape == args[3].shape and torch.isfinite(grad).all()
    with torch.inference_mode():
        assert mlp._FusedMLP.apply(*args, 1e-5).grad_fn is None


def test_supported_gates():
    w = torch.zeros(32, 128)
    assert mlp.supported(torch.zeros(2, 5, 32), w)
    assert mlp.supported(torch.zeros(2, 5, 32, dtype=torch.bfloat16), w)
    assert mlp.supported(torch.zeros(2, 257, 1024), torch.zeros(1024, 4096))   # no VMEM bound
    assert not mlp.supported(torch.zeros(10, 32), w)
    assert not mlp.supported(torch.zeros(2, 5, 32, dtype=torch.float16), w)


def test_wrapper_rejects_other_devices():
    vals, _ = _inputs(5, 2, 4, 8, 32)
    args = _torch_args(vals, torch.float32)
    before = tracing.counters()
    with pytest.raises(ValueError):
        mlp.fused_mlp_residual_fwd(args[0].to("meta"), *args[1:])
    assert tracing.counters() == before


@pytest.mark.parametrize("case", ["on", "off", "plain_impl", "gelu"])
def test_blocks_take_the_fused_mlp_where_jax_does(case, monkeypatch):
    """USE_FUSED_MLP on, QuickGELU and the kernel impl: the MLP half is the
    fused residual; otherwise the composable path."""
    calls = []
    orig = mlp.fused_mlp_residual
    monkeypatch.setattr(mlp, "fused_mlp_residual",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    monkeypatch.setattr(blocks, "USE_FUSED_MLP", case != "off")
    vals, _ = _inputs(6, 2, 5, 16, 64)
    params = {"ln_2": {"scale": torch.from_numpy(vals["scale"]),
                       "bias": torch.from_numpy(vals["bias"])},
              "mlp": {k: torch.from_numpy(vals[k]) for k in ("w_fc", "b_fc", "w_proj",
                                                              "b_proj")}}
    act = torch.nn.functional.gelu if case == "gelu" else quick_gelu
    with use_impl("plain" if case == "plain_impl" else "kernel"):
        out = blocks._mlp_residual(torch.from_numpy(vals["x"]), params, act, 1e-5)
    assert len(calls) == (case == "on")
    assert out.shape == (2, 5, 16)


@pytest.mark.parametrize("causal", [False, True])
def test_apply_stack_with_fused_mlp_matches_jax(causal, fused_mlp_on):
    gen = np.random.default_rng(11)
    stacked = jblocks.init_stack(jax.random.key(1), 2, 32)
    x = gen.standard_normal((3, 9, 32)).astype(np.float32)
    want = jblocks.apply_stack(stacked, jnp.asarray(x), n_heads=4, act=j_quick_gelu,
                               is_causal=causal)
    got = blocks.apply_stack(convert.to_params(stacked).tree(), torch.from_numpy(x), n_heads=4,
                             act=quick_gelu, is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER_TOL)


@pytest.fixture(scope="module")
def tiny_clip():
    jparams = jclip.init_clip(jax.random.key(2), JCLIPConfig.tiny())
    return jparams, convert.to_params(jparams).tree()


@pytest.mark.parametrize("tower", ["image", "text"])
def test_towers_with_fused_mlp_match_jax(tower, tiny_clip, fused_mlp_on, monkeypatch):
    jparams, tparams = tiny_clip
    cfg, jcfg = CLIPConfig.tiny(), JCLIPConfig.tiny()
    calls = []
    orig = mlp.fused_mlp_residual
    monkeypatch.setattr(mlp, "fused_mlp_residual",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    gen = np.random.default_rng(12)
    if tower == "image":
        x = gen.standard_normal((3, 32, 32, 3)).astype(np.float32)
        want = jclip.encode_image(jparams, jcfg, jnp.asarray(x), normalize=True)
        got = clip.encode_image(tparams, cfg, torch.from_numpy(x), normalize=True)
        layers = cfg.vision.layers
    else:
        toks = gen.integers(1, cfg.text.vocab_size - 1, (4, cfg.text.context_length))
        toks[:, 5] = cfg.text.vocab_size - 1
        toks = toks.astype(np.int32)
        want = jclip.encode_text(jparams, jcfg, jnp.asarray(toks), normalize=True)
        got = clip.encode_text(tparams, cfg, torch.from_numpy(toks), normalize=True)
        layers = cfg.text.layers
    assert len(calls) == layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER_TOL)


def test_train_steps_with_fused_mlp_match_jax(fused_mlp_on):
    """3 contrastive steps with the fused MLP in every block of both towers,
    from the same params and batches, fp32: the loss to 1e-5 relative, equal
    accuracy, and the updated params as tests/test_torch_train.py holds them
    (the key bias, whose gradient is mathematically zero, to 2 lr a step)."""
    cfg, jcfg = CLIPConfig.tiny(), JCLIPConfig.tiny()
    jparams = jclip.init_clip(jax.random.key(3), jcfg)
    kw = dict(warmup_steps=0, total_steps=100)
    jtx, ttx = jstate.make_adamw(1e-4, **kw), state.make_adamw(1e-4, **kw)
    mesh = create_mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, devices=jax.devices()[:1])
    jstep = jcontrastive.make_train_step(jcfg, jtx, mesh)
    tstep = contrastive.make_train_step(cfg, ttx)
    jst = jstate.TrainState.create(jparams, jtx)
    tst = state.TrainState.create(convert.to_params(jparams, trainable=True), ttx)
    gen = np.random.default_rng(13)
    for _ in range(3):
        images = gen.standard_normal((4, 32, 32, 3)).astype(np.float32)
        tokens = gen.integers(1, cfg.text.vocab_size, (4, cfg.text.context_length),
                              dtype=np.int32)
        jst, jm = jstep(jst, {"images": jnp.asarray(images), "tokens": jnp.asarray(tokens)})
        tst, tm = tstep(tst, {"images": torch.from_numpy(images),
                              "tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    got = as_tree(tst.params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jst.params)
    for tower in ("vision", "text"):
        d = want[tower]["blocks"]["attn"]["b_qkv"].shape[-1] // 3
        key_bias = (slice(None), slice(d, 2 * d))
        np.testing.assert_allclose(
            got[tower]["blocks"]["attn"]["b_qkv"][key_bias].detach().numpy(),
            want[tower]["blocks"]["attn"]["b_qkv"][key_bias], rtol=0, atol=2 * 3 * 1e-4)
        for name in ("w_fc", "b_fc", "w_proj", "b_proj"):
            np.testing.assert_allclose(got[tower]["blocks"]["mlp"][name].detach().numpy(),
                                       want[tower]["blocks"]["mlp"][name], rtol=0, atol=2e-6,
                                       err_msg=f"{tower} {name}")
