"""PyTorch port, rematerialisation (models/blocks.apply_stack(remat=...) and
its pass-throughs) against the port without remat and against the JAX
package's jax.checkpoint policies (CPU, fp32): loss and gradients of every
policy on the K1 route (T <= 256, K1's plain version) and on the flash route
(T = 257), causal and not; the tensors each policy keeps for the backward,
measured through torch.autograd.graph.saved_tensors_hooks; and two steps of
make_train_step and make_caption_train_step with remat."""

import dataclasses
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from construction_clip_tpu.core import configs as jconfigs
from construction_clip_tpu.core.mesh import DATA_AXIS, MODEL_AXIS, create_mesh
from construction_clip_tpu.models.blocks import apply_stack as japply_stack
from construction_clip_tpu.models.blocks import init_stack
from construction_clip_tpu.models.clip import init_clip
from construction_clip_tpu.models.clipcap import model as jclipcap
from construction_clip_tpu.ops.activations import quick_gelu as jquick_gelu
from construction_clip_tpu.train import caption as jcaption
from construction_clip_tpu.train import contrastive as jcontrastive
from construction_clip_tpu.train import state as jstate
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import (
    CLIPConfig, ClipCapConfig, GPT2Config, TextConfig, VisionConfig)
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.models import blocks
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import flash_attention as fa
from construction_clip_tpu_torch.ops.activations import quick_gelu
from construction_clip_tpu_torch.train import caption, contrastive, state

POLICIES = [True, "dots", "save_qkv", "save_mlp_hidden", "save_qkv_mlp",
            "save_qkv_attn_out", "save_preact", "save_attn_preact", "save_big"]
L, B, D, H = 2, 2, 32, 4
# route -> (T, causal); the other two (T, causal) pairs run in
# test_the_other_masks_match_no_remat
ROUTES = {"k1": (10, True), "flash": (257, False)}


def _stack(seed):
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        init_stack(jax.random.key(seed), layers=L, width=D))


def _x(t, seed=1):
    return np.random.default_rng(seed).standard_normal((B, t, D)).astype(np.float32)


def _port(jparams, x, remat, causal):
    """(loss, grads as numpy leaves in tree order) of sum(out^2)."""
    params = convert.to_params(jparams, trainable=True)
    out = blocks.apply_stack(as_tree(params), torch.from_numpy(x), n_heads=H, act=quick_gelu,
                             is_causal=causal, remat=remat)
    loss = out.square().sum()
    loss.backward()
    return float(loss.detach()), [p.grad.numpy() for p in tree_leaves(as_tree(params))]


def _assert_grads_close(got, want, rel):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_policy_matches_no_remat_and_jax(policy, route):
    """The port's gradients under each policy are the port's without remat,
    bit for bit (the same ops in the same order; x1 keeps its two consumers);
    and JAX's value_and_grad under the same policy within 1e-6 of each leaf's
    largest element (the two packages sum in other orders, ~1e-7)."""
    t, causal = ROUTES[route]
    jparams, x = _stack(0), _x(t)
    assert (route == "k1") == fab.supported(torch.from_numpy(x), H)
    loss, grads = _port(jparams, x, policy, causal)
    base_loss, base = _port(jparams, x, False, causal)
    assert loss == base_loss
    for a, b in zip(grads, base):
        np.testing.assert_array_equal(a, b)

    def jloss(p):
        out = japply_stack(p, jnp.asarray(x), n_heads=H, act=jquick_gelu, is_causal=causal,
                           remat=policy, unroll=1)
        return jnp.sum(out * out)

    want_loss, want = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)
    _assert_grads_close(grads, [np.asarray(a) for a in tree_leaves(want)], 1e-6)


@pytest.mark.parametrize("t,causal", [(10, False), (257, True)])
def test_the_other_masks_match_no_remat(t, causal):
    jparams, x = _stack(2), _x(t, 3)[:1]
    base_loss, base = _port(jparams, x, False, causal)
    for policy in POLICIES:
        loss, grads = _port(jparams, x, policy, causal)
        assert loss == base_loss
        for a, b in zip(grads, base):
            np.testing.assert_array_equal(a, b)


def test_an_unknown_policy_raises_and_remat_refuses_the_probes():
    jparams, x = _stack(0), torch.from_numpy(_x(10))
    params = as_tree(convert.to_params(jparams))
    with pytest.raises(KeyError):
        blocks.apply_stack(params, x, n_heads=H, act=quick_gelu, remat="save_everything")
    with pytest.raises(ValueError, match="remat"):
        blocks.apply_stack(params, x, n_heads=H, act=quick_gelu, remat=True, return_probs=True)


# Per layer, in units of B x T x D elements: the layer's input (1), qkv (3),
# attn_out (1), mlp_preact (4), mlp_hidden (4); "dots" the products the
# backward reads: the qkv (3), out (1) and fc (4) projections' (the proj's
# product only meets its bias add, which needs nothing, as under JAX's
# checkpoint_dots). On the K1 route qkv and the attention's products do not
# exist, and attn_out is K1's output.
SAVED_UNITS = {
    "k1": {True: 1, "dots": 5, "save_qkv": 1, "save_mlp_hidden": 5, "save_qkv_mlp": 5,
           "save_qkv_attn_out": 2, "save_preact": 5, "save_attn_preact": 6, "save_big": 6},
    "flash": {True: 1, "dots": 9, "save_qkv": 4, "save_mlp_hidden": 5, "save_qkv_mlp": 8,
              "save_qkv_attn_out": 5, "save_preact": 5, "save_attn_preact": 6, "save_big": 9},
}


def _saved_bytes(params, x, remat, causal):
    """Bytes of the distinct storages that autograd keeps for the backward
    across the stack, the parameters' own storages aside: those packed by
    saved_tensors_hooks that are still alive while the output is (a
    checkpoint whose ops need nothing in the backward, like a bias add's,
    drops its inputs)."""
    own = {p.untyped_storage().data_ptr() for p in tree_leaves(params)}
    packed = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in own:
            packed.append(weakref.ref(t))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = blocks.apply_stack(params, x, n_heads=H, act=quick_gelu, is_causal=causal,
                                 remat=remat)
    alive = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
             for t in (ref() for ref in packed) if t is not None}
    del out
    return sum(alive.values())


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_policy_saves_what_its_names_predict(route):
    """save_preact keeps the layer inputs and L x B x T x 4D of pre-activations
    and nothing of qkv, and so on (SAVED_UNITS). Every policy saves less than
    no remat and, but for save_qkv on the K1 route (where qkv never exists, so
    it is full remat), more than full remat."""
    t, causal = ROUTES[route]
    params = as_tree(convert.to_params(_stack(0), trainable=True))
    x = torch.from_numpy(_x(t))
    unit = L * B * t * D * 4
    full = _saved_bytes(params, x, True, causal)
    none = _saved_bytes(params, x, False, causal)
    assert full == unit
    for policy, units in SAVED_UNITS[route].items():
        got = _saved_bytes(params, x, policy, causal)
        assert got == units * unit, (policy, got / unit)
        assert got < none
        if policy is not True:
            assert got > full or (route == "k1" and policy == "save_qkv")


# ---- train steps -----------------------------------------------------------------------

# vision T = (34/2)^2 + 1 = 290: the image tower on the flash route, the text tower on K1's
LONG_T = CLIPConfig(
    vision=VisionConfig(image_size=34, patch_size=2, width=32, layers=1, heads=2, embed_dim=16),
    text=TextConfig(vocab_size=64, context_length=8, width=32, layers=1, heads=2, embed_dim=16))
LR = 1e-4


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy() if isinstance(t, torch.Tensor)
                    else np.asarray(t, np.float32).copy(), tree)


def _tree_close(got, want, atol, key_bias_atol, path=""):
    """Every leaf within `atol`; the key third of an attention bias (its
    gradient is rounding noise, which AdamW normalises into updates of up to
    lr) within `key_bias_atol`."""
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k], atol, key_bias_atol, f"{path}/{k}")
        return
    if path.endswith(("/attn/c_attn_b", "/attn/b_qkv")):
        d = want.shape[-1] // 3
        np.testing.assert_allclose(got[..., d:2 * d], want[..., d:2 * d], rtol=0,
                                   atol=key_bias_atol, err_msg=path)
        got, want = np.delete(got, np.s_[d:2 * d], -1), np.delete(want, np.s_[d:2 * d], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=path)


def _jax_mesh():
    return create_mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, devices=jax.devices()[:1])


def test_contrastive_steps_with_remat_match_no_remat_and_jax():
    """Two make_train_step steps with remat True and "save_preact": the params
    bit-equal to remat=False's, and within 2e-6 of JAX's steps under the same
    remat (the key bias within 2 lr a step)."""
    cfg = LONG_T
    jcfg = jconfigs.CLIPConfig(vision=cfg.vision, text=cfg.text)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), init_clip(jax.random.key(5), jcfg))
    kw = dict(warmup_steps=0, total_steps=100)
    gen = np.random.default_rng(8)
    batches = [{"images": gen.standard_normal((3, 34, 34, 3)).astype(np.float32),
                "tokens": gen.integers(1, 64, (3, 8), dtype=np.int32)} for _ in range(2)]
    finals = {}
    for remat in (False, True, "save_preact"):
        tx = state.make_adamw(LR, **kw)
        st = state.TrainState.create(convert.to_params(jparams, trainable=True), tx)
        step = contrastive.make_train_step(cfg, tx, remat=remat)
        losses = []
        for batch in batches:
            st, m = step(st, {k: torch.from_numpy(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
        finals[remat] = (losses, _np(as_tree(st.params)))
    for remat in (True, "save_preact"):
        assert finals[remat][0] == finals[False][0]
        _tree_close(finals[remat][1], finals[False][1], 0, 0)
        jtx = jstate.make_adamw(LR, **kw)
        jstep = jcontrastive.make_train_step(jcfg, jtx, _jax_mesh(), remat=remat)
        jst = jstate.TrainState.create(jax.tree.map(jnp.asarray, jparams), jtx)
        for i, batch in enumerate(batches):
            jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
            np.testing.assert_allclose(finals[remat][0][i], float(jm["loss"]), rtol=1e-5)
        _tree_close(finals[remat][1], _np(jst.params), 2e-6, 2 * 2 * LR)


def test_caption_steps_with_remat_match_no_remat_and_jax():
    """Two full fine-tune make_caption_train_step steps with remat=True (GPT-2
    checkpointed layer by layer): bit-equal to remat=False's, and within 2e-6
    of JAX's remat step (the key bias within 2 lr a step)."""
    gcfg = GPT2Config.tiny()
    ccfg = ClipCapConfig(prefix_length=4, attribute_length=3, clip_dim=16, only_prefix=False)
    jgcfg, jccfg = jconfigs.GPT2Config.tiny(), jconfigs.ClipCapConfig(**dataclasses.asdict(ccfg))
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           jclipcap.init_clipcap(jax.random.key(3), jccfg, jgcfg))
    gen = np.random.default_rng(12)
    batches = []
    for _ in range(2):
        tokens = gen.integers(1, gcfg.vocab_size, (3, 6)).astype(np.int32)
        tokens[1, 4:] = 0
        batches.append({"tokens": tokens,
                        "prefix": gen.standard_normal((3, 16)).astype(np.float32),
                        "attribute": gen.integers(1, gcfg.vocab_size, (3, 3)).astype(np.int32)})
    kw = dict(warmup_steps=0, total_steps=100)
    finals = {}
    for remat in (False, True):
        tx = state.make_adamw(LR, **kw)
        st = state.TrainState.create(convert.to_params(jparams, trainable=True), tx)
        step = caption.make_caption_train_step(ccfg, gcfg, tx, remat=remat)
        losses = []
        for batch in batches:
            st, m = step(st, None, {k: torch.from_numpy(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
        finals[remat] = (losses, _np(as_tree(st.params)))
    assert finals[True][0] == finals[False][0]
    _tree_close(finals[True][1], finals[False][1], 0, 0)
    jtx = jstate.make_adamw(LR, **kw)
    jstep = jcaption.make_caption_train_step(jccfg, jgcfg, jtx, _jax_mesh(), remat=True)
    jst = jstate.TrainState.create(jax.tree.map(jnp.asarray, jparams), jtx)
    for i, batch in enumerate(batches):
        jst, jm = jstep(jst, None, {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(finals[True][0][i], float(jm["loss"]), rtol=1e-5)
    _tree_close(finals[True][1], _np(jst.params), 2e-6, 2 * 2 * LR)


def test_remat_reruns_the_kernels_forward_in_the_backward(monkeypatch):
    """Counted on the wrappers' plain versions: full remat runs each layer's
    K1 (K1 route) or K4 (flash route) forward once more in the backward, and
    save_big, which keeps K1's output, does not re-run K1."""
    calls = {"k1": 0, "k4": 0}
    k1, k4 = fab.fused_attention_block_plain, fa.flash_attention_fwd_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fab, "fused_attention_block_plain", count("k1", k1))
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", count("k4", k4))
    for route, kernel in (("k1", "k1"), ("flash", "k4"), ("k1_save_big", "k1")):
        t, causal = ROUTES[route.split("_")[0]]
        remat = "save_big" if route.endswith("save_big") else True
        params = as_tree(convert.to_params(_stack(0), trainable=True))
        counts = []
        for r in (False, remat):
            calls[kernel] = 0
            blocks.apply_stack(params, torch.from_numpy(_x(t)), n_heads=H, act=quick_gelu,
                               is_causal=causal, remat=r).sum().backward()
            counts.append(calls[kernel])
        assert counts == [L, L if remat == "save_big" else 2 * L], (route, counts)
