"""PyTorch port, CLIP towers and zero-shot classification against the JAX
package on the same (converted) params and inputs (CPU, fp32), plus the
numpy-seeded initialisers against the JAX initialisers' tree shapes."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.infer.precompute import make_embed_classify_fn as j_embed_classify
from construction_clip_tpu.models import clip as jclip
from construction_clip_tpu.models.clip.model import patchify as j_patchify
from construction_clip_tpu.models.clipcap import init_clipcap as j_init_clipcap
from construction_clip_tpu.models.gpt2 import init_gpt2 as j_init_gpt2
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import CLIPConfig, ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.params import tree_map
from construction_clip_tpu_torch.core.precision import BF16_POLICY
from construction_clip_tpu_torch.infer.precompute import make_embed_classify_fn
from construction_clip_tpu_torch.models.clip import model as clip

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "clip_tiny.npz")
# fp32 towers of two layers: GEMM and LN sums in another order than XLA's
TOL = dict(rtol=1e-4, atol=1e-5)
CFG = CLIPConfig.tiny()


@pytest.fixture(scope="module")
def params():
    jparams = jclip.init_clip(jax.random.key(0), CFG)
    return jparams, convert.to_params(jparams).tree()


def _tokens(rng, b):
    toks = rng.integers(1, CFG.text.vocab_size - 1, (b, CFG.text.context_length))
    lens = rng.integers(2, CFG.text.context_length, b)
    toks[np.arange(CFG.text.context_length)[None] >= lens[:, None]] = 0
    toks[np.arange(b), lens - 1] = CFG.text.vocab_size - 1  # EOT: the largest id
    return toks.astype(np.int32)


def test_patchify(rng):
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(clip.patchify(torch.from_numpy(x), 8).numpy(),
                                  np.asarray(j_patchify(jnp.asarray(x), 8)))


@pytest.mark.parametrize("normalize", [False, True])
def test_encode_image(params, normalize, rng):
    jparams, tparams = params
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = jclip.encode_image(jparams, CFG, jnp.asarray(x), normalize=normalize)
    got = clip.encode_image(tparams, CFG, torch.from_numpy(x), normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_encode_text(params, normalize, rng):
    jparams, tparams = params
    toks = _tokens(rng, 4)
    want = jclip.encode_text(jparams, CFG, jnp.asarray(toks), normalize=normalize)
    got = clip.encode_text(tparams, CFG, torch.from_numpy(toks), normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_golden():
    """The towers reproduce the JAX package's clip_tiny golden logits."""
    tparams = convert.to_params(jclip.init_clip(jax.random.key(42), CFG)).tree()
    imgs = torch.from_numpy(np.random.default_rng(42).standard_normal((2, 32, 32, 3))
                            .astype(np.float32))
    toks = torch.zeros((2, 16), dtype=torch.int32)
    toks[:, 0], toks[:, 1] = 254, 255
    img = clip.encode_image(tparams, CFG, imgs, normalize=True)
    txt = clip.encode_text(tparams, CFG, toks, normalize=True)
    logits = torch.exp(tparams["logit_scale"]) * img @ txt.T
    np.testing.assert_allclose(logits.numpy(), np.load(GOLDEN)["logits_per_image"],
                               rtol=1e-5, atol=1e-5)


def test_embed_classify(params, rng):
    jparams, tparams = params
    ct, vt = _tokens(rng, 2), _tokens(rng, 9)
    x = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    jemb, jct, jvt = j_embed_classify(jparams, CFG, ct, vt)(jnp.asarray(x))
    emb, tct, tvt = make_embed_classify_fn(tparams, CFG, ct, vt)(torch.from_numpy(x))
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), **TOL)
    np.testing.assert_array_equal(tct.numpy(), np.asarray(jct))
    np.testing.assert_array_equal(tvt.numpy(), np.asarray(jvt))


def test_bf16_policy_outputs_fp32(params, rng):
    _, tparams = params
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    got = clip.encode_image(tparams, CFG, x, policy=BF16_POLICY, normalize=True)
    want = clip.encode_image(tparams, CFG, x, normalize=True)
    assert got.dtype == torch.float32
    # two bf16 layers: a few bf16 rounding steps on unit-norm features
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-2)


def _shapes(tree):
    return tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("which", ["clip", "gpt2", "clipcap"])
def test_numpy_init_matches_jax_shapes(which):
    gcfg = GPT2Config.tiny()
    ccfg = ClipCapConfig(prefix_length=3, attribute_length=4, clip_dim=32)
    if which == "clip":
        ours, theirs = convert.init_clip(0, CFG), jclip.init_clip(jax.random.key(0), CFG)
    elif which == "gpt2":
        ours, theirs = convert.init_gpt2(0, gcfg), j_init_gpt2(jax.random.key(0), gcfg)
    else:
        ours = convert.init_clipcap(0, ccfg, gcfg)
        theirs = j_init_clipcap(jax.random.key(0), ccfg, gcfg)
    assert _shapes(ours) == _shapes(tree_map(np.asarray, theirs))
    # the ParamTree's state-dict keys are the JAX tree paths
    keys = set(convert.to_params(ours).state_dict())
    paths = set(jax.tree_util.keystr(p, simple=True, separator=".")
                for p, _ in jax.tree_util.tree_leaves_with_path(theirs))
    assert keys == paths


@pytest.mark.parametrize("name", ["vit_b_32", "vit_b_16", "vit_l_14", "tiny", "tiny_bpe", "gpt2",
                                  "gpt2_tiny", "clipcap", "t5", "t5_tiny"])
def test_configs_equal_the_jax_configs(name):
    """The port's copies of the config dataclasses stay equal to the originals."""
    import dataclasses

    from construction_clip_tpu.core import configs as jcfg

    def build(mod):
        if name == "gpt2":
            return mod.GPT2Config()
        if name == "gpt2_tiny":
            return mod.GPT2Config.tiny()
        if name == "clipcap":
            return mod.ClipCapConfig()
        if name == "t5":
            return mod.T5Config()
        if name == "t5_tiny":
            return mod.T5Config.tiny()
        return getattr(mod.CLIPConfig, name)()

    import construction_clip_tpu_torch.core.configs as tcfg

    ours, theirs = build(tcfg), build(jcfg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert type(ours).__name__ == type(theirs).__name__
