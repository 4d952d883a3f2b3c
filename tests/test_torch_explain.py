"""PyTorch port, explainability against the JAX package (CPU, fp32): the
attention probabilities and the probe's gradient, relevance propagation,
`interpret`, the relevance map's bilinear resize, the per-character text
heatmap and its HTML, the JET overlay on both of its branches, the decoder
attention map, and the probe path's routing around the fused block."""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.core import configs as jconfigs
from construction_clip_tpu.infer import explain as jexplain
from construction_clip_tpu.models import clip as jclip
from construction_clip_tpu.models import gpt2 as jgpt2
from construction_clip_tpu.ops import attention as jattention
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import (
    CLIPConfig, GPT2Config, TextConfig, VisionConfig)
from construction_clip_tpu_torch.infer import explain
from construction_clip_tpu_torch.models import blocks, gpt2
from construction_clip_tpu_torch.models.clip import model as clip
from construction_clip_tpu_torch.ops import attention

# tests/test_explain.py's tiny CLIP: a 4 x 4 patch grid, 3 image blocks, 2 text blocks
CFG = CLIPConfig(
    vision=VisionConfig(image_size=16, patch_size=4, width=32, layers=3, heads=2, embed_dim=16),
    text=TextConfig(vocab_size=64, context_length=8, width=32, layers=2, heads=2, embed_dim=16))
JCFG = jconfigs.CLIPConfig(
    vision=jconfigs.VisionConfig(image_size=16, patch_size=4, width=32, layers=3, heads=2,
                                 embed_dim=16),
    text=jconfigs.TextConfig(vocab_size=64, context_length=8, width=32, layers=2, heads=2,
                             embed_dim=16))
# R of fp32 towers: GEMM, softmax and LN sums in another order than XLA's, then
# the products of the propagation (|R| ~ 1)
R_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    gen = np.random.default_rng(11)
    jparams = jclip.init_clip(jax.random.key(2), JCFG)
    images = gen.standard_normal((2, 16, 16, 3)).astype(np.float32)
    tokens = np.zeros((2, 8), np.int32)
    tokens[:, 0] = 62
    tokens[0, 1:4] = [5, 9, 63]   # EOT (the largest id) at 3
    tokens[1, 1:3] = [7, 63]      # EOT at 2
    return jparams, convert.to_params(jparams).tree(), images, tokens


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_attention_probs_match_jax(cross):
    """qkv_attention's output and fp32 probabilities at return_probs, and mha's,
    against the JAX package's; cross-attention takes k and v from kv_x."""
    gen = np.random.default_rng(1)
    x = gen.standard_normal((2, 5, 16)).astype(np.float32)
    kv = gen.standard_normal((2, 7, 16)).astype(np.float32) if cross else None
    p = {"w_qkv": gen.standard_normal((16, 48)).astype(np.float32) * 0.3,
         "b_qkv": gen.standard_normal(48).astype(np.float32) * 0.1,
         "w_out": gen.standard_normal((16, 16)).astype(np.float32) * 0.3,
         "b_out": gen.standard_normal(16).astype(np.float32) * 0.1}
    want_y, want_p = jattention.qkv_attention(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, 4,
        kv_x=None if kv is None else jnp.asarray(kv), is_causal=not cross, return_probs=True)
    got_y, got_p = attention.qkv_attention(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, 4,
        kv_x=None if kv is None else torch.from_numpy(kv), is_causal=not cross,
        return_probs=True)
    assert got_p.dtype == torch.float32 and got_p.shape == (2, 4, 5, 7 if cross else 5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6, rtol=1e-5)
    q, k, v = (gen.standard_normal((2, 3, 6, 8)).astype(np.float32) for _ in range(3))
    _, want = jattention.mha(*map(jnp.asarray, (q, k, v)), return_probs=True)
    _, got = attention.mha(*map(torch.from_numpy, (q, k, v)), return_probs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_probe_gradient_matches_jax_grad(setup):
    """The gradient of a weighted sum of the image features with respect to the
    probe (every block's probabilities) against jax.grad of the same function."""
    jparams, tparams, images, _ = setup
    v = CFG.vision
    shape = (v.layers, 2, v.heads, v.seq_len, v.seq_len)
    w = np.random.default_rng(2).standard_normal((2, v.embed_dim)).astype(np.float32)

    def jf(probe):
        return jnp.sum(jclip.encode_image(jparams, JCFG, jnp.asarray(images),
                                          probs_probe=probe) * w)

    want = jax.grad(jf)(jnp.zeros(shape, jnp.float32))
    probe = torch.zeros(shape, requires_grad=True)
    feats = clip.encode_image(tparams, CFG, torch.from_numpy(images), probs_probe=probe)
    (got,) = torch.autograd.grad((feats * torch.from_numpy(w)).sum(), probe)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3   # a gradient, not zeros
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("start_layer", [-1, 0, 1])
def test_propagate_matches_jax(start_layer):
    gen = np.random.default_rng(3)
    probs = gen.random((3, 2, 2, 5, 5)).astype(np.float32)
    grads = gen.standard_normal((3, 2, 2, 5, 5)).astype(np.float32)
    want = jexplain._propagate(jnp.asarray(probs), jnp.asarray(grads), start_layer)
    got = explain._propagate(torch.from_numpy(probs), torch.from_numpy(grads), start_layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("start_layer", [-1, 0])
def test_interpret_matches_jax(start_layer, setup):
    """R_text and R_image of the two image-text pairs against JAX's interpret
    (jitted on the CPU), fp32."""
    jparams, tparams, images, tokens = setup
    want_t, want_i = jexplain.interpret(jparams, JCFG, jnp.asarray(images), jnp.asarray(tokens),
                                        start_layer=start_layer, start_layer_text=start_layer)
    got_t, got_i = explain.interpret(tparams, CFG, torch.from_numpy(images), tokens,
                                     start_layer=start_layer, start_layer_text=start_layer)
    assert got_i.shape == (2, CFG.vision.seq_len, CFG.vision.seq_len)
    assert got_t.shape == (2, 8, 8) and float(got_i.abs().max()) > 1e-3
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **R_TOL)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), **R_TOL)


def test_interpret_never_takes_the_fused_block(setup, monkeypatch):
    """Under the kernel impl the probe path runs the composed attention in
    every block (the fused block has no probabilities to return or probe),
    as the JAX package's apply_block routes it; a plain encode_image, by
    contrast, does reach the fused block."""
    _, tparams, images, tokens = setup

    def refuse(*args, **kwargs):
        raise AssertionError("the fused attention block was called")

    monkeypatch.setattr(blocks.fab, "fused_attention_block", refuse)
    assert attention.resolve_impl() == "kernel"
    r_text, r_image = explain.interpret(tparams, CFG, torch.from_numpy(images), tokens)
    assert torch.isfinite(r_image).all() and torch.isfinite(r_text).all()
    with pytest.raises(AssertionError, match="fused attention block was called"):
        clip.encode_image(tparams, CFG, torch.from_numpy(images))


@pytest.mark.parametrize("grid, out_size", [(4, 16), (4, 224), (7, 224), (7, 256),
                                            (14, 256), (4, 3)])
def test_image_relevance_map_matches_jax(grid, out_size):
    """Bilinear upsampling, and, below the grid, antialiased downsampling, as
    jax.image.resize; normalized to [0, 1]."""
    row = np.random.default_rng(grid * out_size).standard_normal(1 + grid * grid)
    want = jexplain.image_relevance_map(row.astype(np.float32), grid, out_size=out_size)
    got = explain.image_relevance_map(torch.from_numpy(row).float(), grid, out_size=out_size)
    assert got.shape == (out_size, out_size) and got.min() == 0.0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


class _Tokenizer:
    """One BPE token a character, two for "帽", none for a space."""

    def encode(self, ch):
        return [] if ch == " " else [1, 2] if ch == "帽" else [1]


def test_text_heatmap_and_html_equal_jax(setup, tmp_path):
    """Per-character scores of a caption (characters of one, two and no
    tokens; a '<' escaped), and the HTML file, byte-equal to the JAX
    package's on the same R_text."""
    jparams, _, images, _ = setup
    text = "安全 帽<"
    tokens = np.zeros((2, 8), np.int32)
    tokens[:, :7] = [62, 5, 9, 3, 4, 8, 63]   # SOT, 5 tokens of the text, EOT at 6
    r_text, _ = jexplain.interpret(jparams, JCFG, jnp.asarray(images), jnp.asarray(tokens))
    r_row = np.array(r_text)[0]
    want = jexplain.text_heatmap_per_char(r_row, tokens[0], text, _Tokenizer())
    got = explain.text_heatmap_per_char(torch.from_numpy(r_row), tokens[0], text, _Tokenizer())
    assert got == want and [c for c, _ in got] == list(text)
    html_j = jexplain.render_text_heatmap_html(want, str(tmp_path / "j.html"), title=text)
    html_t = explain.render_text_heatmap_html(got, str(tmp_path / "t.html"), title=text)
    assert html_t == html_j and "&lt;" in html_t
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    np.testing.assert_array_equal(explain.text_relevance_scores(r_row, tokens[0], 6),
                                  jexplain.text_relevance_scores(r_row, tokens[0], 6))


@pytest.mark.parametrize("cv2_branch", [True, False], ids=["cv2", "numpy"])
def test_overlay_heatmap_equals_jax(cv2_branch, monkeypatch):
    gen = np.random.default_rng(4)
    img = (gen.random((20, 24, 3)) * 255).astype(np.uint8)
    heat = gen.random((20, 24)).astype(np.float32)
    if not cv2_branch:
        monkeypatch.setitem(sys.modules, "cv2", None)   # `import cv2` raises ImportError
    got = explain.overlay_heatmap(img, heat)
    assert got.dtype == np.uint8 and got.shape == (20, 24, 3)
    np.testing.assert_array_equal(got, jexplain.overlay_heatmap(img, heat))


def test_decoder_attention_map_matches_jax(tmp_path):
    """The last layer's rows for 3 generated tokens after a 4-position prompt on
    GPT2Config.tiny(): equal to JAX's, each a distribution over what it sees."""
    jparams = jgpt2.init_gpt2(jax.random.key(1), jconfigs.GPT2Config.tiny())
    tparams = convert.to_params(jparams).tree()
    gcfg = GPT2Config.tiny()
    prompt = gpt2.embed_tokens(tparams, torch.arange(4)[None])
    gen_tokens = np.asarray([[7, 9, 11]], np.int32)
    want = jexplain.decoder_attention_map(jparams, jconfigs.GPT2Config.tiny(),
                                          jnp.asarray(prompt.numpy()), jnp.asarray(gen_tokens))
    got = explain.decoder_attention_map(tparams, gcfg, prompt, torch.from_numpy(gen_tokens))
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got.sum(-1), np.ones(3), rtol=1e-6)
    assert got[0, 5] == 0.0 and got[0, 6] == 0.0   # no row sees past itself
    _, probs = gpt2.gpt2_forward(tparams, gcfg, inputs_embeds=prompt, return_probs=True)
    assert probs.shape == (gcfg.n_layer, 1, gcfg.n_head, 4, 4)
    explain.plot_attention_map(got, str(tmp_path / "attn.png"), token_labels=["a", "b", "c"])
    assert (tmp_path / "attn.png").stat().st_size > 1000
