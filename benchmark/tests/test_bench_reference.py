"""The plain reference against the port on the CPU at CLIPConfig.tiny's sizes
(the port's kernels run their plain versions here), in float32."""

import numpy as np
import pytest
import torch

import harness
import weights
from test_bench_harness import TINY

ref = harness.load_module(harness.BENCH / "reference" / "clip.py")


@pytest.fixture(scope="module")
def setup():
    from construction_clip_tpu_torch.core.configs import CLIPConfig

    ccfg = harness.clip_config(TINY)
    assert ccfg == CLIPConfig.tiny()
    params = weights.clip_params(TINY, 11, "cpu")
    g = weights.generator(11, weights.IMAGES, "cpu")
    u8 = weights.images_u8(6, 40, g, "cpu")
    tokens = weights.token_ids(6, 16, 256, (3, 12), g, "cpu")
    return ccfg, params, u8, tokens


def test_preprocess(setup):
    from construction_clip_tpu_torch.data.preprocess import preprocess_batch

    _, _, u8, _ = setup
    np.testing.assert_allclose(ref.preprocess(u8, 32).numpy(),
                               preprocess_batch(u8.numpy(), 32).numpy(), atol=2e-6)


def test_towers_and_zeroshot(setup):
    from construction_clip_tpu_torch.infer.zeroshot import classify_batch, label_features
    from construction_clip_tpu_torch.models.clip.model import encode_image

    ccfg, params, u8, tokens = setup
    images = ref.preprocess(u8, 32)
    with torch.no_grad(), ref.precision("fp32"):
        want_img = ref.encode_image(params, TINY, images, "fp32")
        want_txt = ref.encode_text(params, TINY, tokens, "fp32")
        want = ref.zeroshot_logprobs(params, TINY, want_txt[:3], u8, "fp32", 4)
    got_img = encode_image(params, ccfg, images, normalize=True)
    np.testing.assert_allclose(got_img.numpy(), want_img.numpy(), atol=2e-6)
    feats = label_features(params, ccfg, tokens)
    np.testing.assert_allclose(feats.numpy(), want_txt.numpy(), atol=2e-6)
    probs, _ = classify_batch(params, ccfg, images, feats[:3])
    np.testing.assert_allclose(torch.log(probs).numpy(), want.numpy(), atol=1e-5)


def _leaves(tree):
    leaves = dict(weights.leaf_items(tree))
    for p in leaves.values():
        p.requires_grad_(True)
    return leaves


def test_loss_and_gradients(setup):
    from construction_clip_tpu_torch.core.params import ParamTree
    from construction_clip_tpu_torch.train.contrastive import loss_and_grads

    ccfg, _, u8, tokens = setup
    params = ParamTree(weights.clip_params(TINY, 11, "cpu"), trainable=True)
    tree = weights.clip_params(TINY, 11, "cpu")
    leaves = _leaves(tree)
    with ref.precision("fp32"):
        loss, grads = ref.loss_and_grads(tree, leaves, TINY, u8, tokens, "fp32", rows=4)
        loss_one, grads_one = ref.loss_and_grads(tree, leaves, TINY, u8, tokens, "fp32", rows=6)
    assert loss == pytest.approx(loss_one, rel=1e-6)
    got_loss, _, got = loss_and_grads(params, ccfg, ref.preprocess(u8, 32), tokens)
    assert float(got_loss) == pytest.approx(loss, rel=1e-6)
    for k, g in weights.leaf_items(got):
        scale = float(grads[k].abs().max()) + 1e-12
        assert float((g - grads[k]).abs().max()) <= 1e-4 * scale, k
        assert float((grads_one[k] - grads[k]).abs().max()) <= 1e-5 * scale, k


def test_adamw_matches_the_port():
    from construction_clip_tpu_torch.train.state import make_adamw

    torch.manual_seed(0)
    p = {"a": torch.randn(5, 4), "b": {"c": torch.randn(7)}}
    mine = {k: v.clone() for k, v in weights.leaf_items(p)}
    tx = make_adamw(1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    state = tx.init(p)
    adamw = ref.AdamW(1e-2, 2, 10, weight_decay=0.1)
    for step in range(3):
        grads = {"a": torch.randn(5, 4), "b": {"c": torch.randn(7)}}
        _, state = tx.update_and_apply(grads, state, p)
        adamw.apply(mine, dict(weights.leaf_items(grads)))
    for k, v in weights.leaf_items(p):
        np.testing.assert_allclose(v.numpy(), mine[k].numpy(), rtol=1e-6, atol=1e-7)
