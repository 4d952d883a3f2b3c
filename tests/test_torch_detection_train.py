"""PyTorch port, Faster R-CNN training (train/detection.py,
convert.to_detector_params(trainable=True) / from_detector_params) against the
JAX package on the CPU, at the JAX parity test's sizes: 64 px, pre-NMS 64,
post-NMS 32, `test_detection._synthetic_tv_state_dict` through both
converters, ground truth padded.

The port samples the RPN's anchors from a torch.Generator, whose draws are
not JAX's keys: the loss and step comparisons pass a sampler that returns
the JAX package's own draws for each image (`_jax_sampler`). Each JAX loss
and gradient is computed once, in a module-scoped fixture.

Tolerances: losses within 1e-5; gradients leaf by leaf within GRAD_TOL of
the leaf's largest element (fp32 through 53 convolutions, sums in another
order; worst measured 1.8e-6). The tests run torch's native CPU
convolution (oneDNN off, `native_conv`), but for
test_default_cpu_backend_matches_jax: oneDNN's fp32 weight gradient of the
RPN's 3x3 convolution under the take-all objectness is 8.5e-4 of the leaf's
largest element off JAX's (and off float64, where JAX's and the native one
are within 1.3e-6 of it), so that test holds the take-all loss's gradients
to ONEDNN_TV_GRAD_TOL. 3 AdamW steps within JAX's own DP tolerance (rtol 1e-2, atol 5e-4:
Adam's g / sqrt(v) turns rounding noise on near-zero gradients into
lr-sized steps).

The ranks are processes spawned by core/mesh.spawn_ranks (gloo, a file
rendezvous, at most 60 s a group). Each imports this module, which imports
no JAX at its top."""

import os
import types

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.mesh import shard_batch, spawn_ranks
from construction_clip_tpu_torch.core.params import tree_leaves, tree_map
from construction_clip_tpu_torch.models import detection as tdet
from construction_clip_tpu_torch.train import detection as tdt
from construction_clip_tpu_torch.train.state import TrainState, make_adamw

S, PRE_NMS, POST_NMS, NC = 64, 64, 32, 8
GRAD_TOL = 1e-5          # |port - JAX| / max |JAX leaf|, fp32
ONEDNN_TV_GRAD_TOL = 2e-3   # the same, the take-all loss on oneDNN (worst measured 8.5e-4)
LR = 1e-4
GT_BOXES = np.asarray([[[6.0, 8.0, 30.0, 28.0], [20.0, 34.0, 58.0, 60.0], [0, 0, 0, 0]],
                       [[4.0, 4.0, 40.0, 36.0], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
GT_LABELS = np.asarray([[2, 5, 0], [3, 0, 0]], np.int32)


@pytest.fixture(autouse=True)
def native_conv():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _images(n=2, seed=11):
    return np.random.default_rng(seed).random((n, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from construction_clip_tpu.models import detection as jdet
    from construction_clip_tpu.train import detection as jdt
    from construction_clip_tpu.train import state as jstate

    from test_detection import _synthetic_tv_state_dict

    sd = _synthetic_tv_state_dict(seed=3)
    tree = jdet.from_torchvision_state_dict(sd, num_classes=NC)
    port_tree = tdet.from_torchvision_state_dict(sd, num_classes=NC)
    return types.SimpleNamespace(**locals())


def _jax_sampler(jx, step_key, batch_size):
    """The port's sampler protocol (labels, seed, image) giving the JAX
    package's draws: image `image`'s key split from `step_key` over the batch,
    then its first half (train/detection.py:134-139)."""
    keys = jx.jax.random.split(step_key, batch_size)

    def sampler(labels, seed, image):
        k1, _ = jx.jax.random.split(keys[image])
        out = jx.jdt.sample_balanced(jx.jnp.asarray(labels.numpy()), k1, num=256,
                                     fg_fraction=0.5)
        idx = [torch.from_numpy(np.array(o)) for o in out]
        return idx[0].long(), idx[1], idx[2].long(), idx[3]

    return sampler


def _walk(a, b):
    """(path, a leaf, b leaf) of two trees of nested dicts and lists."""
    if isinstance(a, dict):
        for k in a:
            for p, x, y in _walk(a[k], b[k]):
                yield f"{k}/{p}", x, y
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            for p, u, v in _walk(x, y):
                yield f"{i}/{p}", u, v
    else:
        yield "", np.asarray(a), np.asarray(b)


def _grads_close(got, want, tol=GRAD_TOL):
    worst = 0.0
    for path, g, w in _walk(got, want):
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max()) / max(scale, 1e-30)
        worst = max(worst, err)
        assert err <= tol, (path, err, scale)
    return worst


def _port_grads(jx, loss_fn):
    params = convert.to_detector_params(jx.port_tree, trainable=True)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    it = iter(grads)
    return float(loss.detach()), convert.from_detector_params(tree_map(lambda _: next(it), params))


def _tbatch():
    return tdt.DetectionBatch(torch.from_numpy(_images()), torch.from_numpy(GT_BOXES),
                              torch.from_numpy(GT_LABELS))


# ---------------------------------------------------------------- box pieces

def test_encode_boxes_and_smooth_l1_match_jax(jx):
    gen = np.random.default_rng(5)
    xy = gen.random((40, 2)).astype(np.float32) * 50
    anchors = np.concatenate([xy, xy + 1 + gen.random((40, 2)).astype(np.float32) * 30], -1)
    xy = gen.random((40, 2)).astype(np.float32) * 50
    boxes = np.concatenate([xy, xy + gen.random((40, 2)).astype(np.float32) * 30], -1)
    boxes[3] = [5, 5, 5, 9]   # a degenerate box: the 1e-6 floor
    np.testing.assert_allclose(tdt.encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors)),
                               jx.jdt.encode_boxes(jx.jnp.asarray(boxes), jx.jnp.asarray(anchors)),
                               rtol=1e-6, atol=1e-6)
    x = gen.standard_normal(200).astype(np.float32) * 0.3
    np.testing.assert_allclose(tdt.smooth_l1(torch.from_numpy(x)),
                               jx.jdt.smooth_l1(jx.jnp.asarray(x)), rtol=1e-6, atol=1e-7)


def _anchors_64():
    sizes = [16, 8, 4, 2, 1]   # P2..P6 at 64 px
    return torch.cat([tdet.level_anchors(n, n, 4 * 2 ** l, tdet.ANCHOR_SIZES[l])
                      for l, n in enumerate(sizes)])


# a ground truth whose best anchor is anchor 0 (IoU 0.098, below bg: only the
# rescue makes it fg), beside a padding row, whose argmax is anchor 0 too
SMALL = [0.0, 0.0, 10.0, 10.0]
MATCH_CASES = {
    "two_valid_one_padding": ([[6, 8, 30, 28], [20, 34, 58, 60], [0, 0, 0, 0]],
                              [True, True, False]),
    "padding_in_the_middle": ([[6, 8, 30, 28], [0, 0, 0, 0], [20, 34, 58, 60]],
                              [True, False, True]),
    "rescue_collides_padding_after": ([SMALL, [0, 0, 0, 0]], [True, False]),
    "rescue_collides_padding_before": ([[0, 0, 0, 0], SMALL], [False, True]),
    "all_padding": ([[0, 0, 0, 0], [0, 0, 0, 0]], [False, False]),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_anchors_matches_jax(jx, case):
    """Matched indices and labels equal to JAX's. In the colliding cases the
    padding row and the valid one both pick anchor 0: JAX's scatter keeps the
    later row's write, and so does the port's scatter-max of the row index:
    anchor 0 stays bg when the padding row comes after the valid one, and is
    rescued to fg when it comes before."""
    boxes, valid = MATCH_CASES[case]
    anchors = _anchors_64()
    gt = np.asarray(boxes, np.float32)
    v = np.asarray(valid)
    got = tdt.match_anchors(anchors, torch.from_numpy(gt), torch.from_numpy(v),
                            fg_thresh=0.7, bg_thresh=0.3)
    want = jx.jdt.match_anchors(jx.jnp.asarray(anchors.numpy()), jx.jnp.asarray(gt),
                                jx.jnp.asarray(v), fg_thresh=0.7, bg_thresh=0.3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if case.startswith("rescue_collides"):
        assert int(got[1][0]) == (0 if case.endswith("after") else 1)
    # batched: both rows of a [2, G] batch at once give each row's result
    both = tdt.match_anchors(anchors, torch.from_numpy(np.stack([gt, gt[::-1].copy()])),
                             torch.from_numpy(np.stack([v, v[::-1].copy()])),
                             fg_thresh=0.7, bg_thresh=0.3)
    np.testing.assert_array_equal(both[1][0].numpy(), got[1].numpy())
    rev = tdt.match_anchors(anchors, torch.from_numpy(gt[::-1].copy()),
                            torch.from_numpy(v[::-1].copy()), fg_thresh=0.7, bg_thresh=0.3)
    np.testing.assert_array_equal(both[1][1].numpy(), rev[1].numpy())
    np.testing.assert_array_equal(both[0][1].numpy(), rev[0].numpy())


def test_sample_balanced_counts_and_fg_fraction():
    """JAX's test_sample_balanced_static_shapes on the port's sampler: fixed
    shapes, the taken rows carry their labels, and the counts are the
    smaller of what is there and the budget; the same seed draws the same,
    and another image of the batch other rows."""
    labels = torch.from_numpy(np.random.default_rng(4).choice([-1, 0, 1], size=200,
                                                              p=[0.2, 0.7, 0.1]))
    gen = tdt.image_generator(7, 0, "cpu")
    fg_idx, fg_take, bg_idx, bg_take = tdt.sample_balanced(labels, gen, num=64, fg_fraction=0.5)
    assert fg_idx.shape == (32,) and bg_idx.shape == (32,)
    assert (labels[fg_idx][fg_take] == 1).all() and (labels[bg_idx][bg_take] == 0).all()
    n_fg, n_bg = int((labels == 1).sum()), int((labels == 0).sum())
    assert int(fg_take.sum()) == min(n_fg, 32) and int(bg_take.sum()) == min(n_bg, 32)
    assert len(set(fg_idx[fg_take].tolist())) == int(fg_take.sum())
    again = tdt.rpn_sampler(labels, 7, 0)
    other = tdt.rpn_sampler(labels, 7, 1)
    assert torch.equal(again[2], tdt.rpn_sampler(labels, 7, 0)[2])
    assert not torch.equal(again[2], other[2])
    # the RPN's budget: 256 at 0.5; every fg is taken (fewer than 128), bg fills 128
    assert again[0].shape == (128,) and int(again[1].sum()) == n_fg
    assert int(again[3].sum()) == 128


# ---------------------------------------------------------------- the losses

@pytest.fixture(scope="module")
def jax_detection_loss(jx):
    """JAX's default loss and gradient at key 0 on the padded batch."""
    jax = jx.jax
    batch = jx.jdt.DetectionBatch(jx.jnp.asarray(_images()), jx.jnp.asarray(GT_BOXES),
                                  jx.jnp.asarray(GT_LABELS))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jx.jdt.detection_loss(
        p, batch, jax.random.key(0), image_size=S, num_classes=NC)))(jx.tree)
    return float(loss), jax.tree.map(np.asarray, grads)


def test_detection_loss_matches_jax_with_its_samples(jx, jax_detection_loss):
    want_loss, want_grads = jax_detection_loss
    sampler = _jax_sampler(jx, jx.jax.random.key(0), 2)
    loss, grads = _port_grads(jx, lambda p: tdt.detection_loss(
        p, _tbatch(), 0, image_size=S, num_classes=NC, sampler=sampler))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    _grads_close(grads, want_grads)


@pytest.fixture(scope="module")
def jax_tv_losses(jx):
    """JAX's four terms per image and the gradient of their sum over both."""
    jax, jnp = jx.jax, jx.jnp
    images = jnp.asarray(_images())

    def terms(p, i):
        return jx.jdt.tv_detection_losses(p, images[i], jnp.asarray(GT_BOXES[i]),
                                          jnp.asarray(GT_LABELS[i]), image_size=S,
                                          num_classes=NC, pre_nms_topk=PRE_NMS,
                                          post_nms_topk=POST_NMS)

    def total(p):
        per = [terms(p, i) for i in range(2)]
        return sum(sum(t.values()) for t in per), per

    (_, per), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(jx.tree)
    return [{k: float(v) for k, v in t.items()} for t in per], jax.tree.map(np.asarray, grads)


def test_tv_detection_losses_match_jax(jx, jax_tv_losses):
    """Both images in one batched call (one NMS fixed point for the batch):
    each image's four terms within 1e-5 of JAX's one-image call, and the
    gradient of their sum leaf by leaf."""
    want, want_grads = jax_tv_losses
    got = {}

    def loss_fn(p):
        b = _tbatch()
        got.update(tdt.tv_detection_losses(p, b.images, b.gt_boxes, b.gt_labels, image_size=S,
                                           num_classes=NC, pre_nms_topk=PRE_NMS,
                                           post_nms_topk=POST_NMS))
        return sum(t.sum() for t in got.values())

    _, grads = _port_grads(jx, loss_fn)
    for i in range(2):
        for k, v in want[i].items():
            np.testing.assert_allclose(float(got[k][i]), v, rtol=1e-5, atol=1e-5, err_msg=(i, k))
    _grads_close(grads, want_grads)


@pytest.mark.parametrize("which", ["detection_loss", "tv_detection_losses"])
def test_default_cpu_backend_matches_jax(jx, jax_detection_loss, jax_tv_losses, which):
    """The port's default CPU path (oneDNN on, as the apps' `--device cpu`
    run): the loss within 1e-5; the default loss's gradients within
    GRAD_TOL, the take-all loss's within ONEDNN_TV_GRAD_TOL (oneDNN's weight
    gradient of the RPN's 3x3 convolution, worst measured 8.5e-4 of the
    leaf, and what flows back from it into the backbone)."""
    with torch.backends.mkldnn.flags(enabled=True):
        if which == "detection_loss":
            want_loss, want_grads = jax_detection_loss
            sampler = _jax_sampler(jx, jx.jax.random.key(0), 2)
            loss, grads = _port_grads(jx, lambda p: tdt.detection_loss(
                p, _tbatch(), 0, image_size=S, num_classes=NC, sampler=sampler))
        else:
            want, want_grads = jax_tv_losses
            want_loss = sum(sum(t.values()) for t in want)

            def loss_fn(p):
                b = _tbatch()
                terms = tdt.tv_detection_losses(p, b.images, b.gt_boxes, b.gt_labels,
                                                image_size=S, num_classes=NC,
                                                pre_nms_topk=PRE_NMS, post_nms_topk=POST_NMS)
                return sum(t.sum() for t in terms.values())

            loss, grads = _port_grads(jx, loss_fn)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    _grads_close(grads, want_grads, GRAD_TOL if which == "detection_loss" else ONEDNN_TV_GRAD_TOL)


def test_bf16_compute_trains_the_fp32_master_tree(jx):
    """bf16 backbone + FPN on the fp32 master tree, as JAX's
    test_tv_loss_bf16_backbone_trains bounds it: finite terms within 10x + 1
    of fp32's, and the default loss's gradients fp32 and nonzero."""
    b = _tbatch()
    params = convert.to_detector_params(jx.port_tree, trainable=True)
    kw = dict(image_size=S, num_classes=NC, pre_nms_topk=PRE_NMS, post_nms_topk=POST_NMS)
    with torch.no_grad():
        f32 = tdt.tv_detection_losses(params, b.images, b.gt_boxes, b.gt_labels, **kw)
        b16 = tdt.tv_detection_losses(params, b.images, b.gt_boxes, b.gt_labels,
                                      compute_dtype=torch.bfloat16, **kw)
    for k in f32:
        assert b16[k].dtype == torch.float32 and torch.isfinite(b16[k]).all(), k
        assert (b16[k] <= 10 * f32[k] + 1.0).all(), (k, b16[k], f32[k])
    loss = tdt.detection_loss(params, b, 0, image_size=S, num_classes=NC,
                              compute_dtype=torch.bfloat16)
    assert torch.isfinite(loss)
    g = torch.autograd.grad(loss, [params["backbone"]["stem"]["conv"]])[0]
    assert g.dtype == torch.float32 and float(g.abs().max()) > 0


# ---------------------------------------------------------------- the step

@pytest.fixture(scope="module")
def jax_steps(jx):
    """JAX's make_detection_train_step with make_adamw, 3 steps at keys 0-2:
    the losses and the params after them."""
    jax = jx.jax
    tx = jx.jstate.make_adamw(LR, warmup_steps=0, total_steps=10)
    step = jx.jdt.make_detection_train_step(tx, image_size=S, num_classes=NC)
    st = jx.jstate.TrainState.create(jax.tree.map(jx.jnp.array, jx.tree), tx)
    batch = jx.jdt.DetectionBatch(jx.jnp.asarray(_images()), jx.jnp.asarray(GT_BOXES),
                                  jx.jnp.asarray(GT_LABELS))
    losses = []
    for i in range(3):
        st, m = step(st, batch, jax.random.key(i))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, st.params)


def test_three_steps_match_jax(jx, jax_steps):
    want_losses, want_params = jax_steps
    tx = make_adamw(LR, warmup_steps=0, total_steps=10)
    params = convert.to_detector_params(jx.port_tree, trainable=True)
    st = TrainState.create(params, tx)
    losses = []
    for i in range(3):
        sampler = _jax_sampler(jx, jx.jax.random.key(i), 2)
        step = tdt.make_detection_train_step(tx, image_size=S, num_classes=NC, sampler=sampler)
        st, m = step(st, _tbatch(), i)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    for path, g, w in _walk(convert.from_detector_params(st.params), want_params):
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=5e-4, err_msg=path)


def _dp_rank(dp, case):
    """The port's step (default sampler, seed 3) on this rank's rows of the
    global batch of 4, from the same tree: the loss and the params after."""
    tx = make_adamw(LR, warmup_steps=0, total_steps=10)
    st = TrainState.create(convert.to_detector_params(case["tree"], trainable=True), tx)
    rows = shard_batch(dp, case["batch"])
    step = tdt.make_detection_train_step(tx, image_size=S, num_classes=NC, dp=dp)
    with torch.backends.mkldnn.flags(enabled=False):
        st, m = step(st, tdt.DetectionBatch(rows["images"], rows["gt_boxes"],
                                            rows["gt_labels"]), 3)
    return float(m["loss"]), convert.from_detector_params(st.params)


def test_two_ranks_equal_one_process(jx):
    """2 gloo ranks of 2 images each against one process on the 4: each
    image samples from its global index, so the ranks draw what one process
    draws; the loss within 1e-5, the params within JAX's DP tolerance."""
    imgs = _images(4, seed=12)
    boxes = np.concatenate([GT_BOXES, GT_BOXES[::-1] + 2.0])
    labels = np.concatenate([GT_LABELS, GT_LABELS[::-1]])
    case = {"tree": jx.port_tree,
            "batch": {"images": torch.from_numpy(imgs), "gt_boxes": torch.from_numpy(boxes),
                      "gt_labels": torch.from_numpy(labels)}}
    ranks = spawn_ranks(_dp_rank, 2, (case,), device="cpu", timeout=60)
    one = _dp_rank(types.SimpleNamespace(rank=0, world=1, device=torch.device("cpu")), case)
    for loss, params in ranks:
        np.testing.assert_allclose(loss, one[0], rtol=1e-5)
        for path, g, w in _walk(params, one[1]):
            np.testing.assert_allclose(g, w, rtol=1e-2, atol=5e-4, err_msg=path)


# ---------------------------------------------------------------- the tree

def test_trainable_tree_and_its_npz_for_jax(jx, tmp_path):
    """to_detector_params(trainable=True): every leaf a leaf tensor that
    requires grad, convolutions OIHW channels-last; from_detector_params
    gives back the JAX tree, and the npz that save_params_npz writes of it
    is what the JAX package's load_params_npz reads, leaf for leaf."""
    from construction_clip_tpu.train.checkpoint import load_params_npz as jax_load

    from construction_clip_tpu_torch.train.checkpoint import load_params_npz, save_params_npz

    params = convert.to_detector_params(jx.port_tree, trainable=True)
    for leaf in tree_leaves(params):
        assert leaf.is_leaf and leaf.requires_grad
    conv = params["backbone"]["stages"][1][0]["conv2"]
    assert conv.shape == (128, 128, 3, 3)
    assert conv.is_contiguous(memory_format=torch.channels_last)
    back = convert.from_detector_params(params)
    for path, g, w in _walk(back, jx.tree):
        np.testing.assert_array_equal(g, w, err_msg=path)
    path = str(tmp_path / "detector.npz")
    save_params_npz(path, back)
    for p, g, w in _walk(jax_load(path, jx.tree), jx.tree):
        np.testing.assert_array_equal(g, w, err_msg=p)
    template = convert.init_fasterrcnn(convert.SHAPES, num_classes=NC)
    for p, g, w in _walk(load_params_npz(path, template), jx.tree):
        np.testing.assert_array_equal(g, w, err_msg=p)
    assert os.path.getsize(path) > 0
