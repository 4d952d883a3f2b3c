"""PyTorch port, the Faster R-CNN detector (models/resnet.py,
models/detection.py, convert.init_fasterrcnn / to_detector_params) against
the JAX package on the CPU: the pyramid and FPN, NMS, multi-level ROIAlign,
fasterrcnn_infer in fp32 and bf16, and the torchvision converter.

Each JAX call runs once, in a module-scoped fixture. Two weight trees:
`init_fasterrcnn(jax.random.key(11))` (the golden's), whose random ResNet
grows activations to ~5e3 and box-head deltas to ~10, so its boxes are
ill-conditioned (below); and `test_detection._synthetic_tv_state_dict`
through both converters, whose folded BatchNorm keeps activations O(1), for
the slot-by-slot comparisons at every live slot. A live slot is an output
slot with a score above 0; slots at score 0 are padding whose order ties
decide.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.models import detection as jdet
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.models import detection as tdet

from test_detection import _synthetic_tv_state_dict

GOLDEN = dict(pre_nms_topk=50, post_nms_topk=20, detections_per_img=5)   # test_goldens.py
# fp32 detections, per live slot: the same label, boxes within 1e-3 px + 1e-4
# relative, scores within 1e-4
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_ATOL = 1e-4


def _image(size, seed=11):
    return np.random.default_rng(seed).random((size, size, 3)).astype(np.float32)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def golden_trees():
    """init_fasterrcnn(key 11) (tests/goldens/detection_tiny.npz's) in both
    packages."""
    tree = jdet.init_fasterrcnn(jax.random.key(11), num_classes=8)
    return tree, convert.to_detector_params(tree)


@pytest.fixture(scope="module")
def tv_trees():
    """The synthetic torchvision state dict through each package's converter."""
    sd = _synthetic_tv_state_dict()
    return (jdet.from_torchvision_state_dict(sd, num_classes=8),
            convert.to_detector_params(tdet.from_torchvision_state_dict(sd, num_classes=8)))


@pytest.fixture(scope="module")
def jax_pyramids(golden_trees):
    """JAX's C2..C5 and P2..P6 at 128 px and at 112 px (C5 4 -> C4 7: the
    upsample is no exact 2x there)."""
    tree, _ = golden_trees
    out = {}
    for size in (128, 112):
        x = (jnp.asarray(_image(size)) - jnp.asarray(jdet.IMAGE_MEAN)) / jnp.asarray(jdet.IMAGE_STD)
        c = jax.jit(jdet.resnet_pyramid)(tree["backbone"], x[None])
        out[size] = ([np.asarray(v) for v in c],
                     [np.asarray(v) for v in jax.jit(jdet.fpn_forward)(tree["fpn"], c)])
    return out


def _port_pyramid(tparams, size, dtype=torch.float32):
    p = tdet.cast_params(tparams, dtype)
    x = ((torch.from_numpy(_image(size)) - torch.tensor(tdet.IMAGE_MEAN))
         / torch.tensor(tdet.IMAGE_STD))[None].permute(0, 3, 1, 2).to(dtype)
    c = tdet.resnet_pyramid(p["backbone"], x)
    return c, tdet.fpn_forward(p["fpn"], c)


@pytest.mark.parametrize("size", [128, 112])
def test_pyramid_and_fpn_match_jax(golden_trees, jax_pyramids, size):
    """C2..C5 and P2..P6 within rtol 1e-4 and atol 1e-4 of each map's largest
    magnitude: the random ResNet's maps reach ~5e3, where one fp32 step is
    4.9e-4 and an element that is a small difference of large sums moves by
    the sums' rounding (2e-6 of the map's largest in practice), so an
    element-wise atol of 1e-4 would hold XLA's summation order, not the math."""
    c_t, p_t = _port_pyramid(golden_trees[1], size)
    c_j, p_j = jax_pyramids[size]
    for name, got, want in [("C", c_t, c_j), ("P", p_t, p_j)]:
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            g = _nhwc(g)
            assert g.shape == w.shape, (name, i)
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * (1 + scale),
                                       err_msg=f"{name}{i + 2} at {size} px")
    assert p_t[0].is_contiguous(memory_format=torch.channels_last)


def test_fpn_upsample_is_half_pixel_nearest():
    """fpn_forward's top-down upsample is jax.image.resize(nearest), torch's
    nearest-exact and not nearest: with identity laterals and output convs
    and zero C4, P4 is C5 (7 rows) resized to 13, rows 0 0 1 1 2 2 3 4 4 5 5
    6 6 (nearest would give 3 3 4 4 5 5 6)."""
    ident = {"w": torch.ones(1, 1), "b": torch.zeros(1)}
    fpn = {"inner": [ident] * 4, "layer": [{"w": torch.ones(1, 1, 1, 1), "b": torch.zeros(1)}] * 4}
    c5 = torch.arange(7.0).reshape(1, 1, 7, 1)
    feats = [torch.zeros(1, 1, 52, 1), torch.zeros(1, 1, 26, 1), torch.zeros(1, 1, 13, 1), c5]
    p4 = tdet.fpn_forward(fpn, feats)[2]
    want = np.asarray(jax.image.resize(jnp.arange(7.0).reshape(1, 7, 1, 1), (1, 13, 1, 1),
                                       "nearest"))
    np.testing.assert_array_equal(p4[0, 0, :, 0].numpy(), want[0, :, 0, 0])
    assert p4[0, 0, :, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 4, 4, 5, 5, 6, 6]


def _random_boxes(gen, n, span=80.0):
    xy = gen.uniform(0, span, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + gen.uniform(5, 30, (n, 2)).astype(np.float32)], axis=1)


def _chain(n=64):
    """test_detection.py's suppression chain: box i overlaps only box i + 1."""
    boxes = np.stack([8.0 * np.arange(n), np.zeros(n), 8.0 * np.arange(n) + 16,
                      np.full(n, 16.0)], axis=1).astype(np.float32)
    return boxes, np.linspace(1.0, 0.5, n).astype(np.float32)


NMS_CASES = {
    # name: (iou_threshold, max_out, num_candidates)
    "all_candidates": (0.5, 60, None),
    "top_candidates_padded": (0.3, 40, 25),
    "chain": (0.3, 64, None),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_mask_matches_jax_exactly(case):
    """Indices and keep mask equal to JAX's nms_mask for every set of a batch
    run at once (ties in the scores included, -inf scores as dead), the
    suppression chain among them."""
    thr, max_out, cands = NMS_CASES[case]
    gen = np.random.default_rng(5)
    if case == "chain":
        sets = [_chain()]
        boxes, scores = sets[0]
        sets.append((boxes[::-1].copy(), scores))   # the chain in the other order
    else:
        sets = []
        for _ in range(4):
            scores = gen.random(60).astype(np.float32)
            scores[gen.integers(0, 60, 6)] = scores[0]          # ties
            scores[gen.integers(0, 60, 5)] = -np.inf            # dead candidates
            sets.append((_random_boxes(gen, 60), scores))
    stats = {}
    idx, keep = tdet.nms_mask(torch.from_numpy(np.stack([b for b, _ in sets])),
                              torch.from_numpy(np.stack([s for _, s in sets])),
                              iou_threshold=thr, max_out=max_out, num_candidates=cands,
                              stats=stats)
    assert idx.shape == keep.shape == (len(sets), max_out)
    for i, (b, s) in enumerate(sets):
        j_idx, j_keep = jdet.nms_mask(jnp.asarray(b), jnp.asarray(s), iou_threshold=thr,
                                      max_out=max_out, num_candidates=cands)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(j_keep))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(j_idx))
    if case == "chain":
        kept = sorted(int(j) for j, k in zip(idx[0], keep[0]) if k)
        assert kept == list(range(0, 64, 2))
    assert stats["nms_iterations"][0] >= 1


def test_roi_align_multilevel_matches_jax():
    """Each box at its level, the 4 corners gathered from one flat table, for
    2 images at once: within atol 1e-5 of JAX's per image."""
    gen = np.random.default_rng(3)
    C, n, bsz = 8, 25, 2
    feats = [gen.random((bsz, s, s, C)).astype(np.float32) for s in (64, 32, 16, 8)]
    boxes = gen.random((bsz, n, 4)).astype(np.float32) * 200
    boxes[..., 2:] = boxes[..., :2] + 8 + gen.random((bsz, n, 2)).astype(np.float32) * 100
    boxes[0, 0] = [-30.0, -30.0, 300.0, 290.0]                  # past the map's edges
    lvl = gen.integers(0, 4, (bsz, n))
    got = tdet.roi_align_multilevel(
        [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats], torch.from_numpy(boxes),
        torch.from_numpy(lvl), strides=(4, 8, 16, 32))
    assert got.shape == (bsz, n, 7, 7, C)
    for b in range(bsz):
        want = jdet.roi_align_multilevel([jnp.asarray(f[b]) for f in feats],
                                         jnp.asarray(boxes[b]), jnp.asarray(lvl[b], jnp.int32),
                                         strides=(4, 8, 16, 32))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _live_equal(got, boxes, labels, scores, what, box_tol=BOX_TOL):
    """The port's one-image Detections against arrays: equal live slots (the
    same count), labels exact, boxes and scores within the tolerances."""
    g_s, g_l, g_b = got.scores[0].numpy(), got.labels[0].numpy(), got.boxes[0].numpy()
    live = scores > 0
    np.testing.assert_array_equal(g_s > 0, live, err_msg=f"{what}: live slots")
    assert live.any(), f"{what}: no live slot to compare"
    np.testing.assert_array_equal(g_l[live], labels[live], err_msg=f"{what}: labels")
    np.testing.assert_allclose(g_s, scores, rtol=0, atol=SCORE_ATOL, err_msg=f"{what}: scores")
    np.testing.assert_allclose(g_b[live], boxes[live], err_msg=f"{what}: boxes", **box_tol)


def test_infer_matches_the_golden(golden_trees):
    """fasterrcnn_infer in fp32 against tests/goldens/detection_tiny.npz
    (test_goldens.py's sizes). Scores within 1e-4, labels exact on live
    slots; the one live box within 1 px: it is the difference of a decode at
    ~4e3 px (deltas ~10 times 128 px anchors) clipped to 96.67, so rounding
    in the sums before it moves it by tenths of a pixel - JAX's own op-by-op
    run of the same program (jax.disable_jit()) lands 0.49 px from the golden,
    the port 0.47."""
    g = np.load("tests/goldens/detection_tiny.npz")
    got = tdet.fasterrcnn_infer(golden_trees[1], torch.from_numpy(_image(128))[None],
                                image_size=128, num_classes=8, **GOLDEN)
    assert got.boxes.shape == (1, 5, 4) and got.boxes.dtype == torch.float32
    _live_equal(got, g["boxes"], g["labels"], g["scores"], "golden",
                box_tol=dict(rtol=0, atol=1.0))


@pytest.fixture(scope="module")
def jax_infer(golden_trees, tv_trees):
    """JAX's fasterrcnn_infer: the golden tree at 112 px (golden budgets);
    the torchvision tree at 128 and 112 px with the default budgets (1000 /
    300 / 100), fp32, and at 128 px in bf16."""
    def run(tree, size, cd=jnp.float32, **kw):
        d = jdet.fasterrcnn_infer(tree, jnp.asarray(_image(size)), image_size=size,
                                  num_classes=8, compute_dtype=cd, **kw)
        return tuple(np.asarray(v) for v in (d.boxes, d.labels, d.scores))

    return {("golden", 112): run(golden_trees[0], 112, **GOLDEN),
            ("tv", 128): run(tv_trees[0], 128), ("tv", 112): run(tv_trees[0], 112),
            ("tv_bf16", 128): run(tv_trees[0], 128, jnp.bfloat16)}


@pytest.mark.parametrize("tree,size", [("golden", 112), ("tv", 128), ("tv", 112)])
def test_infer_matches_jax(golden_trees, tv_trees, jax_infer, tree, size):
    """fp32 at 112 px (no exact 2x upsample) and 128 px: every live slot the
    same label, boxes within 1e-3 px + 1e-4, scores within 1e-4 (all 100
    slots live with the torchvision tree)."""
    tparams = (golden_trees if tree == "golden" else tv_trees)[1]
    kw = GOLDEN if tree == "golden" else {}
    got = tdet.fasterrcnn_infer(tparams, torch.from_numpy(_image(size))[None],
                                image_size=size, num_classes=8, **kw)
    _live_equal(got, *jax_infer[(tree, size)], f"{tree} at {size}")


def _matched_share(want, got):
    """Share of `want`'s live detections that a distinct live detection of
    `got` matches: the same label, IoU >= 0.5, scores within 2e-3."""
    from construction_clip_tpu.infer.detection_eval import _iou_matrix

    (wb, wl, ws), (gb, gl, gs) = want, got
    used, hits, n = set(), 0, int((ws > 0).sum())
    for b, l, s in zip(wb, wl, ws):
        if s <= 0:
            continue
        cand = [j for j in range(len(gs)) if gs[j] > 0 and gl[j] == l and j not in used
                and abs(gs[j] - s) <= 2e-3]
        if cand:
            ious = _iou_matrix(np.asarray([b], np.float64), gb[cand].astype(np.float64))[0]
            if ious.max() >= 0.5:
                used.add(cand[int(ious.argmax())])
                hits += 1
    return hits / max(n, 1)


def test_infer_bf16_matches_jax_bf16(tv_trees, jax_infer):
    """bf16 compute (the serving configuration): fp32 boxes and scores of the
    fixed-size contract, and at least 90% of JAX's bf16 live detections
    matched by the port's (same label, IoU >= 0.5, scores within 2e-3). The
    100 scores lie within 1e-3 of each other, so a bf16 rounding that another
    order flips reorders slots: slot by slot they cannot be compared. The
    port matched 97% here, and JAX's own bf16 run matches its fp32 run by
    94%."""
    got = tdet.fasterrcnn_infer(tv_trees[1], torch.from_numpy(_image(128))[None],
                                image_size=128, num_classes=8, compute_dtype=torch.bfloat16)
    assert got.boxes.dtype == got.scores.dtype == torch.float32
    assert got.boxes.shape == (1, 100, 4) and torch.isfinite(got.boxes).all()
    s = got.scores[0].numpy()
    assert (s >= 0).all() and (s <= 1).all() and (np.diff(s) <= 0).all()
    share = _matched_share(jax_infer[("tv_bf16", 128)],
                           tuple(t[0].numpy() for t in (got.boxes, got.labels, got.scores)))
    assert share >= 0.9, share


@pytest.mark.parametrize("naming", ["new", "old"])
def test_from_torchvision_state_dict_gives_jax_arrays(naming):
    """The converter's tree equal, array for array, to the JAX package's on a
    torchvision-named state dict (Conv2dNormActivation naming, and the old
    `inner_blocks.{i}.weight` / `rpn.head.conv.weight` one)."""
    sd = _synthetic_tv_state_dict()
    if naming == "old":
        sd = {k.replace(".0.weight", ".weight").replace(".0.bias", ".bias")
              .replace("rpn.head.conv.0.", "rpn.head.conv.")
              if k.startswith(("backbone.fpn.", "rpn.head.conv.")) else k: v
              for k, v in sd.items()}
        assert "rpn.head.conv.weight" in sd and "backbone.fpn.inner_blocks.0.weight" in sd
    got = tdet.from_torchvision_state_dict(sd, num_classes=8)
    want = jdet.from_torchvision_state_dict(sd, num_classes=8)
    paths = []

    def walk(g, w, path):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, (list, tuple)):
            assert len(g) == len(w), path
            for i, (gi, wi) in enumerate(zip(g, w)):
                walk(gi, wi, f"{path}/{i}")
        else:
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, path
            np.testing.assert_array_equal(g, w, err_msg=path)
            paths.append(path)

    walk(got, want, "")
    assert len(paths) == len(jax.tree_util.tree_leaves(want))


def test_init_fasterrcnn_has_the_jax_shapes():
    """convert.init_fasterrcnn: JAX's tree shapes and dtypes (SHAPES draws
    nothing), and to_detector_params permutes each convolution to OIHW in
    channels-last memory, once."""
    want = jax.eval_shape(lambda: jdet.init_fasterrcnn(jax.random.key(0), num_classes=7))
    for seed in (0, convert.SHAPES):
        got = convert.init_fasterrcnn(seed, num_classes=7)
        g_leaves = jax.tree_util.tree_leaves_with_path(got)
        w_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
        for (path, g), (_, w) in zip(g_leaves, w_leaves):
            assert g.shape == w.shape and g.dtype == w.dtype, path
    params = convert.to_detector_params(convert.init_fasterrcnn(0, num_classes=7),
                                        dtype=torch.bfloat16)
    w = params["backbone"]["stages"][1][0]["conv2"]
    assert w.shape == (128, 128, 3, 3) and w.dtype == torch.bfloat16
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert params["box_head"]["fc6"]["w"].shape == (256 * 49, 1024)
