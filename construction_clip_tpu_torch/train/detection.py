"""Faster R-CNN training, the port of construction_clip_tpu/train/detection.py:
anchor matching, balanced sampling, the RPN and ROI losses, and the train step
over the whole model (backbone, FPN, RPN head and box head trainable;
BatchNorm is the inference form's scale and shift, trained as parameters).

  match_anchors   IoU matching at torchvision's thresholds (RPN fg >= 0.7,
                  bg < 0.3, the best anchor of each ground truth rescued)
  sample_balanced a fixed-size fg/bg sample by a random top-k, drawn from a
                  torch.Generator (the JAX package draws from keys: the same
                  distribution, other draws)
  detection_loss  the default loss: sampled RPN terms and the ROI head on the
                  ground-truth boxes as proposals
  tv_detection_losses  torchvision's four train-mode terms in the take-all
                  sampling limit, deterministic
  make_detection_train_step  one step on one process, or data-parallel

Every stage runs batched over the images of the step (the JAX package loops
over them). Ground truth comes padded: boxes [B, max_gt, 4], labels
[B, max_gt] (0 = padding). Activations are channels-last as in
models/detection.py; the tree is `convert.to_detector_params(...,
trainable=True)`'s, and `convert.from_detector_params` turns its gradients
and weights back into the JAX layout. With a bf16 `compute_dtype` the
backbone and FPN run on the fp32 master tree cast at use (differentiably),
and every map, loss and box term after them is fp32.

ROIAlign's gather runs backward as an index-add into the level table, which
on the card accumulates with atomics: its order, and the gradients' last
bits, vary from run to run there.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from construction_clip_tpu_torch.core.params import as_tree, tree_leaves
from construction_clip_tpu_torch.models.detection import (
    ANCHOR_SIZES, IMAGE_MEAN, IMAGE_STD, _take, box_iou, cast_params, fpn_forward,
    level_anchors, resnet_pyramid, roi_align_multilevel, rpn_propose)
from construction_clip_tpu_torch.models.resnet import _conv
from construction_clip_tpu_torch.train.grads import is_parallel, mean_grads
from construction_clip_tpu_torch.train.state import TrainState, apply_gradients

ROI_BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)  # torchvision BoxCoder default
STRIDES = (4, 8, 16, 32)                      # P2..P5, ROIAlign's levels


def encode_boxes(boxes, anchors):
    """Inverse of decode_boxes: boxes [..., 4] against anchors [..., 4]
    (broadcast) -> regression targets (dx, dy, dw, dh)."""
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = (anchors[..., 2] - anchors[..., 0]).clamp(min=1e-6)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp(min=1e-6)
    gx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    gy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    gw = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-6)
    gh = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-6)
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], dim=-1)


def smooth_l1(x, beta: float = 1.0 / 9):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def match_anchors(anchors, gt_boxes, gt_valid, *, fg_thresh: float, bg_thresh: float):
    """anchors [N, 4], gt_boxes [..., G, 4], gt_valid [..., G] -> (matched gt
    index [..., N], labels [..., N]: 1 fg / 0 bg / -1 ignore). Ties take the
    lower index, as jnp.argmax.

    The rescue marks each valid ground truth's best anchor fg. A padding
    ground truth's IoU is -1 everywhere, so its best anchor is anchor 0, and
    the JAX package's scatter of gt_valid there collides with a valid ground
    truth whose best anchor is anchor 0 too. Here the ground truth of the
    highest index wins each anchor (a scatter-max of the index, then a
    gather of its validity): the last write of the JAX package's scatter,
    whatever the device's write order."""
    iou = box_iou(anchors, gt_boxes)                       # [..., N, G]
    iou = torch.where(gt_valid[..., None, :], iou, -1.0)
    best_gt = iou.argmax(dim=-1)
    best_iou = iou.amax(dim=-1)
    labels = torch.where(best_iou >= fg_thresh, 1, torch.where(best_iou < bg_thresh, 0, -1))
    best_anchor = iou.argmax(dim=-2)                       # [..., G]
    gt_index = torch.arange(iou.shape[-1], device=iou.device).expand_as(best_anchor)
    winner = torch.full(best_iou.shape, -1, dtype=torch.long, device=iou.device)
    winner = winner.scatter_reduce(-1, best_anchor, gt_index, reduce="amax")
    rescue = (winner >= 0) & gt_valid.gather(-1, winner.clamp(min=0))
    labels = torch.where(rescue, 1, labels)
    best_gt = torch.where(rescue, (iou + 1e-6).argmax(dim=-1), best_gt)
    return best_gt, labels


def sample_balanced(labels, generator: torch.Generator, *, num: int, fg_fraction: float):
    """labels [N] -> (fg_idx [n_fg], fg_take, bg_idx [num - n_fg], bg_take): up
    to num * fg_fraction fg, the rest bg, by a random top-k, so the shapes are
    fixed (torchvision samples 256 at 0.5 for the RPN). `generator` lies on
    the labels' device."""
    n_fg = int(num * fg_fraction)
    dev = labels.device
    u_fg = torch.rand(labels.shape, generator=generator, device=dev)
    u_bg = torch.rand(labels.shape, generator=generator, device=dev)
    fg_idx = torch.where(labels == 1, u_fg, -1.0).topk(n_fg).indices
    bg_idx = torch.where(labels == 0, u_bg, -1.0).topk(num - n_fg).indices
    return fg_idx, labels[fg_idx] == 1, bg_idx, labels[bg_idx] == 0


def image_generator(seed: int, image: int, device) -> torch.Generator:
    """The sampling stream of image `image` (its index in the GLOBAL batch) in
    the step of `seed`, on `device`: data-parallel ranks draw what one
    process draws for the same image."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(image)) % (1 << 63))
    return gen


def rpn_sampler(labels, seed: int, image: int):
    """detection_loss's default sampler: 256 anchors at fg 0.5."""
    return sample_balanced(labels, image_generator(seed, image, labels.device), num=256,
                           fg_fraction=0.5)


class DetectionBatch(NamedTuple):
    images: torch.Tensor     # [B, S, S, 3] float in [0, 1]
    gt_boxes: torch.Tensor   # [B, max_gt, 4]
    gt_labels: torch.Tensor  # [B, max_gt] int, 0 = padding


def _pyramid_fp32(params, images, compute_dtype):
    """Normalize, then backbone + FPN in `compute_dtype` on the master tree
    cast at use, fp32 maps out (None or fp32: the parity path)."""
    x = ((images - torch.tensor(IMAGE_MEAN, device=images.device))
         / torch.tensor(IMAGE_STD, device=images.device)).permute(0, 3, 1, 2)
    if compute_dtype is not None and compute_dtype != torch.float32:
        c = resnet_pyramid(cast_params(params["backbone"], compute_dtype), x.to(compute_dtype))
        return [f.float() for f in fpn_forward(cast_params(params["fpn"], compute_dtype), c)]
    return fpn_forward(params["fpn"], resnet_pyramid(params["backbone"], x))


def _rpn_head(params, p_feats):
    """(anchors [N, 4], objectness logits [B, N], deltas [B, N, 4]) over every
    level, each level's anchors flattened in (H, W, A) order."""
    rpn = params["rpn"]
    anchors, logits, deltas = [], [], []
    for lvl, f in enumerate(p_feats):
        bsz, _, h, w = f.shape
        t = torch.relu(_conv(f, rpn["conv"]["w"]) + rpn["conv"]["b"][:, None, None])
        t = t.permute(0, 2, 3, 1)
        logits.append((t @ rpn["cls"]["w"] + rpn["cls"]["b"]).reshape(bsz, -1))
        deltas.append((t @ rpn["bbox"]["w"] + rpn["bbox"]["b"]).reshape(bsz, -1, 4))
        anchors.append(level_anchors(h, w, 4 * 2 ** lvl, ANCHOR_SIZES[lvl], f.device))
    return torch.cat(anchors), torch.cat(logits, dim=1), torch.cat(deltas, dim=1)


def _fpn_level(boxes):
    """FPN level of each box, 0..3 over P2..P5 (k = 4 + log2(sqrt(area)/224))."""
    pw = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-6)
    ph = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-6)
    return torch.floor(4 + torch.log2(torch.sqrt(pw * ph) / 224 + 1e-6)).clamp(2, 5).long() - 2


def _box_head(params, p_feats, rois, num_classes: int):
    """ROIAlign of rois [B, R, 4] and the two-FC head -> (class logits
    [B, R, num_classes], box deltas [B, R, num_classes, 4]); the pooled
    [C, 7, 7] flattens C-major, as torchvision's fc6 reads it."""
    bsz, r = rois.shape[:2]
    pooled = roi_align_multilevel(p_feats[:4], rois, _fpn_level(rois), strides=STRIDES)
    flat = pooled.permute(0, 1, 4, 2, 3).reshape(bsz * r, -1)
    head = params["box_head"]
    h6 = torch.relu(flat @ head["fc6"]["w"] + head["fc6"]["b"])
    h7 = torch.relu(h6 @ head["fc7"]["w"] + head["fc7"]["b"])
    cls = (h7 @ head["cls_score"]["w"] + head["cls_score"]["b"]).float()
    box = h7 @ head["bbox_pred"]["w"] + head["bbox_pred"]["b"]
    return cls.reshape(bsz, r, num_classes), box.reshape(bsz, r, num_classes, 4)


def _class_rows(box_deltas, labels):
    """box_deltas [B, R, K, 4] at each row's class labels [B, R] -> [B, R, 4]."""
    idx = labels.clamp(min=0).long()[..., None, None].expand(-1, -1, 1, 4)
    return box_deltas.gather(2, idx)[:, :, 0]


def detection_loss(params, batch: DetectionBatch, seed: int, *, image_size: int,
                   num_classes: int, compute_dtype=None, sampler: Callable = rpn_sampler,
                   image_offset: int = 0):
    """The default loss of one step: the mean over the batch of the sampled
    RPN terms and the ROI head's, the head trained on the ground-truth boxes
    as proposals (the clean-proposal regime). `sampler(labels [N], seed,
    image)` draws each image's RPN sample, `image` its index in the global
    batch (`image_offset` + its row); tests pass the JAX package's draws.
    image_size is taken for the JAX package's signature."""
    params = as_tree(params)
    p_feats = _pyramid_fp32(params, batch.images, compute_dtype)
    anchors, logits, deltas = _rpn_head(params, p_feats)
    gt_boxes, gt_labels = batch.gt_boxes, batch.gt_labels.long()
    valid = gt_labels > 0

    # RPN
    gt_idx, alabels = match_anchors(anchors, gt_boxes, valid, fg_thresh=0.7, bg_thresh=0.3)
    samples = [sampler(alabels[b], seed, image_offset + b) for b in range(alabels.shape[0])]
    fg_idx, fg_take, bg_idx, bg_take = (torch.stack(t) for t in zip(*samples))
    fg_take, bg_take = fg_take.float(), bg_take.float()
    n_sampled = (fg_take.sum(-1) + bg_take.sum(-1)).clamp(min=1.0)
    cls_loss = -((F.logsigmoid(logits).gather(1, fg_idx) * fg_take).sum(-1)
                 + (F.logsigmoid(-logits).gather(1, bg_idx) * bg_take).sum(-1)) / n_sampled
    reg = smooth_l1(deltas - encode_boxes(_take(gt_boxes, gt_idx), anchors)).sum(-1)
    reg_loss = (reg.gather(1, fg_idx) * fg_take).sum(-1) / n_sampled

    # ROI head on the ground truth as proposals; its regression targets are 0
    cls_logits, box_deltas = _box_head(params, p_feats, gt_boxes, num_classes)
    n_valid = valid.float().sum(-1).clamp(min=1.0)
    logp = torch.log_softmax(cls_logits, dim=-1)
    roi_cls = -(logp.gather(-1, gt_labels[..., None])[..., 0] * valid).sum(-1) / n_valid
    roi_reg = (smooth_l1(_class_rows(box_deltas, gt_labels)).sum(-1) * valid).sum(-1) / n_valid
    return (cls_loss + reg_loss + roi_cls + roi_reg).mean()


def tv_detection_losses(params, images, gt_boxes, gt_labels, *, image_size: int,
                        num_classes: int, pre_nms_topk: int = 2000, post_nms_topk: int = 2000,
                        rpn_nms_candidates: int = 2000, compute_dtype=None,
                        stats: dict | None = None) -> dict:
    """torchvision's four train-mode terms ({loss_objectness,
    loss_rpn_box_reg, loss_classifier, loss_box_reg}), each [B], one a image
    of images [B, S, S, 3] in [0, 1], sampling every candidate (the take-all
    limit of torchvision's BalancedPositiveNegativeSampler), deterministic.

    RPN: anchors matched at 0.7 / 0.3 with the rescue; the objectness mean
    BCE over fg + bg; smooth-L1 (beta 1/9) of the encoded deltas over fg,
    over the same count. ROI: the proposals (models/detection.rpn_propose,
    under no_grad: torchvision decodes them from detached deltas, the JAX
    package's stop_gradient) ++ the ground truth, matched at 0.5 without
    rescue; the mean CE over every valid row; smooth-L1 of the matched
    class's deltas against targets encoded with weights (10, 10, 5, 5) over
    the fg rows, over the row count. The batch proposes in one call, with
    one NMS fixed point for every image (bit-equal to one image at a time).
    `stats` gets the RPN NMS's iteration count."""
    params = as_tree(params)
    p_feats = _pyramid_fp32(params, images, compute_dtype)
    gt_labels = gt_labels.long()
    gt_valid = gt_labels > 0

    anchors, logits, deltas = _rpn_head(params, p_feats)
    gt_idx, alabels = match_anchors(anchors, gt_boxes, gt_valid, fg_thresh=0.7, bg_thresh=0.3)
    fg = (alabels == 1).float()
    bg = (alabels == 0).float()
    n_sampled = (fg.sum(-1) + bg.sum(-1)).clamp(min=1.0)
    loss_objectness = -((F.logsigmoid(logits) * fg).sum(-1)
                        + (F.logsigmoid(-logits) * bg).sum(-1)) / n_sampled
    rpn_targets = encode_boxes(_take(gt_boxes, gt_idx), anchors)
    loss_rpn_box_reg = (smooth_l1(deltas - rpn_targets).sum(-1) * fg).sum(-1) / n_sampled

    with torch.no_grad():
        proposals, keep = rpn_propose(params, [f.detach() for f in p_feats],
                                      image_size=image_size, pre_nms_topk=pre_nms_topk,
                                      post_nms_topk=post_nms_topk,
                                      rpn_nms_candidates=rpn_nms_candidates, stats=stats)
    rois = torch.cat([proposals, gt_boxes], dim=1)                   # [B, R, 4]
    row_valid = torch.cat([keep, gt_valid], dim=1).float()
    iou = torch.where(gt_valid[:, None, :], box_iou(rois, gt_boxes), -1.0)
    best_gt = iou.argmax(dim=-1)
    roi_fg = (iou.amax(dim=-1) >= 0.5) & (row_valid > 0)
    labels_cls = torch.where(roi_fg, gt_labels.gather(1, best_gt), 0)

    cls_logits, box_deltas = _box_head(params, p_feats, rois, num_classes)
    n_rois = row_valid.sum(-1).clamp(min=1.0)
    ce = -torch.log_softmax(cls_logits, dim=-1).gather(-1, labels_cls[..., None])[..., 0]
    loss_classifier = (ce * row_valid).sum(-1) / n_rois
    roi_targets = encode_boxes(_take(gt_boxes, best_gt), rois) \
        * torch.tensor(ROI_BOX_REG_WEIGHTS, device=rois.device)
    sel = _class_rows(box_deltas, labels_cls)
    loss_box_reg = (smooth_l1(sel - roi_targets).sum(-1) * roi_fg.float()).sum(-1) / n_rois
    return {"loss_objectness": loss_objectness, "loss_rpn_box_reg": loss_rpn_box_reg,
            "loss_classifier": loss_classifier, "loss_box_reg": loss_box_reg}


def make_detection_train_step(tx, *, image_size: int, num_classes: int, dp=None,
                              tv_faithful: bool = False, tv_post_nms_topk: int = 512,
                              compute_dtype=None, sampler: Callable = rpn_sampler,
                              stats: dict | None = None):
    """Returns (state, batch, seed) -> (state, metrics).

    `batch`: a DetectionBatch (tensors or arrays), moved to the params'
    device; with `dp` (core/mesh.DataParallel), this
    rank's rows of the global batch, whose gradients and loss are averaged
    over the ranks with all_reduce (JAX's pmean: every rank holds as many
    images, so this is the global batch's mean). `seed` (an int) seeds the
    default loss's sampling, per image of the global batch.

    tv_faithful=True trains on the sum of tv_detection_losses' four terms
    (proposals from the RPN, post-NMS tv_post_nms_topk, pre-NMS twice that)
    in place of the clean-proposal loss; `stats` gets its NMS iteration
    counts. The params and moments are updated in place; the loss metric is
    a tensor on the device."""

    def step(state: TrainState, batch, seed: int):
        params = as_tree(state.params)
        dev = tree_leaves(params)[0].device
        b = DetectionBatch(*(torch.as_tensor(t).to(dev, non_blocking=True) for t in batch))
        if tv_faithful:
            terms = tv_detection_losses(
                params, b.images, b.gt_boxes, b.gt_labels, image_size=image_size,
                num_classes=num_classes, pre_nms_topk=tv_post_nms_topk * 2,
                post_nms_topk=tv_post_nms_topk, compute_dtype=compute_dtype, stats=stats)
            loss = sum(terms.values()).mean()
        else:
            offset = dp.rank * b.images.shape[0] if is_parallel(dp) else 0
            loss = detection_loss(params, b, seed, image_size=image_size,
                                  num_classes=num_classes, compute_dtype=compute_dtype,
                                  sampler=sampler, image_offset=offset)
        loss, grads = mean_grads(loss, params, dp)
        return apply_gradients(state, grads, tx), {"loss": loss}

    return step
