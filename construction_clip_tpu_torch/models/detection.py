"""Faster R-CNN (ResNet-50-FPN) inference, the port of
construction_clip_tpu/models/detection.py (the reference serves torchvision's
`fasterrcnn_resnet50_fpn` with a construction head, application.py:13-25):

  backbone   ResNet-50 C2..C5 (models/resnet.py) -> FPN P2..P5, P6 = P5[::2, ::2]
  rpn        shared 3x3 conv head, 3 anchors a location, per-level top-k,
             decode + clip, per-level NMS over the top 2000 candidates
  roi        FPN level assignment, ROIAlign 7x7 (sampling ratio 2,
             aligned=False) as one flat gather, 2 x FC-1024, per-class
             decode + NMS, the top `detections_per_img` by score

Every stage runs batched over the images of a call (the JAX package vmaps one
image's program): the backbone and heads on cuDNN convolutions and cuBLAS
GEMMs in `compute_dtype`, the box arithmetic, softmax and ROIAlign's
interpolation weights in fp32. Shapes are fixed (top-k and masks instead of
dynamic filtering), as in the JAX package. Where JAX takes a top-k or an
argsort, the port sorts stably in descending order, so ties keep the lower
index as `lax.top_k` and `jnp.argsort` do. NMS is JAX's antitone fixed
point, iterated for all the images (and classes) of a call at once until
none changes, one host synchronise an iteration.

The tree (`convert.to_detector_params`) is the JAX package's with
convolution weights in OIHW, channels-last; activations are logical NCHW in
channels-last memory. `from_torchvision_state_dict` gives the JAX package's
tree (numpy, HWIO), array for array.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from construction_clip_tpu_torch.models.resnet import WIDTHS, _bottleneck, _conv, stem

# torchvision defaults
ANCHOR_SIZES = (32, 64, 128, 256, 512)  # one per level P2..P6
ASPECT_RATIOS = (0.5, 1.0, 2.0)
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
_DELTA_CLIP = math.log(1000.0 / 16)
_NEG_INF = float("-inf")


# ---------------------------------------------------------------- backbone/FPN

def resnet_pyramid(params, images):
    """images [B, 3, H, W] -> (C2, C3, C4, C5), strides 4, 8, 16, 32."""
    x = stem(params, images)
    feats = []
    for s, blocks in enumerate(params["stages"]):
        for b, bp in enumerate(blocks):
            x = _bottleneck(x, bp, 2 if (s > 0 and b == 0) else 1)
        feats.append(x)
    return tuple(feats)


def _channel_linear(x, p):
    """x @ w + b over the channels of a [B, C, H, W] map (the JAX package's
    NHWC matmul; on channels-last memory the permutes are views)."""
    return (x.permute(0, 2, 3, 1) @ p["w"] + p["b"]).permute(0, 3, 1, 2)


def fpn_forward(fpn_params, c_feats):
    """C2..C5 -> P2..P6 (256 channels; P6 = P5 at stride 2).

    The top-down upsample is nearest with half-pixel centres
    (`nearest-exact`), as `jax.image.resize(method="nearest")`; at sizes that
    are not an exact 2x (image sizes that are not multiples of 64) torch's
    `nearest` picks other rows."""
    laterals = [_channel_linear(c, fpn_params["inner"][i]) for i, c in enumerate(c_feats)]
    outs = [None] * 4
    prev = laterals[-1]
    outs[3] = prev
    for i in (2, 1, 0):
        up = F.interpolate(prev, size=tuple(laterals[i].shape[-2:]), mode="nearest-exact")
        prev = laterals[i] + up
        outs[i] = prev
    ps = [_conv(outs[i], fpn_params["layer"][i]["w"]) + fpn_params["layer"][i]["b"][:, None, None]
          for i in range(4)]
    return ps + [ps[3][:, :, ::2, ::2]]  # P2..P6


# --------------------------------------------------------------------- anchors

@functools.lru_cache(maxsize=64)
def _anchors(h: int, w: int, stride: int, size: float, device: str):
    anchors = []
    for ar in ASPECT_RATIOS:
        h_r = np.sqrt(ar)
        aw = size / h_r
        ah = size * h_r
        anchors.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    base = np.asarray(anchors, np.float32)  # [3, 4]
    ys = np.arange(h, dtype=np.float32) * stride
    xs = np.arange(w, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y], axis=-1).reshape(-1, 1, 4)
    return torch.from_numpy((shifts + base[None]).reshape(-1, 4)).to(device)


def level_anchors(h: int, w: int, stride: int, size: float, device="cpu"):
    """[h*w*3, 4] xyxy anchors for one level (torchvision AnchorGenerator math:
    per cell, 3 aspect ratios of one base size, centred on cell*stride), made
    once per (h, w, stride, size, device). Callers must not write to it."""
    return _anchors(h, w, stride, float(size), str(torch.device(device)))


# --------------------------------------------------------------- box utilities

def decode_boxes(deltas, anchors, *, clip_hw=None):
    """torchvision BoxCoder.decode: deltas [..., 4] (dx, dy, dw, dh) on xyxy
    anchors [..., 4] (broadcast against each other)."""
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = deltas[..., 2].clamp(max=_DELTA_CLIP)
    dh = deltas[..., 3].clamp(max=_DELTA_CLIP)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    if clip_hw is not None:
        H, W = clip_hw
        boxes = torch.stack([boxes[..., 0].clamp(0, W), boxes[..., 1].clamp(0, H),
                             boxes[..., 2].clamp(0, W), boxes[..., 3].clamp(0, H)], dim=-1)
    return boxes


def box_iou(a, b):
    """[..., N, 4] x [..., M, 4] -> [..., N, M] IoU."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=1e-6)


def _top_k(x, k: int):
    """Top k along the last axis, the lower index first among equal values
    (the order lax.top_k and jnp.argsort(-x) give)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take(x, idx):
    """x [B, n, ...] rows at idx [B, m] -> [B, m, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def nms_mask(boxes, scores, *, iou_threshold: float, max_out: int,
             num_candidates: int | None = None, stats: dict | None = None):
    """Static-shape greedy NMS over a batch of independent sets: boxes
    [B, n, 4], scores [B, n] -> (indices [B, max_out] into each set's boxes,
    keep mask [B, max_out]), survivors compacted to the front in descending
    score order. Suppression runs over the top `num_candidates` (default all).

    Greedy NMS is the unique fixed point of F(alive)[j] = not exists i < j:
    alive[i] and iou[i, j] > thr, and F is antitone, so iterating from all
    alive reaches it, at most k iterations (JAX's while_loop). A set that has
    converged is unchanged by F, so every set of the batch iterates until the
    last converges; each iteration's test is one host synchronise. `stats`,
    where given, gets the iteration count appended to "nms_iterations"."""
    bsz, n = scores.shape
    k = n if num_candidates is None else min(num_candidates, n)
    order = _top_k(scores, k)[1]
    boxes_s = _take(boxes, order)
    scores_s = _take(scores, order)
    iou = box_iou(boxes_s, boxes_s)
    valid = scores_s > _NEG_INF
    strict = torch.ones(k, k, dtype=torch.bool, device=scores.device).triu(1)
    kill = (iou > iou_threshold) & strict & valid[:, :, None]
    prev, alive = valid, valid & ~kill.any(dim=1)
    iterations = 0
    while iterations < k and bool((alive != prev).any()):
        prev, alive = alive, valid & ~(kill & alive[:, :, None]).any(dim=1)
        iterations += 1
    if stats is not None:
        stats.setdefault("nms_iterations", []).append(iterations)

    m = min(max_out, k)
    rank = alive.long().cumsum(dim=1) - 1                       # survivor rank
    slot = torch.where(alive & (rank < m), rank, m)             # dead / overflow -> m
    src = torch.arange(k, device=scores.device).expand(bsz, k)
    compact = torch.zeros(bsz, m + 1, dtype=torch.long, device=scores.device)
    compact.scatter_(1, slot, src)
    idx = torch.gather(order, 1, compact[:, :m])
    keep = torch.arange(m, device=scores.device)[None] < \
        alive.sum(dim=1, keepdim=True).clamp(max=m)
    if m < max_out:
        idx = F.pad(idx, (0, max_out - m))
        keep = F.pad(keep, (0, max_out - m))
    return idx, keep


# ------------------------------------------------------------------- ROIAlign

def _axis_weights(coords, size):
    """torchvision bilinear_interpolate (aligned=False) along one axis, per
    box: clamp at 0; rows past size - 1 collapse (fraction 0); coordinates
    below -1 or above size are zeroed. coords [B, N, K], size [B, N]."""
    sz = size[..., None]
    in_range = (coords >= -1.0) & (coords <= sz)
    c = coords.clamp(min=0.0)
    lo = torch.minimum(torch.floor(c), sz - 1)
    frac = torch.where(lo >= sz - 1, 0.0, c - lo)
    lo_i = lo.long()
    hi_i = torch.minimum(lo_i + 1, sz.long() - 1)
    return lo_i, hi_i, frac, in_range


def roi_align_multilevel(feats, boxes, lvl_assign, *, strides, out_size: int = 7,
                         sampling_ratio: int = 2):
    """Multi-level ROIAlign as one flat gather: feats, a list of [B, C, H_l,
    W_l] maps (P2..P5); boxes [B, N, 4] xyxy in image pixels; lvl_assign
    [B, N] the level of each box. Returns [B, N, out, out, C].

    The levels of all images concatenate into one [B * sum(H_l W_l), C] row
    table; the 4 bilinear corners are four [B, N, K, K] row gathers at each
    box's level offset. Interpolation weights are fp32 (from fp32 boxes);
    the gathered values keep the maps' dtype, so in bf16 the products and
    their mean are fp32, as in the JAX package."""
    if len(feats) != len(strides):
        raise ValueError(f"{len(feats)} maps for {len(strides)} strides")
    bsz, n = lvl_assign.shape
    dev = boxes.device
    C = feats[0].shape[1]
    hw = [(f.shape[2], f.shape[3]) for f in feats]
    offs = np.concatenate([[0], np.cumsum([h * w for h, w in hw])])
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(bsz, -1, C) for f in feats], dim=1)
    flat = flat.reshape(-1, C)
    dims = torch.tensor(hw, dtype=torch.long, device=dev)               # [L, 2]
    scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=dev)[lvl_assign]
    Hl = dims[lvl_assign, 0].float()
    Wl = dims[lvl_assign, 1].float()
    base = (torch.tensor(offs[:-1], dtype=torch.long, device=dev)[lvl_assign]
            + torch.arange(bsz, device=dev)[:, None] * int(offs[-1]))   # [B, N]

    b = boxes * scale[..., None]
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    bw = (x2 - x1).clamp(min=1.0)
    bh = (y2 - y1).clamp(min=1.0)
    s = sampling_ratio
    grid = (torch.arange(out_size, device=dev)[:, None]
            + (torch.arange(s, device=dev) + 0.5)[None, :] / s).reshape(-1)   # [out*s]
    ys = y1[..., None] + grid * (bh / out_size)[..., None]              # [B, N, out*s]
    xs = x1[..., None] + grid * (bw / out_size)[..., None]
    y0i, y1i, ly, ok_y = _axis_weights(ys, Hl)
    x0i, x1i, lx, ok_x = _axis_weights(xs, Wl)
    wl = dims[lvl_assign, 1][..., None, None]                           # [B, N, 1, 1]

    def gather(yi, xi):
        return flat[base[..., None, None] + yi[..., :, None] * wl + xi[..., None, :]]

    f00 = gather(y0i, x0i)
    f01 = gather(y0i, x1i)
    f10 = gather(y1i, x0i)
    f11 = gather(y1i, x1i)
    wy = ly[..., :, None, None]
    wx = lx[..., None, :, None]
    val = (f00 * (1 - wy) * (1 - wx) + f01 * (1 - wy) * wx +
           f10 * wy * (1 - wx) + f11 * wy * wx)
    val = val * (ok_y[..., :, None] & ok_x[..., None, :])[..., None]
    val = val.reshape(bsz, n, out_size, s, out_size, s, C)
    return val.mean(dim=(3, 5))                                         # [B, N, out, out, C]


# ------------------------------------------------------------------- detector

class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, K, 4] fp32
    labels: torch.Tensor  # [B, K] int64 (0 = background / empty slot)
    scores: torch.Tensor  # [B, K] fp32


def cast_params(params, dtype):
    """The tree's floating leaves in `dtype` (leaves already in it are
    returned as they are, so a tree cast once costs nothing a call)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def rpn_propose(params, p_feats, *, image_size: int, pre_nms_topk: int,
                post_nms_topk: int, rpn_nms_thresh: float = 0.7,
                rpn_nms_candidates: int = 2000, stats: dict | None = None):
    """RPN proposals (torchvision RegionProposalNetwork.filter_proposals):
    per-level top-k on raw objectness, decode + clip, drop degenerate boxes,
    per-level NMS (coordinate offsets by level) over the top
    `rpn_nms_candidates`, the top `post_nms_topk`. Returns (proposals
    [B, post_nms_topk, 4], keep [B, post_nms_topk])."""
    rpn = params["rpn"]
    all_scores, all_boxes, all_lvls = [], [], []
    for lvl, feat in enumerate(p_feats):
        bsz, _, h, w = feat.shape
        t = torch.relu(_conv(feat, rpn["conv"]["w"]) + rpn["conv"]["b"][:, None, None])
        t = t.permute(0, 2, 3, 1)
        # box math is fp32 whatever the compute dtype (bf16 resolves ~2 px at 512)
        logits = (t @ rpn["cls"]["w"] + rpn["cls"]["b"]).reshape(bsz, -1).float()
        deltas = (t @ rpn["bbox"]["w"] + rpn["bbox"]["b"]).reshape(bsz, -1, 4).float()
        anchors = level_anchors(h, w, 4 * 2 ** lvl, ANCHOR_SIZES[lvl], feat.device)
        k = min(pre_nms_topk, logits.shape[1])
        top_s, top_i = _top_k(logits, k)
        all_scores.append(top_s)
        all_boxes.append(decode_boxes(_take(deltas, top_i), anchors[top_i],
                                      clip_hw=(image_size, image_size)))
        all_lvls.append(torch.full((bsz, k), float(lvl), device=feat.device))
    scores = torch.cat(all_scores, dim=1)
    boxes = torch.cat(all_boxes, dim=1)
    lvls = torch.cat(all_lvls, dim=1)
    # torchvision remove_small_boxes, min_size 1e-3
    valid = ((boxes[..., 2] - boxes[..., 0]) > 1e-3) & ((boxes[..., 3] - boxes[..., 1]) > 1e-3)
    scores = torch.where(valid, scores, _NEG_INF)
    nms_boxes = boxes + (lvls * (image_size + 2.0))[..., None]
    idx, keep = nms_mask(nms_boxes, scores, iou_threshold=rpn_nms_thresh,
                         max_out=post_nms_topk, num_candidates=rpn_nms_candidates,
                         stats=stats)
    return _take(boxes, idx) * keep[..., None], keep


def fasterrcnn_infer(params, images, *, image_size: int = 800,
                     pre_nms_topk: int = 1000, post_nms_topk: int = 300,
                     detections_per_img: int = 100, num_classes: int = 8,
                     rpn_nms_thresh: float = 0.7, box_nms_thresh: float = 0.5,
                     score_thresh: float = 0.05, rpn_nms_candidates: int = 2000,
                     compute_dtype=torch.float32, stats: dict | None = None) -> Detections:
    """images [B, S, S, 3] float in [0, 1] (square-staged). Returns fixed-size
    Detections; empty slots have score 0 and label 0.

    compute_dtype is the dtype of the conv/GEMM stages (backbone, FPN, RPN
    convs, box head); all box arithmetic (anchors, decode, IoU, NMS,
    coordinates up to image_size) and the softmax are fp32: head outputs are
    upcast before any coordinate math and ROIAlign's weights come from fp32
    proposals. `stats`, where given, gets the RPN's and then the box NMS's
    iteration counts under "nms_iterations"."""
    cd = compute_dtype
    params = cast_params(params, cd)
    x = images.to(cd)
    x = (x - torch.tensor(IMAGE_MEAN, dtype=cd, device=x.device)) \
        / torch.tensor(IMAGE_STD, dtype=cd, device=x.device)
    x = x.permute(0, 3, 1, 2)   # NCHW over NHWC bytes: channels-last
    p_feats = fpn_forward(params["fpn"], resnet_pyramid(params["backbone"], x))

    proposals, keep = rpn_propose(
        params, p_feats, image_size=image_size, pre_nms_topk=pre_nms_topk,
        post_nms_topk=post_nms_topk, rpn_nms_thresh=rpn_nms_thresh,
        rpn_nms_candidates=rpn_nms_candidates, stats=stats)
    return roi_heads(params, p_feats, proposals, keep, image_size=image_size,
                     detections_per_img=detections_per_img, num_classes=num_classes,
                     box_nms_thresh=box_nms_thresh, score_thresh=score_thresh,
                     compute_dtype=cd, stats=stats)


def roi_heads(params, p_feats, proposals, keep, *, image_size: int, detections_per_img: int,
              num_classes: int, box_nms_thresh: float, score_thresh: float, compute_dtype,
              stats: dict | None = None) -> Detections:
    """The second stage of fasterrcnn_infer on the RPN's proposals [B, P, 4]
    (keep [B, P]): FPN level assignment, ROIAlign, the two-FC box head, the
    softmax, per-class decode and NMS, the top `detections_per_img`. params
    must already be in compute_dtype (fasterrcnn_infer casts them)."""
    cd = compute_dtype
    bsz, n_prop = keep.shape

    # FPN level assignment (eq. 1: k = 4 + log2(sqrt(area)/224))
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=1e-6)
    lvl_assign = torch.floor(4 + torch.log2(torch.sqrt(pw * ph) / 224 + 1e-6)) \
        .clamp(2, 5).long() - 2                                         # 0..3 over P2..P5
    pooled = roi_align_multilevel(p_feats[:4], proposals, lvl_assign,
                                  strides=(4, 8, 16, 32)).to(cd)

    # torchvision flattens NCHW (C, 7, 7) into fc6: transpose to match its weights
    flat = pooled.permute(0, 1, 4, 2, 3).reshape(bsz * n_prop, -1)
    head = params["box_head"]
    h6 = torch.relu(flat @ head["fc6"]["w"] + head["fc6"]["b"])
    h7 = torch.relu(h6 @ head["fc7"]["w"] + head["fc7"]["b"])
    cls_logits = (h7 @ head["cls_score"]["w"] + head["cls_score"]["b"]).float()
    box_deltas = (h7 @ head["bbox_pred"]["w"] + head["bbox_pred"]["b"]).float()
    probs = torch.softmax(cls_logits, dim=-1).reshape(bsz, n_prop, num_classes)

    # per-class decode + NMS (class 0 = background), all classes at once
    nc = num_classes - 1
    deltas_c = box_deltas.reshape(bsz, n_prop, num_classes, 4)[:, :, 1:].transpose(1, 2)
    boxes_c = decode_boxes(deltas_c, proposals[:, None], clip_hw=(image_size, image_size))
    scores_c = probs[..., 1:].transpose(1, 2) * keep.float()[:, None]   # [B, nc, P]
    scores_c = torch.where(scores_c > score_thresh, scores_c, 0.0)
    # torchvision remove_small_boxes(min_size=1e-2) before the class NMS
    big = ((boxes_c[..., 2] - boxes_c[..., 0]) >= 1e-2) & \
          ((boxes_c[..., 3] - boxes_c[..., 1]) >= 1e-2)
    scores_c = torch.where(big, scores_c, 0.0).reshape(bsz * nc, n_prop)
    boxes_c = boxes_c.reshape(bsz * nc, n_prop, 4)
    idx_c, keep_c = nms_mask(boxes_c, torch.where(scores_c > 0, scores_c, _NEG_INF),
                             iou_threshold=box_nms_thresh, max_out=detections_per_img,
                             stats=stats)
    fb = _take(boxes_c, idx_c).reshape(bsz, nc * detections_per_img, 4)
    fs = (torch.gather(scores_c, 1, idx_c) * keep_c).reshape(bsz, nc * detections_per_img)
    fl = torch.arange(1, num_classes, device=fs.device).repeat_interleave(detections_per_img)
    top_s, top_i = _top_k(fs, detections_per_img)
    return Detections(boxes=_take(fb, top_i),
                      labels=torch.where(top_s > 0, fl[top_i], 0), scores=top_s)


# ------------------------------------------------------------------ converter

def from_torchvision_state_dict(sd, *, num_classes: int = 8) -> dict:
    """torchvision fasterrcnn_resnet50_fpn state dict (old `inner_blocks.{i}`
    and new `.{i}.0` naming) -> the JAX package's tree, numpy (convert with
    `convert.to_detector_params`). num_classes is the head's, read from the
    state dict's shapes; it is taken for the JAX package's signature."""
    from construction_clip_tpu_torch.models.resnet import (
        from_torchvision_state_dict as resnet_convert)

    def a(k):
        x = sd[k]
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.asarray(x)

    def pick(*names):
        for name in names:
            if name in sd:
                return name
        raise KeyError(names)

    def lin_from_conv1x1(k_w, k_b):
        return {"w": a(k_w)[:, :, 0, 0].T, "b": a(k_b)}   # [O, I, 1, 1] -> [I, O]

    def conv3(k_w, k_b):
        return {"w": a(k_w).transpose(2, 3, 1, 0), "b": a(k_b)}

    def lin(k_w, k_b):
        return {"w": a(k_w).T, "b": a(k_b)}

    backbone_sd = {k[len("backbone.body."):]: v for k, v in sd.items()
                   if k.startswith("backbone.body.")}
    inner, layer = [], []
    for i in range(len(WIDTHS)):
        inner.append(lin_from_conv1x1(
            pick(f"backbone.fpn.inner_blocks.{i}.0.weight", f"backbone.fpn.inner_blocks.{i}.weight"),
            pick(f"backbone.fpn.inner_blocks.{i}.0.bias", f"backbone.fpn.inner_blocks.{i}.bias")))
        layer.append(conv3(
            pick(f"backbone.fpn.layer_blocks.{i}.0.weight", f"backbone.fpn.layer_blocks.{i}.weight"),
            pick(f"backbone.fpn.layer_blocks.{i}.0.bias", f"backbone.fpn.layer_blocks.{i}.bias")))
    return {
        "backbone": resnet_convert(backbone_sd),
        "fpn": {"inner": inner, "layer": layer},
        "rpn": {
            "conv": conv3(pick("rpn.head.conv.0.0.weight", "rpn.head.conv.weight"),
                          pick("rpn.head.conv.0.0.bias", "rpn.head.conv.bias")),
            "cls": lin_from_conv1x1("rpn.head.cls_logits.weight", "rpn.head.cls_logits.bias"),
            "bbox": lin_from_conv1x1("rpn.head.bbox_pred.weight", "rpn.head.bbox_pred.bias"),
        },
        "box_head": {
            "fc6": lin("roi_heads.box_head.fc6.weight", "roi_heads.box_head.fc6.bias"),
            "fc7": lin("roi_heads.box_head.fc7.weight", "roi_heads.box_head.fc7.bias"),
            "cls_score": lin("roi_heads.box_predictor.cls_score.weight",
                             "roi_heads.box_predictor.cls_score.bias"),
            "bbox_pred": lin("roi_heads.box_predictor.bbox_pred.weight",
                             "roi_heads.box_predictor.bbox_pred.bias"),
        },
    }
