"""COCO-style mAP evaluation for the detector (the port's copy of
construction_clip_tpu/infer/detection_eval.py; host numpy, no device code).

Per-class greedy matching of score-ranked predictions to unmatched ground
truths at an IoU threshold, 101-point interpolated AP, averaged over classes
then over IoU thresholds 0.50:0.05:0.95 (plus the AP50/AP75 slices). The
reference never scores its detector (application.py:51-78).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """COCO 101-point interpolated AP over a (recall, precision) curve."""
    if len(recalls) == 0:
        return 0.0
    # precision envelope (monotone non-increasing from the right)
    prec = precisions.copy()
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    # sample at 101 recall points
    points = np.linspace(0, 1, 101)
    idx = np.searchsorted(recalls, points, side="left")
    sampled = np.where(idx < len(prec), prec[np.minimum(idx, len(prec) - 1)], 0.0)
    return float(sampled.mean())


def _class_ap(preds: List[dict], n_gt: int, iou_thresh: float) -> float:
    """preds: [{image_id, box, score}] for ONE class over all images, plus the
    per-image gt boxes stashed in each entry's 'gt' (see evaluate_detections)."""
    if n_gt == 0:
        return float("nan")  # class absent from ground truth: excluded from mean
    if not preds:
        return 0.0
    preds = sorted(preds, key=lambda p: -p["score"])
    matched: Dict[int, set] = {}
    tp = np.zeros(len(preds))
    fp = np.zeros(len(preds))
    for i, p in enumerate(preds):
        gts = p["gt"]
        if len(gts) == 0:
            fp[i] = 1
            continue
        ious = _iou_matrix(np.asarray([p["box"]], np.float64),
                           np.asarray(gts, np.float64))[0]
        used = matched.setdefault(p["image_id"], set())
        order = np.argsort(-ious)
        hit = -1
        for j in order:
            if ious[j] >= iou_thresh and j not in used:
                hit = int(j)
                break
        if hit >= 0:
            used.add(hit)
            tp[i] = 1
        else:
            fp[i] = 1
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recalls = ctp / n_gt
    precisions = ctp / np.maximum(ctp + cfp, 1e-9)
    return average_precision(recalls, precisions)


def evaluate_detections(predictions: Sequence[dict], ground_truths: Sequence[dict],
                        *, num_classes: int,
                        iou_thresholds: Sequence[float] = IOU_THRESHOLDS) -> dict:
    """predictions / ground_truths: one dict per image:
       {"boxes": [N,4] xyxy, "labels": [N] int (1-based), "scores": [N] (preds)}
    Returns {"mAP", "AP50", "AP75", "per_class": {label: AP@[.5:.95]}}.
    """
    per_image_gt = []
    for g in ground_truths:
        boxes = np.asarray(g["boxes"], np.float64).reshape(-1, 4)
        labels = np.asarray(g["labels"], int).reshape(-1)
        per_image_gt.append((boxes, labels))

    ap_by_thresh_class: Dict[float, Dict[int, float]] = {}
    for c in range(1, num_classes):
        n_gt = sum(int((labels == c).sum()) for _, labels in per_image_gt)
        cls_preds = []
        for img_id, p in enumerate(predictions):
            boxes = np.asarray(p["boxes"], np.float64).reshape(-1, 4)
            labels = np.asarray(p["labels"], int).reshape(-1)
            scores = np.asarray(p["scores"], np.float64).reshape(-1)
            gt_boxes, gt_labels = per_image_gt[img_id]
            gt_c = gt_boxes[gt_labels == c]
            for b, l, s in zip(boxes, labels, scores):
                if l == c and s > 0:
                    cls_preds.append({"image_id": img_id, "box": b, "score": s,
                                      "gt": gt_c})
        for thr in iou_thresholds:
            ap_by_thresh_class.setdefault(thr, {})[c] = _class_ap(
                [dict(p) for p in cls_preds], n_gt, thr)

    def mean_over_classes(thr):
        vals = [v for v in ap_by_thresh_class[thr].values() if not np.isnan(v)]
        return float(np.mean(vals)) if vals else 0.0

    per_class = {}
    for c in range(1, num_classes):
        vals = [ap_by_thresh_class[t][c] for t in iou_thresholds]
        vals = [v for v in vals if not np.isnan(v)]
        if vals:
            per_class[c] = float(np.mean(vals))
    result = {
        "mAP": float(np.mean([mean_over_classes(t) for t in iou_thresholds])),
        "AP50": mean_over_classes(0.5),
        "AP75": mean_over_classes(0.75) if 0.75 in ap_by_thresh_class else 0.0,
        "per_class": per_class,
    }
    return result


def detections_to_eval_format(det, *, min_score: float = 0.0) -> dict:
    """One image's Detections (fixed slots, score-0 padding; host arrays, e.g.
    a row of models.detection.Detections moved to the CPU) -> eval dict."""
    boxes = np.asarray(det.boxes)
    labels = np.asarray(det.labels)
    scores = np.asarray(det.scores)
    live = scores > min_score
    return {"boxes": boxes[live], "labels": labels[live], "scores": scores[live]}


def clip_gt_to_center_square(boxes, labels, h: int, w: int, *,
                             min_visible: float = 0.5):
    """Clip GT boxes to the centered min(h,w) square that square-staging
    (data/pipeline.host_shape_unify) makes visible to the detector.

    Boxes with less than `min_visible` of their area inside the square are
    excluded (returned as the third element's count) so mAP scores the model
    rather than the staging geometry — see apps/eval_detection.py.
    Returns (clipped_boxes, kept_labels, n_excluded).
    """
    side = min(h, w)
    x0, y0 = (w - side) / 2.0, (h - side) / 2.0
    out_boxes, out_labels, excluded = [], [], 0
    for b, l in zip(boxes, labels):
        bx1, by1, bx2, by2 = map(float, b)
        ix1, iy1 = max(bx1, x0), max(by1, y0)
        ix2, iy2 = min(bx2, x0 + side), min(by2, y0 + side)
        inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
        area = max(1e-6, (bx2 - bx1) * (by2 - by1))
        if inter / area < min_visible:
            excluded += 1
            continue
        out_boxes.append([ix1, iy1, ix2, iy2])
        out_labels.append(l)
    return out_boxes, out_labels, excluded
