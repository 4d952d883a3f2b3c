"""Detector evaluation (the port's counterpart of apps/eval_detection.py): run
the Faster R-CNN over a box-annotated dataset and print COCO-style mAP
(mAP@[.5:.95], AP50, AP75, per class) as JSON.

    python -m construction_clip_tpu_torch.apps.eval_detection --json_path boxes.json \\
        --image_root images/ --checkpoint model_final.pth

Dataset JSON: {"annotations": [{"file_name": ..., "boxes": [[x1,y1,x2,y2]...],
"labels": [int...]}]}, boxes in the original image's pixels, labels 1-based.

The flags are the JAX app's, plus --device: `cuda` (the default; an error
where no CUDA device works) or `cpu`. --precision fp32 (the default) is the
torchvision-parity numerics, bf16 the serving configuration, auto bf16 on the
card and fp32 on the CPU. Without --checkpoint the weights are random, from
numpy seed 0. As in the JAX app, the detector stages by letterbox while the
ground truth is clipped to the centred square (clip_gt_to_center_square), so
a detection in a long side's band scores as a false positive.

The per-image work is `evaluate_image`, which takes arrays; `evaluate` runs
a corpus through a `load_image` hook (PIL's reader in `main`; on a machine
without PIL, pass another).
"""

from __future__ import annotations

import argparse
import json
import os

from construction_clip_tpu_torch.apps.common import add_device_flag, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", required=True)
    p.add_argument("--image_root", default=".")
    p.add_argument("--checkpoint", default=None,
                   help="torchvision-layout .pth state dict (model_final.pth)")
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--min_score", type=float, default=0.0)
    p.add_argument("--out", default=None, help="write the metrics JSON here too")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16", "auto"],
                   help="detector compute precision: fp32 = torchvision-parity numerics; "
                        "bf16 = the serving configuration; auto = bf16 on the card")
    add_device_flag(p)
    return p.parse_args(argv)


def evaluate_image(detector, img, ann: dict, *, min_score: float = 0.0):
    """One image (uint8 [H, W, 3]) and its annotation -> (prediction, ground
    truth clipped to the centred square, the count of ground-truth boxes
    mostly outside it)."""
    from construction_clip_tpu_torch.infer.detection_eval import clip_gt_to_center_square

    out = detector.detect(img)
    live = [(b, l, s) for b, l, s in zip(out["boxes"], out["labels"], out["scores"])
            if s > min_score]
    pred = {"boxes": [b for b, _, _ in live], "labels": [l for _, l, _ in live],
            "scores": [s for _, _, s in live]}
    h, w = img.shape[:2]
    boxes, labels, n_out = clip_gt_to_center_square(ann.get("boxes", []),
                                                    ann.get("labels", []), h, w)
    return pred, {"boxes": boxes, "labels": labels}, n_out


def evaluate(detector, annotations, image_root: str, load_image, *, num_classes: int,
             min_score: float = 0.0) -> dict:
    """The metrics dict the app prints: images that cannot be read are
    skipped and counted."""
    from construction_clip_tpu_torch.infer.detection_eval import evaluate_detections

    preds, gts = [], []
    skipped = gt_outside = 0
    for a in annotations:
        try:
            img = load_image(os.path.join(image_root, a["file_name"]))
        except (FileNotFoundError, OSError) as e:
            print(f"skip {a['file_name']}: {e}")
            skipped += 1
            continue
        pred, gt, n_out = evaluate_image(detector, img, a, min_score=min_score)
        preds.append(pred)
        gts.append(gt)
        gt_outside += n_out
    metrics = evaluate_detections(preds, gts, num_classes=num_classes)
    metrics["skipped_images"] = skipped
    metrics["evaluated_images"] = len(preds)
    metrics["gt_boxes_outside_crop"] = gt_outside
    return metrics


def main(argv=None, load_image=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    import torch

    from construction_clip_tpu_torch.serve.detector import TorchDetector

    if load_image is None:
        from construction_clip_tpu_torch.data.pipeline import default_load_image as load_image
    cd = {"fp32": torch.float32, "bf16": torch.bfloat16, "auto": None}[args.precision]
    det = TorchDetector(args.checkpoint, num_classes=args.num_classes,
                        image_size=args.image_size, compute_dtype=cd, device=device)
    with open(args.json_path, encoding="utf-8") as f:
        annotations = json.load(f)["annotations"]
    metrics = evaluate(det, annotations, args.image_root, load_image,
                       num_classes=args.num_classes, min_score=args.min_score)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(metrics, f, indent=2)


if __name__ == "__main__":
    main()
