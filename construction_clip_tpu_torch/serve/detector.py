"""Object detection behind the serving path (the port of
construction_clip_tpu/serve/detector.py).

The reference serves torchvision Faster R-CNN (ResNet-50-FPN) with a 7-class
construction head (application.py:13-25,51-70). A detector answers
detect(image_u8) -> {"boxes": [[x1, y1, x2, y2], ...], "labels": [...],
"scores": [...]}, the reference's JSON shape; detect_batch(staged, sizes)
answers a coalesced batch.

  - NullDetector: empty detections (serving runs classify + caption only).
  - TorchDetector: the port's Faster R-CNN (models/detection.py) on a device.
  - ThresholdWrapper: the reference's 0.8 score threshold and label names.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from construction_clip_tpu_torch.data.labels import DETECTOR_CLASSES


class Detector(Protocol):
    def detect(self, image_u8: np.ndarray) -> dict: ...


class NullDetector:
    """No detector available: empty detections, same response shape."""

    def detect(self, image_u8: np.ndarray) -> dict:
        return {"boxes": [], "labels": [], "scores": []}

    def detect_batch(self, staged_u8, sizes) -> list[dict]:
        return [{"boxes": [], "labels": [], "scores": []} for _ in sizes]


class TorchDetector:
    """The port's Faster R-CNN behind the serving interface.

    checkpoint: a torchvision-layout .pth state dict (the reference's
    model_final.pth), a detector tree in the JAX layout (`init_fasterrcnn` of
    either package, or a converted state dict), or None for random weights
    from numpy seed 0 (`convert.init_fasterrcnn`; other numbers than the JAX
    package's jax.random.key(0) tree).

    Staging: geometry="letterbox" (the default, the reference's no-crop
    contract) scales the long side to image_size and zero-pads to a square;
    "crop" scales the short side and centre-crops. Boxes map back to the
    original pixels per geometry. num_classes=7 is the reference head
    (application.py:14).

    device: "cuda" (the default; an error where no CUDA device works, never a
    move to the CPU) or "cpu". compute_dtype: the conv/GEMM stages' dtype;
    None is bf16 on the card and fp32 on the CPU, as the JAX package picks
    bf16 off the CPU (box arithmetic is fp32 either way). The tree is cast
    once, here."""

    def __init__(self, checkpoint=None, *, num_classes: int = 7, image_size: int = 800,
                 geometry: str = "letterbox", class_names=DETECTOR_CLASSES,
                 compute_dtype=None, device="cuda"):
        import torch

        from construction_clip_tpu_torch import convert
        from construction_clip_tpu_torch.models import detection as det

        if geometry not in ("letterbox", "crop"):
            raise ValueError(f"geometry must be letterbox|crop, got {geometry!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchDetector(device={str(device)!r}): no usable CUDA device "
                               "(torch.cuda.is_available() is false); pass --device cpu "
                               "to run on the CPU")
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        if isinstance(checkpoint, str):
            from construction_clip_tpu_torch.models.clip.convert import load_torch_checkpoint

            tree = det.from_torchvision_state_dict(load_torch_checkpoint(checkpoint),
                                                   num_classes=num_classes)
        elif checkpoint is None:
            tree = convert.init_fasterrcnn(0, num_classes=num_classes)
        else:
            tree = checkpoint
        self.params = convert.to_detector_params(tree, dtype=compute_dtype, device=self.device)
        self.image_size = image_size
        self.geometry = geometry
        self.num_classes = num_classes
        self.class_names = class_names
        self.compute_dtype = compute_dtype
        self._infer = det.fasterrcnn_infer

    def stage(self, image_u8: np.ndarray) -> np.ndarray:
        """One image on the host as the detector's [S, S, 3] uint8 input, per
        the geometry (the serve batcher calls this before coalescing)."""
        from construction_clip_tpu_torch.data.pipeline import host_letterbox, host_shape_unify

        if self.geometry == "letterbox":
            return host_letterbox(image_u8, self.image_size)
        return host_shape_unify(image_u8, self.image_size)

    def _map_back(self, det_boxes, det_labels, det_scores, size) -> dict:
        """Detections from the staged square back to the original pixels.

        letterbox: the content fills [0, nw) x [0, nh) of the square, so a
        per-axis scale by (nw/w, nh/h), then a clip to the image (torchvision
        clip_boxes_to_image). crop: the short-side scale plus the crop's
        offset (boxes can only land in the central square)."""
        h, w = size
        if self.geometry == "letterbox":
            from construction_clip_tpu_torch.data.pipeline import letterbox_dims

            nh, nw = letterbox_dims(h, w, self.image_size)
            sx, sy = nw / w, nh / h
            off_x = off_y = 0.0
        else:
            sx = sy = self.image_size / min(h, w)
            off_x = (max(w, h) - min(w, h)) / 2 if w > h else 0.0
            off_y = (max(w, h) - min(w, h)) / 2 if h > w else 0.0
        boxes, labels, scores = [], [], []
        for b, l, s in zip(det_boxes, det_labels, det_scores):
            if s <= 0:
                continue
            x1 = min(max(float(b[0]) / sx + off_x, 0.0), w)
            y1 = min(max(float(b[1]) / sy + off_y, 0.0), h)
            x2 = min(max(float(b[2]) / sx + off_x, 0.0), w)
            y2 = min(max(float(b[3]) / sy + off_y, 0.0), h)
            boxes.append([x1, y1, x2, y2])
            labels.append(int(l))
            scores.append(float(s))
        return {"boxes": boxes, "labels": labels, "scores": scores}

    def detect(self, image_u8: np.ndarray) -> dict:
        return self.detect_batch(self.stage(image_u8)[None], [image_u8.shape[:2]])[0]

    def detect_batch(self, staged_u8, sizes) -> list[dict]:
        """staged_u8: [B, S, S, 3] uint8 (staged by `stage`); sizes: each
        image's original (h, w). The uint8 batch goes to the device and is
        cast and scaled there; one batched forward; the boxes, labels and
        scores come back as one packed [B, N, 6] fp32 copy."""
        import torch

        with torch.inference_mode():
            x = torch.from_numpy(np.require(staged_u8, np.uint8, "CW")).to(self.device)
            out = self._infer(self.params, x.float() / 255.0, image_size=self.image_size,
                              num_classes=self.num_classes, compute_dtype=self.compute_dtype)
            packed = torch.cat([out.boxes.float(), out.labels.float()[..., None],
                                out.scores.float()[..., None]], dim=-1).cpu().numpy()
        boxes = packed[..., :4]
        labels = packed[..., 4].astype(np.int64)
        scores = packed[..., 5]
        return [self._map_back(boxes[i], labels[i], scores[i], sizes[i])
                for i in range(len(sizes))]


class ThresholdWrapper:
    """Apply the reference's 0.8 score threshold + label-name mapping
    (application.py:60-70) around any raw detector."""

    def __init__(self, inner: Detector, *, threshold: float = 0.8,
                 class_names=DETECTOR_CLASSES):
        self.inner = inner
        self.threshold = threshold
        self.class_names = class_names

    @property
    def image_size(self):
        return getattr(self.inner, "image_size", None)

    @property
    def geometry(self):
        return getattr(self.inner, "geometry", None)

    def stage(self, image_u8: np.ndarray) -> np.ndarray:
        return self.inner.stage(image_u8)

    def _apply(self, raw: dict) -> dict:
        boxes, labels, scores = [], [], []
        for b, l, s in zip(raw["boxes"], raw["labels"], raw["scores"]):
            if s >= self.threshold:
                boxes.append([float(x) for x in b])
                name = self.class_names[int(l)] if isinstance(l, (int, np.integer)) \
                    and int(l) < len(self.class_names) else str(l)
                labels.append(name)
                scores.append(float(s))
        return {"boxes": boxes, "labels": labels, "scores": scores}

    def detect(self, image_u8: np.ndarray) -> dict:
        return self._apply(self.inner.detect(image_u8))

    def detect_batch(self, staged_u8, sizes) -> list[dict]:
        return [self._apply(r) for r in self.inner.detect_batch(staged_u8, sizes)]
