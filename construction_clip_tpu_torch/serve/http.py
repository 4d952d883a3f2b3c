"""HTTP serving layer (the port's copy of construction_clip_tpu/serve/app.py's
serving path): request coalescing, detection coalesced into the same drained
batch as captioning, routes and the `application.py` JSON contract, stdlib
only.

Routes (reference application.py:231-263):
  POST /predict  multipart file upload -> {"boxes", "labels", "scores",
                 "caption_type", "violation_type", "caption"}; non-image extensions
                 get the reference's message.
  GET  /ping     {"response": <name>}
  GET  /         "Hello, World!"

boxes, labels and scores come from the detector (serve/detector.py); without
one (NullDetector) they are empty lists.
"""

from __future__ import annotations

import io
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from construction_clip_tpu_torch.data.pipeline import host_shape_unify
from construction_clip_tpu_torch.serve.detector import NullDetector

IMAGE_EXTENSIONS = {"ras", "xwd", "bmp", "jpe", "jpg", "jpeg", "xpm", "ief", "pbm",
                    "tif", "gif", "ppm", "xbm", "tiff", "rgb", "pgm", "png", "pnm"}


def pow2_pad(items: list, cap: int) -> list:
    """items padded with copies of the last to the next power of two, capped
    at `cap`: a drain of n requests then runs one of log2(cap)+1 batch shapes
    (a non-power-of-two cap, e.g. 12, never pads past itself)."""
    padded = 1
    while padded < len(items):
        padded *= 2
    padded = min(padded, cap)
    return list(items) + [items[-1]] * (padded - len(items))


class PredictService:
    """Serves one caption pipeline and a detector. With batch_window_ms > 0,
    concurrent requests are coalesced into one device batch by a batcher
    thread; `_caption_batch(staged_list)` (a subclass's) captions one such
    batch, and a real detector (one with an image_size) detects the same
    drained batch in one `detect_batch`. Device work is serialised by a lock;
    decoding uploads and JSON stay threaded."""

    def __init__(self, caption_pipeline, detector=None, *, use_beam: bool = True,
                 batch_window_ms: float = 0.0, max_batch: int = 16):
        self.pipe = caption_pipeline
        self.detector = detector or NullDetector()
        self.use_beam = use_beam
        self._lock = threading.Lock()
        self._window = batch_window_ms / 1e3
        self._max_batch = max_batch
        self._det_size = getattr(self.detector, "image_size", None)
        self._pending: list = []  # [(staged_cap, staged_det, (h, w), Event, slot)]
        self._cv = threading.Condition()
        if self._window > 0:
            threading.Thread(target=self._drain_loop, daemon=True,
                             name="predict-batcher").start()

    def _caption_batch(self, staged_list):
        raise NotImplementedError

    def _detect_batch(self, staged_list, sizes):
        n = len(staged_list)
        staged_list = pow2_pad(staged_list, self._max_batch)
        sizes = pow2_pad(sizes, self._max_batch)
        return self.detector.detect_batch(np.stack(staged_list), sizes)[:n]

    def predict(self, image_u8: np.ndarray) -> dict:
        staged = host_shape_unify(image_u8, 256)
        if self._window <= 0:
            detection = self.detector.detect(image_u8)
            with self._lock:
                pred = self._caption_batch([staged])[0]
        elif self._det_size is None:   # null detector: free, stays inline
            detection = self.detector.detect(image_u8)
            pred, _ = self._predict_batched(staged, None, image_u8.shape[:2])
        else:
            # a real detector owns its staging geometry (letterbox by default);
            # one without stage() gets the centre-crop unify
            stage_fn = getattr(self.detector, "stage", None)
            det_staged = (stage_fn(image_u8) if stage_fn
                          else host_shape_unify(image_u8, self._det_size))
            pred, detection = self._predict_batched(staged, det_staged, image_u8.shape[:2])
        return {
            "boxes": detection["boxes"],
            "labels": detection["labels"],
            "scores": detection["scores"],
            "caption_type": pred["caption_type"],
            "violation_type": pred["violation_type"],
            "caption": pred["caption"],
        }

    def _predict_batched(self, staged, det_staged, size):
        done = threading.Event()
        slot: list = [None, None, None]  # [caption result, detection, error]
        with self._cv:
            self._pending.append((staged, det_staged, size, done, slot))
            self._cv.notify()
        # bounded wait: if the batcher thread ever dies, fail fast instead of
        # hanging every later request on an event nobody will set
        if not done.wait(timeout=300.0):
            raise RuntimeError("predict batcher did not respond within 300 s")
        if slot[2] is not None:
            raise slot[2]
        return slot[0], slot[1]

    def _drain_loop(self):
        """Wait up to the coalescing window for a FULL batch to form, then drain
        whatever is pending. Draining early only on a full batch: draining
        whenever anything is pending lets the first resubmitters of a closed
        loop run as a tiny batch and the rest pay a whole extra cycle."""
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                if len(self._pending) < self._max_batch:
                    # releases the lock while waiting, so requests keep queueing
                    self._cv.wait_for(lambda: len(self._pending) >= self._max_batch,
                                      timeout=self._window)
                batch = self._pending[: self._max_batch]
                self._pending = self._pending[self._max_batch:]
            if not batch:
                continue
            try:
                with self._lock:
                    preds = self._caption_batch([b[0] for b in batch])
                    dets = (self._detect_batch([b[1] for b in batch], [b[2] for b in batch])
                            if self._det_size is not None else [None] * len(batch))
                for (_, _, _, ev, sl), p, d in zip(batch, preds, dets):
                    sl[0] = p
                    sl[1] = d
                    ev.set()
            except Exception as e:  # noqa: BLE001 — propagate to every waiter, keep serving
                for _, _, _, ev, sl in batch:
                    sl[2] = e
                    ev.set()


def _parse_multipart(body: bytes, content_type: str) -> Optional[tuple[str, bytes]]:
    """Extract (filename, data) of the 'file' field from a multipart body."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return None
    boundary = m.group(1).encode()
    for part in body.split(b"--" + boundary):
        if b"Content-Disposition" not in part:
            continue
        header_end = part.find(b"\r\n\r\n")
        if header_end < 0:
            continue
        headers = part[:header_end].decode("utf-8", "replace")
        fm = re.search(r'name="file".*?filename="([^"]*)"', headers, re.S)
        if not fm:
            continue
        data = part[header_end + 4:]
        if data.endswith(b"\r\n"):
            data = data[:-2]
        return fm.group(1), data
    return None


def make_handler(service: PredictService):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code: int = 200):
            payload = json.dumps(obj, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/ping":
                self._json({"response": "construction_clip_tpu_torch.serve"})
            elif self.path == "/":
                body = b"Hello, World!"
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/predict":
                self._json({"error": "not found"}, 404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            parsed = _parse_multipart(body, ctype) if "multipart" in ctype else None
            if parsed is None:
                self._json({"error": "multipart form with a 'file' field required"}, 400)
                return
            filename, data = parsed
            ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
            if ext not in IMAGE_EXTENSIONS:
                # reference's exact message (application.py:238)
                self._json("Please upload an appropriate image file")
                return
            try:
                from PIL import Image

                img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                                 dtype=np.uint8)
            except Exception as e:  # noqa: BLE001 — any undecodable upload is a 400
                self._json({"error": f"cannot decode image: {e}"}, 400)
                return
            self._json(service.predict(img))

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve(service: PredictService, *, host: str = "0.0.0.0", port: int = 8000):
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"serving on {host}:{port}")
    httpd.serve_forever()
