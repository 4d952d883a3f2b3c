"""HTTP serving layer (the port's copy of the detector-free path of
construction_clip_tpu/serve/app.py): request coalescing, routes and the
`application.py` JSON contract, stdlib only.

Routes (reference application.py:231-263):
  POST /predict  multipart file upload -> {"boxes", "labels", "scores",
                 "caption_type", "violation_type", "caption"}; non-image extensions
                 get the reference's message.
  GET  /ping     {"response": <name>}
  GET  /         "Hello, World!"

The object detector is not ported: boxes, labels and scores are empty lists.
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

IMAGE_EXTENSIONS = {"ras", "xwd", "bmp", "jpe", "jpg", "jpeg", "xpm", "ief", "pbm",
                    "tif", "gif", "ppm", "xbm", "tiff", "rgb", "pgm", "png", "pnm"}
_NO_DETECTIONS = {"boxes": [], "labels": [], "scores": []}


class PredictService:
    """Serves one caption pipeline. With batch_window_ms > 0, concurrent
    requests are coalesced into one device batch by a batcher thread;
    `_caption_batch(staged_list)` (a subclass's) captions one such batch.
    Device work is serialised by a lock; decoding uploads and JSON stay
    threaded."""

    def __init__(self, caption_pipeline, detector=None, *, use_beam: bool = True,
                 batch_window_ms: float = 0.0, max_batch: int = 16):
        if detector is not None:
            raise NotImplementedError("the object detector is not ported")
        self.pipe = caption_pipeline
        self.use_beam = use_beam
        self._lock = threading.Lock()
        self._window = batch_window_ms / 1e3
        self._max_batch = max_batch
        self._pending: list = []  # [(staged, Event, slot)]
        self._cv = threading.Condition()
        if self._window > 0:
            threading.Thread(target=self._drain_loop, daemon=True,
                             name="predict-batcher").start()

    def _caption_batch(self, staged_list):
        raise NotImplementedError

    def predict(self, image_u8: np.ndarray) -> dict:
        staged = host_shape_unify(image_u8, 256)
        if self._window <= 0:
            with self._lock:
                pred = self._caption_batch([staged])[0]
        else:
            pred = self._predict_batched(staged)
        return {**_NO_DETECTIONS,
                "caption_type": pred["caption_type"],
                "violation_type": pred["violation_type"],
                "caption": pred["caption"]}

    def _predict_batched(self, staged):
        done = threading.Event()
        slot: list = [None, None]  # [caption result, error]
        with self._cv:
            self._pending.append((staged, done, slot))
            self._cv.notify()
        # bounded wait: if the batcher thread ever dies, fail fast instead of
        # hanging every later request on an event nobody will set
        if not done.wait(timeout=300.0):
            raise RuntimeError("predict batcher did not respond within 300 s")
        if slot[1] is not None:
            raise slot[1]
        return slot[0]

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
                for (_, ev, sl), p in zip(batch, preds):
                    sl[0] = p
                    ev.set()
            except Exception as e:  # noqa: BLE001 — propagate to every waiter, keep serving
                for _, ev, sl in batch:
                    sl[1] = e
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
