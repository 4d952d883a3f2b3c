"""HTTP serving of the port: the serving layer of serve/http.py (request
batching, detection coalesced with captioning, routes, JSON contract) driven
by the port's CaptionPipeline and, where given, a serve/detector.py detector.

    from construction_clip_tpu_torch.serve.app import serve
    serve(TorchPredictService(pipeline, detector=ThresholdWrapper(TorchDetector()),
                              batch_window_ms=20, max_batch=8))
"""

from __future__ import annotations

import numpy as np

from construction_clip_tpu_torch.data.preprocess import preprocess_batch
from construction_clip_tpu_torch.serve.http import (
    PredictService, pow2_pad, make_handler, serve)

__all__ = ["TorchPredictService", "make_handler", "serve"]


class TorchPredictService(PredictService):
    """PredictService whose caption batch is preprocessed and captioned by the
    port, on the pipeline's device; the detector's batch runs on its own
    device (serve/detector.TorchDetector)."""

    def _caption_batch(self, staged_list):
        n = len(staged_list)
        staged_list = pow2_pad(staged_list, self._max_batch)
        size = self.pipe.clip_cfg.vision.image_size
        imgs = preprocess_batch(np.stack(staged_list), size, device=self.pipe.device)
        return self.pipe.caption_images(imgs, use_beam=self.use_beam)[:n]
