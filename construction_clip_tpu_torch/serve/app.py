"""HTTP serving of the port: the serving layer of serve/http.py (request
batching, routes, JSON contract) driven by the port's CaptionPipeline.

    from construction_clip_tpu_torch.serve.app import serve
    serve(TorchPredictService(pipeline, batch_window_ms=20, max_batch=8))
"""

from __future__ import annotations

import numpy as np

from construction_clip_tpu_torch.data.preprocess import preprocess_batch
from construction_clip_tpu_torch.serve.http import PredictService, make_handler, serve

__all__ = ["TorchPredictService", "make_handler", "serve"]


class TorchPredictService(PredictService):
    """PredictService whose caption batch is preprocessed and captioned by the
    port, on the pipeline's device."""

    def _caption_batch(self, staged_list):
        # pad to the next power of two, capped at max_batch: a drain of n
        # requests then runs one of log2(max_batch)+1 batch shapes
        n = len(staged_list)
        padded = 1
        while padded < n:
            padded *= 2
        padded = min(padded, self._max_batch)
        staged_list = list(staged_list) + [staged_list[-1]] * (padded - n)
        size = self.pipe.clip_cfg.vision.image_size
        imgs = preprocess_batch(np.stack(staged_list), size, device=self.pipe.device)
        return self.pipe.caption_images(imgs, use_beam=self.use_beam)[:n]
