"""Host -> device input pipeline for the port: data/pipeline.py's ImageTextLoader
(threaded decode, host shape unification, tokenisation, prefetch queue) with a
torch copy to an explicit device."""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.data.pipeline import ImageTextLoader


class TorchImageTextLoader(ImageTextLoader):
    """Emits {"images": uint8 [B,H,W,3], "tokens": int32 [B,ctx]} on `device`.
    Towards a CUDA device each batch is pinned and copied without blocking, so
    the prefetch queue overlaps the copy of the next batch with the current step."""

    def __init__(self, dataset, tokenize, *, batch_size: int, device="cpu", **kwargs):
        super().__init__(dataset, tokenize, batch_size=batch_size, **kwargs)
        self.device = torch.device(device)

    def _device_put(self, batch):
        out = {}
        for key, value in batch.items():
            t = torch.from_numpy(value)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=True)
        return out
