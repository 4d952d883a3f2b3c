"""Host -> device input pipeline for the port: the JAX package's ImageTextLoader
(threaded decode, host shape unification, tokenisation, prefetch queue) with its
device transfer replaced by a torch copy to an explicit device."""

from __future__ import annotations

import torch

from construction_clip_tpu.data.pipeline import ImageTextLoader


class TorchImageTextLoader(ImageTextLoader):
    """Emits {"images": uint8 [B,H,W,3], "tokens": int32 [B,ctx]} on `device`.
    Towards a CUDA device each batch is pinned and copied without blocking, so
    the prefetch queue overlaps the copy of the next batch with the current step."""

    def __init__(self, dataset, tokenize, *, batch_size: int, device="cpu", **kwargs):
        super().__init__(dataset, tokenize, batch_size=batch_size, mesh=None, **kwargs)
        self.device = torch.device(device)

    def _device_put(self, batch):
        out = {}
        for key, value in batch.items():
            t = torch.from_numpy(value)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=True)
        return out
