"""Host -> device input pipeline for the port: data/pipeline.py's ImageTextLoader
(threaded decode, host shape unification, tokenisation, prefetch queue) with a
torch copy to an explicit device.

Data-parallel (`dp`, core/mesh.py), it takes the place of the JAX loader's
`shard_batch` of each global batch over the mesh (data/pipeline.py's
`_device_put`): every rank draws the same shuffled order from the same seed,
and decodes and tokenises only its own rows of each global batch, the
rank-th of `world` equal blocks of the batch's rows. Without `dp` it is rank 0
of a world of 1, which takes every row."""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from construction_clip_tpu_torch.data.pipeline import ImageTextLoader, host_shape_unify


class TorchImageTextLoader(ImageTextLoader):
    """Emits {"images": uint8 [B,H,W,3], "tokens": int32 [B,ctx]} on `device`
    (`dp.device` with `dp`), B this rank's rows. Towards a CUDA device each
    batch is pinned and copied without blocking, so the prefetch queue
    overlaps the copy of the next batch with the current step."""

    def __init__(self, dataset, tokenize, *, batch_size: int, device="cpu", dp=None,
                 **kwargs):
        super().__init__(dataset, tokenize, batch_size=batch_size, **kwargs)
        self.rank, self.world = (dp.rank, dp.world) if dp is not None else (0, 1)
        self.device = torch.device(dp.device if dp is not None else device)

    def _rows(self, idx) -> list[tuple[str, str]]:
        """(file, text) of every row of the global batch of items `idx`."""
        rows = []
        for i in idx:
            files, texts = self.dataset[i]
            if isinstance(files, str):
                files, texts = [files], [texts]
            rows.extend(zip(files, texts))
        return rows

    def _host_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        bs, rank, world = self.batch_size, self.rank, self.world
        ends = len(order) - (len(order) % bs if self.drop_last else 0)

        def load(row):
            return host_shape_unify(self.load_image(row[0]), self.image_size)

        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            for start in range(0, ends, bs):
                rows = self._rows(order[start: start + bs])
                if len(rows) % world:
                    raise ValueError(f"a batch of {len(rows)} rows does not split over "
                                     f"{world} ranks")
                n = len(rows) // world
                mine = rows[rank * n:(rank + 1) * n]
                yield {"images": np.stack(list(pool.map(load, mine))),
                       "tokens": self.tokenize([text for _, text in mine])}

    def _device_put(self, batch):
        out = {}
        for key, value in batch.items():
            t = torch.from_numpy(value)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=True)
        return out
