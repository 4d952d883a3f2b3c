"""Host side of the input pipeline (the port's copy of default_load_image,
host_shape_unify and ImageTextLoader from construction_clip_tpu/data/pipeline.py):
threaded image decode, host shape unification, tokenisation and a prefetch
queue. The copy to a device is data/loader.py's TorchImageTextLoader.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Callable, Sequence

import numpy as np


def default_load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def host_shape_unify(img: np.ndarray, size: int) -> np.ndarray:
    """Uniform [size,size,3] uint8 via short-side scale + center crop (nearest-neighbor
    host pass; the device bicubic does the real resample to model resolution)."""
    h, w = img.shape[:2]
    if (h, w) != (size, size):
        scale = size / min(h, w)
        nh, nw = max(size, int(round(h * scale))), max(size, int(round(w * scale)))
        ys = (np.arange(nh) * (h / nh)).astype(np.int32).clip(0, h - 1)
        xs = (np.arange(nw) * (w / nw)).astype(np.int32).clip(0, w - 1)
        # torchvision CenterCrop margin rounding (int(round(m/2)), not m//2)
        top, left = int(round((nh - size) / 2.0)), int(round((nw - size) / 2.0))
        # crop the index arrays, then gather: no [nh, nw] intermediate
        img = img[ys[top: top + size]][:, xs[left: left + size]]
    return img


class ImageTextLoader:
    """Batched loader for (file_names, texts) datasets: {"images": uint8
    [B,H,W,3], "tokens": int32 [B,ctx]}, with `prefetch_depth` batches handed to
    `_device_put` ahead of the one being consumed. Images are decoded by threads
    and unified to one shape on the host; the quality resize happens on the
    device. This class keeps the batches on the host (`_device_put` returns them
    as they are)."""

    def __init__(self, dataset, tokenize: Callable[[Sequence[str]], np.ndarray], *,
                 batch_size: int, image_size: int = 256,
                 load_image: Callable[[str], np.ndarray] = default_load_image,
                 shuffle: bool = True, seed: int = 567, drop_last: bool = True,
                 num_threads: int = 8, prefetch_depth: int = 2):
        self.dataset = dataset
        self.tokenize = tokenize
        self.batch_size = batch_size
        self.image_size = image_size
        self.load_image = load_image
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch_depth = prefetch_depth
        self._epoch = 0

    def _item(self, i: int):
        files, texts = self.dataset[i]
        if isinstance(files, str):
            files, texts = [files], [texts]
        imgs = np.stack([host_shape_unify(self.load_image(f), self.image_size)
                         for f in files])
        return imgs, list(texts)

    def _host_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        ends = len(order) - (len(order) % bs if self.drop_last else 0)
        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            for start in range(0, ends, bs):
                idx = order[start: start + bs]
                items = list(pool.map(self._item, idx))
                imgs = np.concatenate([im for im, _ in items], axis=0)
                texts = [t for _, ts in items for t in ts]
                yield {"images": imgs, "tokens": self.tokenize(texts)}

    def _device_put(self, batch):
        return batch

    def __iter__(self):
        queue = collections.deque()
        for host_batch in self._host_batches():
            queue.append(self._device_put(host_batch))  # the copy starts now
            if len(queue) > self.prefetch_depth:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        return n if self.drop_last else -(-len(self.dataset) // self.batch_size)
