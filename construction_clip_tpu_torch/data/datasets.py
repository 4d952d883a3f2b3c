"""The port's copy of construction_clip_tpu/data/datasets.py: index logic
only; image IO and preprocessing happen in the loader.

PairGroupDataset — reference ClipPairDataset (CLIP/train.py:36-99): keep
annotations with a non-empty label `key`, group by label value, enumerate
combinations(label_values, combination_num); an item yields ONE annotation per
class in its combination (round-robin within the class via item % len(group)) —
a class-balanced N-way batch. Per-class 80/20 train/test split by ORDER (not
shuffled, train_c = int(count * ratio), CLIP/train.py:77,84-85). The reference
hardcodes 50 items per combination regardless of class sizes — reproduced as the
default `items_per_combination=50`.

CaptionPairDataset — reference CLIP/train_caption.py: plain (image, text)
pairs of the annotations with a non-empty `key`, the first train_ratio of
them (in order) for train and the rest for test.

FlickrDataset, CocoCaptionDataset, PrecomputedCaptionDataset and
OriginalClipCapDataset — the captioners' datasets, below.
"""

from __future__ import annotations

import itertools
import os

from construction_clip_tpu_torch.data.schema import Annotation, load_annotations


class PairGroupDataset:
    def __init__(self, json_path: str, *, key: str = "violation_type",
                 split: str = "train", train_ratio: float = 0.8,
                 combination_num: int = 9, items_per_combination: int = 50):
        anns = [a for a in load_annotations(json_path) if getattr(a, key) != ""]
        self.key = key
        values: list[str] = []
        for a in anns:  # insertion-ordered unique label values (Counter order)
            v = getattr(a, key)
            if v not in values:
                values.append(v)
        counts = {v: sum(1 for a in anns if getattr(a, key) == v) for v in values}
        self.combinations = list(itertools.combinations(values, combination_num))
        train_c = {v: int(c * train_ratio) for v, c in counts.items()}

        self.groups: list[dict[str, list[Annotation]]] = []
        for combo in self.combinations:
            full = {v: [a for a in anns if getattr(a, key) == v] for v in combo}
            if split == "train":
                self.groups.append({v: lst[: train_c[v]] for v, lst in full.items()})
            else:
                self.groups.append({v: lst[train_c[v]:] for v, lst in full.items()})
        self.items_per_combination = items_per_combination

    def __len__(self) -> int:
        return self.items_per_combination * len(self.groups)

    def __getitem__(self, item: int):
        """-> (file_names [n_way], texts [n_way]) — one per class."""
        group = self.groups[item // self.items_per_combination]
        idx = item % self.items_per_combination
        files, texts = [], []
        for v, lst in group.items():
            a = lst[idx % len(lst)]
            files.append(a.file_name)
            texts.append(getattr(a, self.key))
        return files, texts


class CaptionPairDataset:
    def __init__(self, json_path: str, *, key: str = "violation_list",
                 split: str = "train", train_ratio: float = 0.8):
        anns = [a for a in load_annotations(json_path) if getattr(a, key) != ""]
        cut = int(len(anns) * train_ratio)
        self.anns = anns[:cut] if split == "train" else anns[cut:]
        self.key = key

    def __len__(self) -> int:
        return len(self.anns)

    def __getitem__(self, item: int):
        """-> (file_name, text)"""
        a = self.anns[item]
        return a.file_name, getattr(a, self.key)


class FlickrDataset:
    """Flickr8k-style CSV (image,caption) dataset — reference
    attention_model/dataset.py:88-125 (pandas captions.txt); index logic only."""

    def __init__(self, csv_path: str, *, image_dir: str = ""):
        import csv as _csv

        self.items: list[tuple[str, str]] = []
        with open(csv_path, encoding="utf-8") as f:
            reader = _csv.reader(f)
            header = next(reader)
            for row in reader:
                if len(row) >= 2:
                    self.items.append((os.path.join(image_dir, row[0]), row[1]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class CocoCaptionDataset:
    """COCO captions JSON ({"images": [...], "annotations": [{image_id, caption}]})
    — reference attention_model/dataset.py:50-85 (pycocotools); stdlib json here."""

    def __init__(self, json_path: str, *, image_dir: str = ""):
        import json as _json

        with open(json_path, encoding="utf-8") as f:
            data = _json.load(f)
        id_to_file = {im["id"]: im["file_name"] for im in data.get("images", [])}
        self.items = [(os.path.join(image_dir, id_to_file[a["image_id"]]), a["caption"])
                      for a in data["annotations"] if a.get("image_id") in id_to_file]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class PrecomputedCaptionDataset:
    """ClipCap training items from a precomputed-embedding archive
    (infer/precompute.py, the parse_coco.py equivalent): (clip_embed, attribute
    tokens, caption tokens). Pure numpy indexing."""

    def __init__(self, embeddings, captions_tokens, attribute_tokens):
        assert len(embeddings) == len(captions_tokens) == len(attribute_tokens)
        self.embeddings = embeddings
        self.captions_tokens = captions_tokens
        self.attribute_tokens = attribute_tokens

    def __len__(self):
        return len(self.embeddings)

    def __getitem__(self, i):
        return self.embeddings[i], self.attribute_tokens[i], self.captions_tokens[i]


class OriginalClipCapDataset:
    """The upstream-ClipCap dataset variant used by the embedding-export entry
    point (reference CLIP_prefix_caption/export_prediction.py:40-97) — distinct
    from the training dataset's quirk in two deliberate ways:

      * pad value is -1 and the mask comes from tokens.ge(0) BEFORE clamping the
        pad to 0, so the mask is MEANINGFUL (the training dataset pads with 0
        first and its ge(0) mask is all-ones — reference train.py:50-53);
      * tokenized captions are cached to `<data>_tokens.pkl`
        (export_prediction.py:82-95) and max_seq_len is recomputed from the
        CURRENT token lengths after any cache load:
        min(int(mean + 10*std), max) (export_prediction.py:96-97).

    encode: callable str -> list[int] (the GPT-2 tokenizer's encode).
    """

    def __init__(self, embeddings, captions, encode, prefix_length: int,
                 cache_path: str | None = None, normalize_prefix: bool = False):
        import pickle

        import numpy as np

        self.prefix_length = prefix_length
        self.normalize_prefix = normalize_prefix
        self.embeddings = embeddings
        if cache_path is not None and os.path.isfile(cache_path):
            with open(cache_path, "rb") as f:
                self.captions_tokens, self.caption2embedding, _ = pickle.load(f)
        else:
            self.captions_tokens = [np.asarray(encode(c), dtype=np.int64)
                                    for c in captions]
            self.caption2embedding = list(range(len(captions)))
            if cache_path is not None:
                max_len = max((len(t) for t in self.captions_tokens), default=0)
                with open(cache_path, "wb") as f:
                    pickle.dump([self.captions_tokens, self.caption2embedding,
                                 max_len], f)
        lens = np.asarray([len(t) for t in self.captions_tokens], dtype=np.float64)
        # torch.std is the sample std (ddof=1); empty/singleton guards for tests
        std = float(lens.std(ddof=1)) if len(lens) > 1 else 0.0
        self.max_seq_len = min(int(lens.mean() + std * 10), int(lens.max())) \
            if len(lens) else 0

    def __len__(self):
        return len(self.captions_tokens)

    def pad_tokens(self, item: int):
        """-1 pad / truncate to max_seq_len; mask = ge(0) with prefix ones
        prepended; pad positions clamped to 0 AFTER the mask is taken
        (export_prediction.py:46-59). The reference's in-place tensor mutation
        means a SECOND call on the same item sees the clamped row and returns an
        all-ones mask — that quirk is reproduced deliberately (store-after-clamp
        below)."""
        import numpy as np

        tokens = self.captions_tokens[item]
        padding = self.max_seq_len - tokens.shape[0]
        if padding > 0:
            tokens = np.concatenate(
                [tokens, np.zeros(padding, dtype=np.int64) - 1])
            self.captions_tokens[item] = tokens
        elif padding < 0:
            tokens = tokens[:self.max_seq_len]
            self.captions_tokens[item] = tokens
        mask = tokens >= 0
        tokens = np.where(mask, tokens, 0)
        self.captions_tokens[item] = tokens
        mask = np.concatenate(
            [np.ones(self.prefix_length, dtype=np.float32),
             mask.astype(np.float32)])
        return tokens, mask

    def __getitem__(self, item: int):
        import numpy as np

        tokens, mask = self.pad_tokens(item)
        prefix = np.asarray(self.embeddings[self.caption2embedding[item]])
        if self.normalize_prefix:
            prefix = prefix.astype(np.float32)
            prefix = prefix / np.linalg.norm(prefix, ord=2, axis=-1, keepdims=True)
        return tokens, mask, prefix
