"""The contrastive fine-tunes' samplers (the port's copies of PairGroupDataset
and CaptionPairDataset from construction_clip_tpu/data/datasets.py): index
logic only; image IO and preprocessing happen in the loader.

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
"""

from __future__ import annotations

import itertools

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
