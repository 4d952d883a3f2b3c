"""Annotation corpus schema + loader (the port's copy of
construction_clip_tpu/data/schema.py).

The corpus is COCO-ish JSON: {"type": ..., "annotations": [{id, caption_type,
violation_type, violation_list, caption, file_name, objects, report_file_name?}]}
produced by the ETL (reference image.py:439-452 `combine`; measured stats in
SURVEY.md §2b: all.json = 806 annotations).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

ANNOTATION_KEYS = ("id", "caption_type", "violation_type", "violation_list",
                   "caption", "file_name", "objects")


# optional keys emitted only by the PDF-report ETL (reference image.py:171-182)
OPTIONAL_KEYS = ("report_file_name", "type", "page", "original_caption")


@dataclasses.dataclass
class Annotation:
    id: int
    caption_type: str = ""
    violation_type: str = ""
    violation_list: str = ""
    caption: str = ""
    file_name: str = ""
    objects: str = ""
    report_file_name: Optional[str] = None
    type: Optional[str] = None
    page: Optional[int] = None
    original_caption: Optional[str] = None

    @staticmethod
    def from_dict(d: dict) -> "Annotation":
        return Annotation(**{k: v for k, v in d.items()
                             if k in ANNOTATION_KEYS + OPTIONAL_KEYS})

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in OPTIONAL_KEYS:
            if d[k] is None:
                d.pop(k)
        return d


def load_annotations(json_path: str) -> list[Annotation]:
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    return [Annotation.from_dict(a) for a in data["annotations"]]


def save_annotations(json_path: str, annotations: list[Annotation],
                     type_: str = "captions") -> None:
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump({"type": type_, "annotations": [a.to_dict() for a in annotations]},
                  f, indent=2, ensure_ascii=False)
