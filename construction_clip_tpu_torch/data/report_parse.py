"""The port's copy of construction_clip_tpu/data/report_parse.py (host code, no
tensors), held equal to it by tests/test_torch_etl.py.

Safety-report PDF parsing logic — the pure-string core of the reference's
`convert_report` (reference image.py:21-194) and `safety_report` (reference
corpus.py:50-120), separated from PDF I/O so it is unit-testable without the
proprietary report files (PyMuPDF only enters in the readers in etl.py/corpus.py).

The reports come in four layouts, detected from marker strings anywhere in the
document (reference image.py:46-67):

  A '公司內部文件'  caption after the last 查核項目： header, newlines -> '，'
  B '工程說明'      caption after the last '.'
  C '缺失1'         caption between 說明： and the 缺失/提醒/改善照片與說明 footers
  D '工地現況'      like C, then split on 。 and indexed by the image position
  E (none)          unparseable; produces nothing

caption_type comes from violation keywords in the RAW page text: 缺失改善 for
layouts A/B, 缺失 for D (image.py:86-110). Layout C never assigns it — the
reference reuses whatever the previous page set (a genuine quirk: a corpus whose
first parsed report is type C crashes there with NameError). We reproduce the
sticky behavior with an explicit initial value instead of a crash.
"""

from __future__ import annotations

import os

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

VIOLATION = "violation"
STATUS = "status"

# marker -> layout, scanned in this order per page (reference image.py:50-65)
REPORT_TYPE_MARKERS = (
    ("公司內部文件", "A"),
    ("工程說明", "B"),
    ("缺失1", "C"),
    ("工地現況", "D"),
)

# a parsed caption containing any of these aborts the page (reference image.py:126-128)
PAGE_SKIP_WORDS = ("工地名稱", "、安衛", "廠商當月", "豐譽企業團隊", "今日")


@dataclasses.dataclass
class ReportImage:
    """One embedded image: extension + (optionally) its decoded bytes."""
    ext: str = "jpeg"
    data: Optional[bytes] = None


@dataclasses.dataclass
class ReportPage:
    """One PDF page as the parser sees it: its text layer + embedded images."""
    text: str
    images: Sequence[ReportImage] = ()


def detect_report_type(page_texts: Iterable[str]) -> str:
    """Scan pages in order; the first marker hit decides the layout, 'E' if none
    (reference image.py:46-67)."""
    rtype = "E"
    for content in page_texts:
        for marker, t in REPORT_TYPE_MARKERS:
            if marker in content:
                return t
    return rtype


def project_name_from_filename(file_name: str) -> str:
    """'20200921-邱董至大埔美榮勝廠房-品質及勞安查核報告.pdf' -> '大埔美榮勝廠房'
    (reference image.py:42)."""
    parts = file_name.strip().split("-")
    if len(parts) < 2:
        # reference image.py:42 assumes '<proj>-<period>-<name>.pdf' and would
        # IndexError here; a misnamed file degrades to its stem instead of
        # killing a whole-directory ETL walk
        return os.path.splitext(file_name.strip())[0]
    return parts[-2].split("至")[-1].strip()


def parse_report_caption(page_text: str, rtype: str, image_index: int,
                         ) -> Tuple[str, Optional[str]]:
    """(caption, caption_type) for one image on one page; caption_type is None for
    layout C (sticky — caller keeps the previous value, reference image.py:101-103).

    Transform chains are byte-for-byte the reference's (image.py:84-120), including
    the trailing-character drops (`[:-1]` eats the final newline of the text layer).
    """
    caption = page_text
    if rtype == "A":
        caption_type: Optional[str] = VIOLATION if "缺失改善" in caption else STATUS
        caption = caption.split("查核項目：")[-1][:-1].strip().replace("\n", "，")
        caption = caption.split("缺失改善，")[-1]
    elif rtype == "B":
        caption_type = VIOLATION if "缺失改善" in caption else STATUS
        caption = caption.split(".")[-1][:-1].strip().replace("\n", "")
    elif rtype == "C":
        caption_type = None
        caption = (caption.split("改善照片與說明")[0].split("缺失")[0]
                   .split("提醒")[0].split("說明：")[-1].replace("\n", ""))
    elif rtype == "D":
        caption_type = VIOLATION if "缺失" in caption else STATUS
        caption = (caption.split("改善照片與說明")[0].split("缺失")[0]
                   .split("提醒")[0].split("說明：")[-1].replace("\n", ""))
        parts = caption.split("工地現況")[-1].replace("\n", "").split("。")
        parts.insert(0, "0")
        try:
            caption = parts[image_index - 1] if parts[image_index - 1] != "" else parts[1]
        except IndexError:
            caption = parts[1]
    else:
        raise ValueError(f"unparseable report type {rtype!r}")
    return caption, caption_type


def parse_report(file_name: str, pages: Sequence[ReportPage], *,
                 start_id: int = 0, initial_caption_type: str = VIOLATION,
                 image_dir_rel: str = "fengyu/report_output",
                 ) -> Tuple[List[dict], List[Tuple[str, Optional[bytes]]], int, str]:
    """Full per-report semantics (reference image.py:37-189).

    Returns (annotations, images_to_save, next_id, final_caption_type — the
    sticky value layout C carries across files). Pages are walked from the
    SECOND page (:74); within a page, the first image is never emitted (:187 —
    it is the report template's logo/header graphic) but it still consumes an id
    (the id counter `j` increments before the append gate, so emitted ids have
    gaps exactly like the reference's). A skip-word or empty caption aborts the
    rest of the page (:126-131).
    """
    rtype = detect_report_type(p.text for p in pages)
    project = project_name_from_filename(file_name)
    annotations: List[dict] = []
    to_save: List[Tuple[str, Optional[bytes]]] = []
    j = start_id
    caption_type = initial_caption_type
    if rtype == "E":
        return annotations, to_save, j, caption_type
    for page_index in range(1, len(pages)):
        page = pages[page_index]
        for image_index, img in enumerate(page.images, start=1):
            caption, ct = parse_report_caption(page.text, rtype, image_index)
            if ct is not None:
                caption_type = ct
            original_caption = caption
            if any(word in caption for word in PAGE_SKIP_WORDS):
                break
            if caption == "":
                break
            image_name = (f"{file_name[:8]}_{project}_{page_index + 1}_"
                          f"{image_index}.{img.ext}")
            annotation = {
                "id": j + 1,
                "type": rtype,
                "report_file_name": file_name,
                "page": page_index + 1,
                "caption_type": caption_type,
                "violation_type": "",
                "violation_list": "",
                "original_caption": original_caption,
                "caption": caption,
                "file_name": f"{image_dir_rel}/{image_name}",
            }
            j += 1
            if image_index != 1:
                annotations.append(annotation)
                to_save.append((image_name, img.data))
    return annotations, to_save, j, caption_type


def report_corpus_captions(pages: Sequence[ReportPage]) -> List[str]:
    """Caption text for the tokenizer corpus — reference corpus.py:83-119: every
    image on pages 2+ contributes its parsed caption (no caption_type, no first-
    image skip, no skip-word filter). Layout D runs its full chain here too —
    工地現況 split + insert('0') + image-index selection (reference
    corpus.py:104-117), same as the annotation path."""
    rtype = detect_report_type(p.text for p in pages)
    out: List[str] = []
    if rtype == "E":
        return out
    for page_index in range(1, len(pages)):
        page = pages[page_index]
        for image_index, _ in enumerate(page.images, start=1):
            caption, _ct = parse_report_caption(page.text, rtype, image_index)
            out.append(caption)
    return out


def regulation_text_lines(page_texts: Iterable[str]) -> List[str]:
    """Regulation-PDF text per page (reference corpus.py:122-141): newlines
    stripped, page split on 、, the LAST character of each segment dropped (the
    reference's way of eating the enumeration particle), segments concatenated."""
    lines = []
    for text in page_texts:
        content = text.replace("\n", "").split("、")
        lines.append("".join(c[:-1] for c in content))
    return lines
