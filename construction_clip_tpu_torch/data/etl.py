"""The port's copy of construction_clip_tpu/data/etl.py (host code, no
tensors), held equal to it by tests/test_torch_etl.py.

Corpus ETL: folders / DOCX / PDF reports -> COCO-ish annotation JSON.

Port of the reference's dataset converters (reference image.py), parameterized instead
of hardcoded, with the PDF/DOCX extractors gated on their optional deps (PyMuPDF /
docx2txt are not in this image):

  convert_folder_month      image.py:196-229  — fengyu monthly folders
                            ('{y}年{m:02}月照片'), filename stem as caption,
                            caption_type 'violation'.
  convert_folder_other      image.py:231-255  — unlabeled folder, empty captions.
  convert_folder_labeled    image.py:257-309  — reju: label from the folder path
                            (合格->status / 不合格->violation; 開口/施工架 -> 墜落,
                            安全帽 -> 防護具; objects = the folder noun).
  convert_docx              image.py:311-371  — DOCX text+images (gated on docx2txt).
  convert_pdf_report        image.py:21-194   — PDF reports, 4 layout formats A-D,
                            caption_type from 缺失 keywords; parsing logic lives in
                            data/report_parse.py (pure, tested on synthetic pages),
                            only the PDF reading needs fitz/PyMuPDF.
  image_name_correction     image.py:374-391  — 2022-report filename renumbering.
  count / add_key / add_path / combine  image.py:394-452.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Sequence

from construction_clip_tpu_torch.data.schema import Annotation, load_annotations, save_annotations

# folder noun -> (violation_type, objects) — reference image.py:280-291
LABELED_FOLDER_MAP = {
    "開口": ("墜落", "開口"),
    "施工架": ("墜落", "施工架"),
    "安全帽": ("防護具", "安全帽"),
    "其他": ("", ""),
}
# keywords that mark a caption as a violation (reference image.py:86-110 uses 缺失
# section headers in the reports)
VIOLATION_KEYWORDS = ("缺失", "未", "不合格", "違規")


def _list_images(folder: str) -> list[str]:
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tif", ".tiff")
    try:
        return [f for f in sorted(os.listdir(folder))
                if f.lower().endswith(exts) or "." in f]
    except OSError:
        return []


def convert_folder_month(root: str, *, years: Sequence[int] = (2021, 2022),
                         out_path: Optional[str] = None) -> list[Annotation]:
    """Monthly photo folders, filename stem as the caption (image.py:196-229)."""
    anns: list[Annotation] = []
    i = 0
    for y in years:
        for m in range(1, 13):
            folder = os.path.join(root, f"{y}年{m:02}月照片")
            for file_name in _list_images(folder):
                anns.append(Annotation(
                    id=i, caption_type="violation", violation_type="",
                    violation_list="", caption=file_name.split(".")[0],
                    file_name=os.path.join(folder, file_name), objects=""))
                i += 1
    if out_path:
        save_annotations(out_path, anns)
    return anns


def convert_folder_other(root: str, *, folders: Sequence[str] = ("其他",),
                         out_path: Optional[str] = None) -> list[Annotation]:
    """Unlabeled folders, empty captions (image.py:231-255)."""
    anns: list[Annotation] = []
    i = 0
    for folder in folders:
        for file_name in _list_images(os.path.join(root, folder)):
            anns.append(Annotation(
                id=i, caption_type="violation", violation_type="",
                violation_list="", caption="",
                file_name=os.path.join(folder, file_name), objects=""))
            i += 1
    if out_path:
        save_annotations(out_path, anns)
    return anns


def convert_folder_labeled(root: str, *,
                           statuses: Sequence[str] = ("合格", "不合格"),
                           categories: Sequence[str] = ("開口", "施工架", "安全帽", "其他"),
                           out_path: Optional[str] = None) -> list[Annotation]:
    """reju layout: labels derived from {status}/{category} folder structure
    (image.py:257-309)."""
    anns: list[Annotation] = []
    i = 0
    for status in statuses:
        for cat in categories:
            folder = os.path.join(root, status, cat)
            caption_type = "status" if status == "合格" else "violation"
            violation_type, objects = LABELED_FOLDER_MAP.get(cat, ("", ""))
            for file_name in _list_images(folder):
                anns.append(Annotation(
                    id=i, caption_type=caption_type, violation_type=violation_type,
                    violation_list="", caption="",
                    file_name=os.path.join(folder, file_name), objects=objects))
                i += 1
    if out_path:
        save_annotations(out_path, anns)
    return anns


def caption_type_from_text(text: str) -> str:
    """'violation' when the caption carries a violation keyword (image.py:86-110)."""
    return "violation" if any(k in text for k in VIOLATION_KEYWORDS) else "status"


def convert_docx(root: str, *, output_folder: str = "output_doc",
                 out_path: Optional[str] = None) -> list[Annotation]:
    """DOCX reports: extract text + images, pair captions with extracted images
    (image.py:311-371). Requires docx2txt (gated)."""
    try:
        import docx2txt
    except ImportError as e:
        raise ImportError("convert_docx requires docx2txt (not in this image); "
                          "use the folder converters or pre-extracted JSON") from e

    anns: list[Annotation] = []
    i = 0
    img_dir = os.path.join(root, output_folder)
    os.makedirs(img_dir, exist_ok=True)
    for file_name in sorted(os.listdir(root)):
        if not file_name.endswith("docx") or file_name.startswith("~$"):
            continue
        date = file_name[6:12]
        text = docx2txt.process(os.path.join(root, file_name), img_dir)
        lines = [l for l in text.replace("\n\n\n", "").split("\n")[3:]
                 if l not in ("缺失說明", "照片", "")]
        for j, caption in enumerate(lines):
            anns.append(Annotation(
                id=i, report_file_name=file_name,
                caption_type=caption_type_from_text(caption),
                violation_type="", violation_list=caption, caption=caption,
                file_name=f"{os.path.basename(root)}/{output_folder}/{date}_{j + 1}.jpg",
                objects=""))
            i += 1
    if out_path:
        save_annotations(out_path, anns)
    return anns


def load_report_pages(pdf_path: str, *, with_images: bool = True):
    """Open one report PDF into the parser's page model (requires PyMuPDF).

    with_images=False skips decoding the embedded photo bytes and stores only
    placeholders with the right COUNT — the corpus collectors need captions per
    image index, not pixels, and a report's photos can dwarf its text."""
    try:
        import fitz
    except ImportError as e:
        raise ImportError("reading report PDFs requires PyMuPDF (fitz), not in "
                          "this image; drive report_parse.parse_report with "
                          "pre-extracted page text instead") from e
    from construction_clip_tpu_torch.data.report_parse import ReportImage, ReportPage

    pdf = fitz.open(pdf_path)
    pages = []
    for page in pdf:
        images = []
        for img in page.get_images():
            if with_images:
                base = pdf.extract_image(img[0])
                images.append(ReportImage(ext=base["ext"], data=base["image"]))
            else:
                images.append(ReportImage(ext="", data=b""))
        pages.append(ReportPage(text=page.get_text("text"), images=images))
    return pages


def convert_pdf_report(report_dir: str, *, output_dir: Optional[str] = None,
                       out_path: Optional[str] = None) -> list[Annotation]:
    """PDF safety reports -> annotations (reference image.py:21-194).

    Walks `report_dir` for .pdf files, detects each report's layout (A-D),
    parses captions/caption_type per the layout rules (see
    data/report_parse.py — that module holds the tested parsing logic), writes
    the embedded photos to `output_dir` and the annotation JSON to `out_path`.
    """
    from construction_clip_tpu_torch.data.report_parse import parse_report

    anns: list[Annotation] = []
    next_id = 0
    caption_type = "violation"
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    for file_name in sorted(os.listdir(report_dir)):
        if not file_name.endswith("pdf"):
            continue
        pages = load_report_pages(os.path.join(report_dir, file_name))
        # layout C inherits the running caption_type across pages and files
        raw, to_save, next_id, caption_type = parse_report(
            file_name, pages, start_id=next_id,
            initial_caption_type=caption_type,
            image_dir_rel=output_dir or "report_output")
        anns.extend(Annotation.from_dict(a) for a in raw)
        if output_dir:
            for image_name, data in to_save:
                if data is not None:
                    with open(os.path.join(output_dir, image_name), "wb") as f:
                        f.write(data)
    if out_path:
        save_annotations(out_path, anns)
    return anns


def image_name_correction(json_path: str) -> None:
    """Renumber 2022-report image names '{month}_{idx}.{ext}' -> idx-1
    (image.py:374-391)."""
    anns = load_annotations(json_path)
    for a in anns:
        if a.report_file_name and "2022" in a.report_file_name:
            stem, ext = a.file_name.rsplit(".", 1)
            parts = stem.split("_")
            a.file_name = f"{parts[0]}_{int(parts[-1]) - 1}.{ext}"
    save_annotations(json_path, anns)


def count(json_path: str) -> dict:
    """Corpus stats (image.py:394-416)."""
    anns = load_annotations(json_path)
    stats = {
        "total": len(anns),
        "caption_type": {
            "violation": sum(a.caption_type == "violation" for a in anns),
            "status": sum(a.caption_type == "status" for a in anns),
        },
        "violation_type": sum(a.violation_type != "" for a in anns),
        "violation_list": sum(a.violation_list != "" for a in anns),
        "caption": sum(a.caption != "" for a in anns),
    }
    return stats


def add_key(json_path: str, key: str = "objects", value: str = "") -> None:
    anns = load_annotations(json_path)
    for a in anns:
        setattr(a, key, value)
    save_annotations(json_path, anns)


def add_path(json_path: str, prefix: str) -> None:
    anns = load_annotations(json_path)
    for a in anns:
        a.file_name = prefix + a.file_name
    save_annotations(json_path, anns)


def combine(path_list: Iterable[str], out_path: str) -> int:
    """Union of sub-corpora -> all.json (image.py:439-452; ids kept as-is, like the
    reference)."""
    merged: list[Annotation] = []
    for path in path_list:
        merged.extend(load_annotations(path))
    save_annotations(out_path, merged)
    return len(merged)
