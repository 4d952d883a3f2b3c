"""The construction-safety label taxonomy (the port's copy of
construction_clip_tpu/data/labels.py; tests/test_torch_host.py holds the two
equal).

The reference duplicates these literals in four files (reference predict.py:20-23,
application.py:276-279, CLIP_prefix_caption/parse_coco.py:24-28, test.py:47-48); here
they live once.

caption_type prompts map class names to zero-shot prompt strings: the reference
classifies caption_type with prompts ['現況', '缺失'] and maps to {'status','violation'}.
"""

from __future__ import annotations

# zero-shot prompt -> canonical caption_type value
CAPTION_TYPE_PROMPTS = ("現況", "缺失")
CAPTION_TYPES = ("status", "violation")

# the 9 hazard classes (zh prompts are the class names themselves)
VIOLATION_TYPES = ("墜落", "機械", "物料", "感電", "防護具", "穿刺", "爆炸", "工作場所", "搬運")

VIOLATION_TYPES_EN = (
    "fall", "machinery", "material", "electrocution", "ppe",
    "puncture", "explosion", "workplace", "transport",
)

# attribute string fed to the captioner: zh caption_type word + violation_type word
# (reference parse_coco.py:56 builds f"{caption_type} {violation_type} ")
def attribute_string(caption_type_zh: str, violation_type: str) -> str:
    return f"{caption_type_zh} {violation_type} "


# Faster R-CNN object-detector classes used by the serving path
# (reference application.py labels.json contract; 7 classes + background)
DETECTOR_CLASSES = ("背景", "安全帽", "安全帶", "開口", "鋼筋", "模板", "施工架", "人員")
