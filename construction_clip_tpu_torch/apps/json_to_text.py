"""Caption text dump for tokenizer training (the port's host copy of
apps/json_to_text.py, the CLIP_prefix_caption/json_to_text.py entry point):
one line per annotation of a corpus JSON, its --key field or else its
violation_list, empty ones skipped.

    python -m construction_clip_tpu_torch.apps.json_to_text --json_path all.json \\
        --out text.txt

It runs on the host alone (no device).
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="../fengyu/0_all.json")
    p.add_argument("--out", default="text.txt")
    p.add_argument("--key", default="caption")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with open(args.json_path, encoding="utf-8") as f:
        data = json.load(f)
    n = 0
    with open(args.out, "w", encoding="utf-8") as f:
        for a in data["annotations"]:
            text = a.get(args.key) or a.get("violation_list") or ""
            if text:
                f.write(text + "\n")
                n += 1
    print(f"wrote {args.out}: {n} lines")


if __name__ == "__main__":
    main()
