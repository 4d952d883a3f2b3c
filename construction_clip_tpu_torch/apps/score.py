"""Caption metric scoring (the port's counterpart of apps/score.py, the
CLIP_prefix_caption/score.py entry point): char-level BLEU and ROUGE-1/2/L
over the output_log.json that `predict` writes, printed as JSON.

    python -m construction_clip_tpu_torch.apps.score output/output_log.json

The flags and the printed JSON are apps/score.py's. It runs on the host alone.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("log_json", help="output_log.json from apps/predict.py")
    p.add_argument("--ref_key", default="ground_truth_caption")
    p.add_argument("--hyp_key", default="caption")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch.infer.score import score_pairs

    with open(args.log_json, encoding="utf-8") as f:
        records = json.load(f)
    pairs = [(r[args.ref_key], r[args.hyp_key]) for r in records
             if r.get(args.ref_key) and r.get(args.hyp_key) is not None]
    print(json.dumps(score_pairs(pairs), ensure_ascii=False, indent=2))


if __name__ == "__main__":
    main()
