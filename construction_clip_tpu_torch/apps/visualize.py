"""Training curves from metric JSONL logs (the port's counterpart of
apps/visualize.py): any scalar columns of the MetricLogger JSONL files
(train/metrics.py) plotted to a PNG.

    python -m construction_clip_tpu_torch.apps.visualize log/clipcap.jsonl --out curves.png

The flags are apps/visualize.py's. It runs on the host alone; matplotlib is
imported when it plots.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jsonl", nargs="+", help="metric JSONL file(s)")
    p.add_argument("--keys", nargs="+", default=["loss"])
    p.add_argument("--out", default="curves.png")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(args.keys), figsize=(6 * len(args.keys), 4),
                             squeeze=False)
    for path in args.jsonl:
        with open(path, encoding="utf-8") as f:
            records = [json.loads(line) for line in f]
        name = os.path.basename(path).replace(".jsonl", "")
        for i, key in enumerate(args.keys):
            pts = [(r["step"], r[key]) for r in records if key in r]
            if pts:
                xs, ys = zip(*pts)
                axes[0][i].plot(xs, ys, label=name)
    for i, key in enumerate(args.keys):
        axes[0][i].set_xlabel("step")
        axes[0][i].set_title(key)
        axes[0][i].legend()
        axes[0][i].grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
