#!/usr/bin/env python3
"""The serving phase of chip_smoke.py (phase 5: ViT-B/32 + GPT-2 12x768 beam 3
in bf16 through TorchPredictService, 10 requests from 4 threads) from two
checkouts in turns on one card: A, B, B, A, each run in a process of its own.

    python3 chip_ab_serve.py path/to/checkout_a path/to/checkout_b

Each checkout builds its own kernels. Prints each run's JSON line with the
checkout it came from, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = r"""
import sys, tempfile
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
cs.phase_device()
with tempfile.TemporaryDirectory() as tmp:
    clip_tok, lm_tok = cs.tokenizers(tmp)
cfgs = (cs.CLIPConfig.vit_b_32(), cs.GPT2Config(), cs.ClipCapConfig())
cs.phase_serve(cs.convert.init_clip(0, cfgs[0]), cs.convert.init_clipcap(1, cfgs[2], cfgs[1]),
               cfgs, clip_tok, lm_tok, "cuda")
"""


def main() -> None:
    a, b = (os.path.abspath(p) for p in sys.argv[1:3])
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, "-c", RUN, root], cwd=root, capture_output=True,
                             text=True, check=True, timeout=900).stdout
        for line in out.splitlines():
            if line.startswith('{"phase": "serve"'):
                print(json.dumps({"checkout": root, **json.loads(line)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
