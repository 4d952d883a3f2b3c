#!/usr/bin/env python3
"""One phase of chip_smoke.py from two checkouts in turns on one card: A, B, B,
A, each run in a process of its own, so that both meet the same card and host.

    python3 chip_ab.py serve   path/to/checkout_a path/to/checkout_b
    python3 chip_ab.py train   path/to/checkout_a path/to/checkout_b
    python3 chip_ab.py kernels path/to/checkout_a path/to/checkout_b

serve: phase 5 (ViT-B/32 + GPT-2 12x768 beam 3 in bf16 through
TorchPredictService, 10 requests from 4 threads). train: phase 9 (ViT-B/32
contrastive training, bf16, B=36, 10 steps; its median step). kernels: the
device time (CUDA-graph replay, chip_smoke.graph_ms) and wrapper time of K2
at R=24 and R=3 (H=12, Dh=64, cache_len 139, beam ancestry, bf16) and of K3
at [36,50,768] H=12 bf16, on inputs drawn from one numpy seed in both trees.

Each checkout builds its own kernels. Prints each run's JSON lines with the
checkout they came from, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PRELUDE = r"""
import sys, tempfile
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
cs.phase_device()
"""

RUNS = {
    "serve": (("serve",), r"""
with tempfile.TemporaryDirectory() as tmp:
    clip_tok, lm_tok = cs.tokenizers(tmp)
cfgs = (cs.CLIPConfig.vit_b_32(), cs.GPT2Config(), cs.ClipCapConfig())
cs.phase_serve(cs.convert.init_clip(0, cfgs[0]), cs.convert.init_clipcap(1, cfgs[2], cfgs[1]),
               cfgs, clip_tok, lm_tok, "cuda")
"""),
    "train": (("train_vit_b_32",), r"""
with tempfile.TemporaryDirectory() as tmp:
    clip_tok, _ = cs.tokenizers(tmp)
cfg = cs.CLIPConfig.vit_b_32()
batch = cs.class_balanced_batch(cfg, clip_tok, 4, 9, "cuda")
cs.phase_train("vit_b_32", cfg, cs.convert.init_clip(0, cfg), batch, 10, "cuda")
"""),
    "kernels": (("ab_k2", "ab_k3"), r"""
cs.phase_build()
rng = np.random.default_rng(2)
for rows in (24, 3):
    shape = (12, rows, 12, 140, 64)
    ck, cv = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()
              for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((rows, 12, 64)).astype(np.float32)).cuda().bfloat16()
    anc = torch.from_numpy(rng.integers(0, rows, (rows, 140), dtype=np.int32)).cuda()

    def k2():
        return cs.decode_step_attention(q, ck, cv, 11, 139, anc)

    cs.say("ab_k2", rows=rows, cache_len=139, device_ms=cs.graph_ms(k2), ms=cs.median_ms(k2))
x, ln, attn = cs._block_inputs(rng, 36, 50, 768, torch.bfloat16, "cuda")
g = torch.from_numpy(rng.standard_normal((36, 50, 768)).astype(np.float32)).cuda().bfloat16()
args = (ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"])

def k3():
    return cs.fused_attention_block_bwd(x, g, *args, n_heads=12, causal=False)

cs.say("ab_k3", shape=[36, 50, 768], device_ms=cs.graph_ms(k3), ms=cs.median_ms(k3, 11, 3))
"""),
}


def main() -> None:
    phase = sys.argv[1]
    keep, body = RUNS[phase]
    a, b = (os.path.abspath(p) for p in sys.argv[2:4])
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, "-c", PRELUDE + body, root], cwd=root,
                             capture_output=True, text=True, check=True, timeout=900).stdout
        for line in out.splitlines():
            if line.startswith("{") and json.loads(line).get("phase") in keep:
                print(json.dumps({"checkout": root, **json.loads(line)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
