"""The hand kernels' calls that one batch or step of a CLIP cell makes, from
its configuration and traffic: the plan the CLIP loops hand to the roofline
readers (work/calls.py).

A tower's block takes the fused block, K1 forward and K3 backward, at T <=
FUSED_MAX_T, and composed projections around flash attention, K4 forward and
K5 backward, above it (the program's models/blocks.py route, frozen here as
the yardstick's assumption).
"""

from __future__ import annotations

from peaks import BYTES

FUSED_MAX_T = 256


def plan(cfg: dict, traffic: dict, towers: tuple, backward: bool) -> list:
    """[(function, args, calls a unit)] with args as work/<function>.work takes
    them, the element size last, for the named towers ("vision", "text")."""
    b, elt = traffic["batch"], BYTES[traffic["precision"]]
    out = []
    for name in towers:
        t = cfg[name]
        if name == "vision":
            seq, causal = (t["image_size"] // t["patch_size"]) ** 2 + 1, False
        else:
            seq, causal = t["context_length"], True
        d, h, layers = t["width"], t["heads"], t["layers"]
        fwd, bwd = ("k1", "k3") if seq <= FUSED_MAX_T else ("k4", "k5")
        args = (b, seq, d, h, causal, elt) if fwd == "k1" else (b, h, seq, d // h, causal, elt)
        out.append((fwd, args, layers))
        if backward:
            out.append((bwd, args, layers))
    return out
