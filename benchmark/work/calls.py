"""The traced launches that implement a cell's hand-kernel calls, and the
kernels' rooflines. A cell's loop hands its record the calls one unit makes
(`record.calls`: [(function, args, calls a unit)], as work/clip_plan.py
makes them for CLIP); a loop that hands none has no roofline to read.

Launches are matched to functions by the kernel names each work/<k>.py lists.
A name that more than one of the cell's functions lists (K3 and K5 share the
tensor-core attention passes `tc_stats` and `tc_dkv`; K1 and K3 the row pass
and `gemm_tc`) goes to the function of the nearest launch, in stream order,
whose name is that function's alone, or was resolved so before.
"""

from __future__ import annotations

import importlib
import re

from peaks import bound_s

NEAR = 8   # launches looked at on each side of an ambiguous one


def _module(fn: str):
    return importlib.import_module(f"work.{fn}")


def attribute(kernels, functions) -> list:
    """The function each launch implements (None: none of `functions`).
    kernels: [(short name, start, duration)] in stream order."""
    pats = {fn: [re.compile(p) for p in _module(fn).NAMES] for fn in functions}
    cands = [[fn for fn, ps in pats.items() if any(p.search(name) for p in ps)]
             for name, _, _ in kernels]
    owner = [c[0] if len(c) == 1 else None for c in cands]
    changed = True
    while changed:
        changed = False
        for i, c in enumerate(cands):
            if owner[i] is not None or len(c) < 2:
                continue
            for step in range(1, NEAR + 1):
                near = [owner[j] for j in (i - step, i + step)
                        if 0 <= j < len(owner) and owner[j] in c]
                if near:
                    owner[i] = near[0]
                    changed = True
                    break
    return owner


def roofline(record, functions) -> float | None:
    """Percent: the bound time of the traced stretch's calls of `functions`
    over the device time of the launches matched to them; None where no
    launch matched."""
    tr, plan = record.trace, getattr(record, "calls", None)
    if tr is None or not plan:
        return None
    present = sorted({fn for fn, _, _ in plan})
    owner = attribute(tr.kernels, present)
    dev_ns = sum(dur for (_, _, dur), fn in zip(tr.kernels, owner) if fn in functions)
    if dev_ns == 0:
        return None
    dtype = record.traffic["precision"]
    bound = sum(count * bound_s(*_module(fn).work(*args)[:2], dtype)
                for fn, args, count in plan if fn in functions)
    return 100.0 * tr.units * bound / (dev_ns / 1e9)


def launch_table(record) -> dict:
    """{function: {kernel name: launches a unit}} of the traced stretch, and
    the calls a unit that the configuration expects."""
    tr, plan = record.trace, record.calls
    owner = attribute(tr.kernels, sorted({fn for fn, _, _ in plan}))
    table = {}
    for (name, _, _), fn in zip(tr.kernels, owner):
        if fn is not None:
            row = table.setdefault(fn, {})
            row[name] = row.get(name, 0) + 1 / tr.units
    return {"launches_a_unit": table,
            "calls_a_unit": {fn: count for fn, _, count in plan}}


KINDS = (("cuBLAS GEMM", r"^(nvjet|sm\d+_xmma|Kernel2<cutlass|cutlass|gemv|gemm_kernel)"),
         ("elementwise", r"^(vectorized_elementwise|elementwise|unrolled_elementwise)"),
         ("reduction", r"^(reduce_kernel|.*[Ss]oftmax)"))


def by_kind(record) -> dict:
    """The traced stretch's device ms a unit: the hand kernels of the plan by
    function, the rest by kind of library kernel."""
    tr, plan = record.trace, getattr(record, "calls", None) or []
    owner = attribute(tr.kernels, sorted({fn for fn, _, _ in plan}))
    out: dict = {}
    for (name, _, dur), fn in zip(tr.kernels, owner):
        kind = fn or next((k for k, pat in KINDS if re.search(pat, name)), "other")
        out[kind] = out.get(kind, 0.0) + dur / 1e6 / tr.units
    return {k: round(v, 3) for k, v in sorted(out.items(), key=lambda kv: -kv[1])}
