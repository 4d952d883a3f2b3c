"""K5, flash attention's backward: dq, dk and dv from q, k, v and the
output's gradient.

Operations: five products a kept (query, key) pair, 2 dh each: q k^T again,
dp = dO v^T, dv, dq and dk (the Pallas kernel's cost estimate, 10 T^2 dh a
head unmasked). Bytes: q, k, v and dO read once, dq, dk and dv written once."""

from work.k1 import pairs

NAMES = (r"^tc_stats<", r"^tc_dq<false", r"^tc_dkv<",
         r"^attn_rows_tile<[^,]+,\s*(\([^)]*\))?[12]\s*,", r"^attn_cols_tile<")


def work(b: int, h: int, t: int, dh: int, causal: bool, elt: int):
    ops = 5 * 2 * b * h * pairs(t, causal) * dh
    moved = elt * 7 * b * h * t * dh
    return ops, moved
