"""K4, flash attention's forward over [B, H, T, dh]: o = softmax(q k^T / sqrt(dh)) v.

Operations: q k^T and p v, 2 dh each a kept (query, key) pair. Bytes: q, k
and v read once, o written once."""

from work.k1 import pairs

NAMES = (r"^tc_fwd$", r"^attn_rows_tile<[^,]+,\s*(\([^)]*\))?0\s*,")


def work(b: int, h: int, t: int, dh: int, causal: bool, elt: int):
    ops = 2 * 2 * b * h * pairs(t, causal) * dh
    moved = elt * 4 * b * h * t * dh
    return ops, moved
