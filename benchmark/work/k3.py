"""K3, the fused attention block's backward: from x and the output's
gradient g it recomputes LN, qkv and the probabilities and returns dx, dqkv,
the merged heads and the LN parameters' gradients (the caller forms the
weight gradients from them).

Operations: its weight products (g W_out^T: 2 M D D; qkv again: 2 M D 3D;
dqkv W_qkv^T: 2 M 3D D) and six attention products (q k^T and p v again, dp,
dv, dq, dk), each 2 dh a kept (query, key) pair. Bytes: x, g, the LN scale
and bias, W_qkv, b_qkv and W_out read once; dx, dqkv, merged and the two fp32
LN gradients written once."""

from work.k1 import pairs

NAMES = (r"^ln_rows<", r"^gemm_tc<", r"^tc_stats<", r"^tc_dq<true", r"^tc_dkv<",
         r"^ln_backward_rows<", r"^ln_param_partials<", r"^ln_param_reduce$", r"^gemm_f32<",
         r"^attn_rows_tile<", r"^attn_cols_tile<", r"^block_gemm<")


def work(b: int, t: int, d: int, h: int, causal: bool, elt: int):
    m = b * t
    ops = 2 * m * d * 7 * d + 6 * 2 * b * h * pairs(t, causal) * (d // h)
    moved = elt * (2 * m * d + 2 * d + 3 * d * d + 3 * d + d * d) \
        + elt * (m * d + 3 * m * d + m * d) + 4 * 2 * d
    return ops, moved
