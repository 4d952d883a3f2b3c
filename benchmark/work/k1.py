"""K1, the fused pre-norm attention block's forward:
out = x + W_out MHA(W_qkv LN(x) + b_qkv) + b_out, on [B, T, D] with H heads.

Operations: the two weight products (2 M D 3D and 2 M D D, M = B T) and the
two attention products (q k^T and p v, 2 T dh each over the (query, key)
pairs that the mask keeps). Bytes: each input read once (x, the LN scale and
bias, W_qkv, b_qkv, W_out, b_out) and the output written once."""

# the launches that implement it, by kernel name (namespaces and arguments
# stripped): the tensor-core chain (bf16 at dh 64 and 96) and the SIMT chain
NAMES = (r"^ln_rows<", r"^gemm_tc<", r"^tc_block_fwd<", r"^gemm_f32<", r"^row_attention<",
         r"^block_gemm<")


def pairs(t: int, causal: bool) -> int:
    return t * (t + 1) // 2 if causal else t * t


def work(b: int, t: int, d: int, h: int, causal: bool, elt: int):
    """(operations, bytes) of one call; `elt` bytes an element."""
    m = b * t
    ops = 2 * m * d * 4 * d + 2 * 2 * b * h * pairs(t, causal) * (d // h)
    moved = elt * (2 * m * d + 2 * d + 3 * d * d + 3 * d + d * d + d)
    return ops, moved
