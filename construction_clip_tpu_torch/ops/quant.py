"""int8 inference quantization (counterpart of construction_clip_tpu/ops/quant.py).

Scheme, symmetric and zero-point-free:
  * weights: one fp32 scale per output column, scale = max|w| / 127 over the
    contracting axis (1 where a column is all zero), stored int8;
  * activations: one scale per row at call time, the same rule;
  * y = (xq @ wq) * s_x * s_w + b, the product accumulated in int32 and
    rescaled in fp32, with the JAX package's rounding points (round half to
    even, clip to +-127, the two scales applied in that order, then the bias,
    then one cast to the output dtype).

The int32 product is a plain matrix product, as the JAX package leaves it to
XLA: `torch._int_mm`. On the CPU it takes any shape. On CUDA it is cuBLASLt's
int8 GEMM, which wants more than 16 rows and K and N multiples of 8:
`int8_matmul` pads with zeros to meet that (exact: zero rows and columns add
nothing) and slices the padding off, for every shape alike. The quantized
weights of `quantize_tree` are stored K-contiguous (`gemm_layout`): on the H100
cuBLASLt's int8 GEMM runs faster with its second operand in that layout than
row-major (chip_smoke.py phase 15 times both), and K7 reads the same layout.
"""

from __future__ import annotations

import torch

_CUDA_MIN_ROWS = 17   # cuBLASLt int8: rows > 16, K and N multiples of 8
_CUDA_ALIGN = 8


def quantize_weight(w, *, axis: int = 0):
    """w [in, out] (y = x @ W) -> (int8 w, fp32 scale [out]); `axis` is the
    contracting axis, the scales live on the remaining one."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def quantize_rows(x32):
    """fp32 [.., D] -> (int8 rows, fp32 per-row scale [.., 1])."""
    s = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8), s


def _pad_to(n: int, multiple: int) -> int:
    return -n % multiple


def cublas_operands(a, b):
    """a [M, K], b [K, N] zero-padded to what cuBLASLt's int8 GEMM takes: more
    than 16 rows, K and N multiples of 8 (b keeps its layout when it needs no
    padding)."""
    (m, k), n = a.shape, b.shape[1]
    pad_m = max(_CUDA_MIN_ROWS - m, 0)
    pad_k, pad_n = _pad_to(k, _CUDA_ALIGN), _pad_to(n, _CUDA_ALIGN)
    if pad_m or pad_k:
        a = torch.nn.functional.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = torch.nn.functional.pad(b, (0, pad_n, 0, pad_k))
    return a.contiguous(), b


def int8_matmul(a, b):
    """int8 a [M, K] @ int8 b [K, N] -> exact int32 [M, N]."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    m, n = a.shape[0], b.shape[1]
    return torch._int_mm(*cublas_operands(a, b))[:m, :n]


def int8_linear(x, wq, w_scale, bias=None, *, out_dtype=None):
    """x [..., in] fp32/bf16, wq int8 [in, out], w_scale fp32 [out]: dynamic
    per-row activation quantization, int32 accumulation, fp32 rescale."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xq, s_x = quantize_rows(x.float().reshape(-1, x.shape[-1]))
    acc = int8_matmul(xq, wq)
    y = acc.float() * s_x * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*lead, wq.shape[-1])


def gemm_layout(q):
    """An int8 weight [..., K, N] stored with K contiguous (the transpose of
    its last two axes contiguous); same values, same shape."""
    return q.mT.contiguous().mT


def quantize_tree(params, paths):
    """Quantize the named [in, out] weight leaves of a nested dict for inference
    (leading stacked-layer axes allowed: one scale per column of each matrix,
    along axis -2, so a stacked [L, in, out] leaf gets [L, out] scales). Each
    addressed leaf becomes {"q": int8 in `gemm_layout`, "s": fp32}; the tree is
    copied along the paths, the input is left as it is."""
    params = dict(params)
    for path in paths:
        node = params
        for key in path[:-1]:
            node[key] = dict(node[key])
            node = node[key]
        q, s = quantize_weight(node[path[-1]], axis=-2)
        node[path[-1]] = {"q": gemm_layout(q), "s": s}
    return params
