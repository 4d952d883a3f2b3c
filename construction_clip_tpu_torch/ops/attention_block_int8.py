"""Fused pre-norm attention block with int8 weights and per-row int8
activations, serving forward only (counterpart of
construction_clip_tpu/ops/pallas_attention_block_int8.py):

    out = x + W_out . MHA(split_heads(W_qkv . LN(x)))

W_qkv and W_out arrive quantized ({"q": int8 [D, 3D] / [D, D] stored
K-contiguous, "s": fp32 scales [3D] / [D]}, ops/quant.quantize_tree); the
biases stay float.
`fused_attention_block_int8` launches K7 (csrc/attention_block_int8.cu) on CUDA
tensors and runs `fused_attention_block_int8_plain` on CPU tensors. On the card
`route` picks the C entry: the tensor-core attention pass for bf16 at dh = 64,
the SIMT one otherwise; a launch that fails raises and never retries on the
other entry. On both, the two int8 products run on the tensor cores (wgmma
s8) where the width is a multiple of 16 (`gemm_route`), else on `__dp4a`; their
int32 sums are exact, so the two give the same bits. The plain
version keeps the Pallas kernel's rounding points: LN in fp32 (not rounded),
per-row quantization, int32 products, qkv rounded once to x's dtype, p rounded
to v's dtype for p . v, the merged heads kept in fp32 for the second
quantization, and one rounding of the residual sum.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops.attention import NEG_INF, merge_heads, split_heads
from construction_clip_tpu_torch.ops.attention_block import (
    MAX_SMEM_BYTES, MAX_T, attention_smem_bytes)
from construction_clip_tpu_torch.ops.quant import int8_matmul, quantize_rows

MAX_ROW_BYTES = 48 * 1024   # the row-quantization launch keeps one fp32 row in shared memory
TMA_ROW_BYTES = 16          # TMA reads rows whose pitch is a multiple of 16 bytes
TC_DH = (64,)               # head widths of the tensor-core attention pass (its C entry's)


def route(dtype, dh: int) -> str:
    """The C entry K7 launches on the card: "tc" (the attention pass on the
    tensor cores) for bf16 at a head width of TC_DH, else "simt" (fp32 FMA;
    fp32 on the tensor cores would be TF32)."""
    return "tc" if dtype == torch.bfloat16 and dh in TC_DH else "simt"


def gemm_route(d: int) -> str:
    """What K7's two int8 products run on, on either route: "wgmma" (s8 on the
    tensor cores, int8 rows of d bytes read by TMA) where d is a multiple of
    16, else "dp4a" (the CUDA cores); the C entries choose by the same rule."""
    return "wgmma" if d % TMA_ROW_BYTES == 0 else "dp4a"


def supported(x, n_heads: int) -> bool:
    """The JAX gate (fp32/bf16, heads divide the width, T <= 256), with the
    Hopper shared-memory budget in place of the TPU's 12 MiB of VMEM."""
    b, t, d = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or d % n_heads:
        return False
    return (t <= MAX_T and 4 * d <= MAX_ROW_BYTES
            and attention_smem_bytes(t, d // n_heads) <= MAX_SMEM_BYTES)


def fused_attention_block_int8_plain(x, ln_s, ln_b, wq_qkv, s_qkv, b_qkv, wq_out, s_out,
                                     b_out, *, n_heads: int, causal: bool = False,
                                     eps: float = 1e-5):
    b, t, d = x.shape
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    h32 = (x32 - mean) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()
    hq, hs = quantize_rows(h32.reshape(b * t, d))
    qkv = (int8_matmul(hq, wq_qkv).float() * hs * s_qkv + b_qkv.float()).to(dtype)
    q, k, v = (split_heads(z, n_heads) for z in qkv.reshape(b, t, 3 * d).chunk(3, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d // n_heads) ** -0.5
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        logits = torch.where(keep, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    merged32 = (torch.einsum("bhqk,bhkd->bhqd", p.to(dtype).float(), v.float())
                / p.sum(dim=-1, keepdim=True))
    mq, ms = quantize_rows(merge_heads(merged32).reshape(b * t, d))
    y = (int8_matmul(mq, wq_out).float() * ms * s_out).reshape(b, t, d)
    return (x32 + y + b_out.float()).to(dtype)


def _check_kernel_args(x, args, n_heads):
    b, t, d = x.shape
    if not supported(x, n_heads):
        raise ValueError(f"fused_attention_block_int8 does not take {tuple(x.shape)} "
                         f"{x.dtype} with {n_heads} heads")
    specs = ((d,), x.dtype), ((d,), x.dtype), ((d, 3 * d), torch.int8), \
        ((3 * d,), torch.float32), ((3 * d,), x.dtype), ((d, d), torch.int8), \
        ((d,), torch.float32), ((d,), x.dtype)
    names = ("ln_s", "ln_b", "w_qkv.q", "w_qkv.s", "b_qkv", "w_out.q", "w_out.s", "b_out")
    for name, a, (shape, dtype) in zip(names, args, specs):
        # the int8 weights are read K-contiguous (ops/quant.gemm_layout)
        dense = a.mT.is_contiguous() if dtype == torch.int8 else a.is_contiguous()
        if a.device != x.device or a.dtype != dtype or tuple(a.shape) != shape or not dense:
            raise ValueError(f"fused_attention_block_int8: {name} must be a {dtype} {shape} "
                             f"on {x.device} in its layout, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if not x.is_contiguous():
        raise ValueError("fused_attention_block_int8: x must be contiguous")


def fused_attention_block_int8(x, ln_params, qattn, *, n_heads: int, causal: bool = False,
                               eps: float = 1e-5):
    """x [B, T, D] -> x + Attn(LN(x)); qattn: the attention params with
    w_qkv/w_out as {"q": int8, "s": fp32} and float b_qkv/b_out."""
    args = (ln_params["scale"], ln_params["bias"], qattn["w_qkv"]["q"], qattn["w_qkv"]["s"],
            qattn["b_qkv"], qattn["w_out"]["q"], qattn["w_out"]["s"], qattn["b_out"])
    if _build.on_cpu(x, "fused_attention_block_int8"):
        return fused_attention_block_int8_plain(x, *args, n_heads=n_heads, causal=causal,
                                                eps=eps)
    _check_kernel_args(x, args, n_heads)
    b, t, d = x.shape
    lib = _build.load_library()
    dev = x.device
    q8 = torch.empty((b * t, d), dtype=torch.int8, device=dev)
    rs = torch.empty(b * t, dtype=torch.float32, device=dev)
    qkv = torch.empty((b * t, 3 * d), dtype=x.dtype, device=dev)
    merged = torch.empty((b * t, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    on_tc = route(x.dtype, d // n_heads) == "tc"
    entry = lib.cct_attention_block_int8_tc if on_tc else lib.cct_attention_block_int8
    with torch.cuda.device(dev):
        err = entry(
            _build.dtype_code(x.dtype), x.data_ptr(), *(a.data_ptr() for a in args),
            q8.data_ptr(), rs.data_ptr(), qkv.data_ptr(), merged.data_ptr(), out.data_ptr(),
            b, t, d, n_heads, int(causal), float(eps), float((d // n_heads) ** -0.5),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_attention_block_int8")
    tracing.count("k7")
    if on_tc:
        tracing.count("k7.tc")
    return out
