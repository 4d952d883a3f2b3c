"""Fused pre-norm attention block forward,
out = x + W_out @ MHA(split_heads(W_qkv @ LN(x) + b_qkv)) + b_out
(counterpart of construction_clip_tpu/ops/pallas_attention_block.py).

`fused_attention_block` launches the CUDA kernel csrc/attention_block.cu (K1)
on CUDA tensors and runs `fused_attention_block_plain` on CPU tensors. The plain
version keeps the Pallas kernel's rounding points (see the CUDA source), so on
the card the two agree to summation order.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops.attention import NEG_INF, merge_heads, split_heads

MAX_T = 256
MAX_SMEM_BYTES = 232448  # a Hopper block's dynamic shared memory limit
_ATTN_WARPS = 4


def attention_smem_bytes(t: int, dh: int) -> int:
    """Shared memory of the attention launch: K (rows padded to dh+1) and V in
    fp32, plus per-warp logits and query rows (csrc/attention_block.cu:
    attn_smem_bytes)."""
    return 4 * (t * (dh + 1) + t * dh + _ATTN_WARPS * (t + dh))


def supported(x, n_heads: int) -> bool:
    """The JAX gates (fp32/bf16, heads divide the width, T <= 256), with the
    Hopper shared-memory budget in place of the TPU's VMEM budget."""
    b, t, d = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        return False
    if d % n_heads:
        return False
    return t <= MAX_T and attention_smem_bytes(t, d // n_heads) <= MAX_SMEM_BYTES


def fused_attention_block_plain(x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, *,
                                n_heads: int, causal: bool = False, eps: float = 1e-5):
    b, t, d = x.shape
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    h = ((x32 - mean) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()).to(dtype)
    qkv = (h.float() @ w_qkv.float()).to(dtype) + b_qkv
    q, k, v = (split_heads(z, n_heads) for z in qkv.chunk(3, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d // n_heads) ** -0.5
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        logits = torch.where(keep, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    merged = (torch.einsum("bhqk,bhkd->bhqd", p.to(dtype).float(), v.float())
              / p.sum(dim=-1, keepdim=True)).to(dtype)
    y = merge_heads(merged).float() @ w_out.float()
    return (x32 + y + b_out.float()).to(dtype)


def fused_attention_block(x, ln_params, attn_params, *, n_heads: int,
                          causal: bool = False, eps: float = 1e-5):
    """x [B, T, D] -> x + Attn(LN(x)); params as in models/blocks."""
    args = (ln_params["scale"], ln_params["bias"], attn_params["w_qkv"],
            attn_params["b_qkv"], attn_params["w_out"], attn_params["b_out"])
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, *args, n_heads=n_heads, causal=causal,
                                           eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block runs on cpu or cuda, not {x.device}")
    if not supported(x, n_heads):
        raise ValueError(f"fused_attention_block does not take {tuple(x.shape)} "
                         f"{x.dtype} with {n_heads} heads")
    b, t, d = x.shape
    shapes = ((d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,))
    for a, shape in zip((x,) + args, ((b, t, d),) + shapes):
        if a.device != x.device or a.dtype != x.dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"fused_attention_block wants contiguous {x.dtype} "
                             f"{shape} on {x.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    lib = _build.load_library()
    qkv = torch.empty((b * t, 3 * d), dtype=x.dtype, device=x.device)
    merged = torch.empty((b * t, d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.cct_attention_block_fwd(
            _build.dtype_code(x.dtype), x.data_ptr(), *(a.data_ptr() for a in args),
            qkv.data_ptr(), merged.data_ptr(), out.data_ptr(), b, t, d, n_heads,
            int(causal), float(eps), float((d // n_heads) ** -0.5),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_attention_block")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0
