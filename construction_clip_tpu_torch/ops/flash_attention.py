"""Attention over [B, H, T, Dh] without a [T, T] panel in device memory, forward
and backward (counterpart of construction_clip_tpu/ops/pallas_attention.py).

`flash_attention` is a `torch.autograd.Function` whose forward is K4 and whose
backward is K5 (csrc/flash_attention.cu) on CUDA tensors, and the plain
versions on CPU tensors. On the card `route` picks one of two hand-written
kernels by type and head width: the tensor-core kernels (wgmma, TMA) for bf16
at dh = 64, the SIMT tiles for fp32 and other widths; a launch that fails
raises and never retries on the other route. The plain forward mirrors
`_attn_kernel`: p = exp(s - max) in fp32, rounded to v's dtype for p.v, and the
sum divided by the fp32 row sum of p afterwards. The plain backward mirrors
`_bwd_kernel`: p recomputed from q and k in fp32, and dv, dp, ds, dq, dk all in
fp32, rounded once. The Pallas kernels' lane-aligned key split (`_split_point`)
is TPU layout scaffolding with the same math, and has no counterpart here.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build

MAX_T = 1024   # the JAX gate
MAX_DH = 128   # the kernels' per-lane register tiles (csrc/attention_tiles.cuh)
NEG_INF = torch.finfo(torch.float32).min
TC_DH = (64,)  # head widths of the tensor-core kernels (64 x 64 tiles)


def route(dtype, dh: int) -> str:
    """The kernel K4/K5 launch on the card: "tc" (bf16 products on the tensor
    cores) for bf16 at a head width of TC_DH, else "simt" (fp32 FMA tiles; fp32
    on the tensor cores would be TF32)."""
    return "tc" if dtype == torch.bfloat16 and dh in TC_DH else "simt"


def supported(q, k, v, *, bias=None) -> bool:
    """The JAX gate (no bias, equal lengths, T <= 1024, fp32 or bf16), plus the
    kernels' head-width bound."""
    if bias is not None:
        return False
    if q.dim() != 4 or tuple(k.shape) != tuple(v.shape) or q.shape[2] != k.shape[2]:
        return False
    if q.shape[2] > MAX_T or q.shape[3] > MAX_DH:
        return False
    return q.dtype in (torch.float32, torch.bfloat16)


def _logits(q, k, is_causal: bool, scale: float):
    logits = q.float() @ k.float().mT * scale
    if is_causal:
        t = q.shape[2]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(keep, logits, NEG_INF)
    return logits


def flash_attention_fwd_plain(q, k, v, *, is_causal: bool, scale: float):
    logits = _logits(q, k, is_causal, scale)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (p.to(v.dtype).float() @ v.float()) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def flash_attention_bwd_plain(q, k, v, g, *, is_causal: bool, scale: float):
    """-> dq, dk, dv."""
    logits = _logits(q, k, is_causal, scale)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    g32 = g.float()
    dv = p.mT @ g32
    dp = g32 @ v.float().mT
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = ds @ k.float()
    dk = ds.mT @ q.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(what, tensors, q):
    if not supported(q, q, q):
        raise ValueError(f"{what} does not take {tuple(q.shape)} {q.dtype}")
    for a in tensors:
        if a.device != q.device or a.dtype != q.dtype or a.shape != q.shape \
                or not a.is_contiguous():
            raise ValueError(f"{what} wants contiguous {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")


def flash_attention_fwd(q, k, v, *, is_causal: bool, scale: float):
    """The forward alone: K4 on CUDA tensors, the plain version on CPU tensors."""
    if _build.on_cpu(q, "flash_attention"):
        return flash_attention_fwd_plain(q, k, v, is_causal=is_causal, scale=scale)
    _check("flash_attention", (q, k, v), q)
    b, h, t, dh = q.shape
    lib = _build.load_library()
    tc = route(q.dtype, dh) == "tc"
    entry = lib.cct_flash_attention_fwd_tc if tc else lib.cct_flash_attention_fwd
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = entry(_build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, h, t, dh, int(is_causal), float(scale),
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    _count("k4", tc)
    return out


def flash_attention_bwd(q, k, v, g, *, is_causal: bool, scale: float):
    """-> dq, dk, dv: K5 on CUDA tensors, the plain version on CPU tensors."""
    if _build.on_cpu(q, "flash_attention_bwd"):
        return flash_attention_bwd_plain(q, k, v, g, is_causal=is_causal, scale=scale)
    _check("flash_attention_bwd", (q, k, v, g), q)
    b, h, t, dh = q.shape
    lib = _build.load_library()
    tc = route(q.dtype, dh) == "tc"
    entry = lib.cct_flash_attention_bwd_tc if tc else lib.cct_flash_attention_bwd
    work = torch.empty(3 * b * h * t, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = entry(_build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    g.data_ptr(), work.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    b, h, t, dh, int(is_causal), float(scale),
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    _count("k5", tc)
    return dq, dk, dv


def _count(kernel: str, tc: bool) -> None:
    tracing.count(kernel)
    tracing.count(f"{kernel}.tc" if tc else f"{kernel}.simt")


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, is_causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (is_causal, scale)
        return flash_attention_fwd(q, k, v, is_causal=is_causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        is_causal, scale = ctx.cfg
        dq, dk, dv = flash_attention_bwd(q, k, v, g.to(q.dtype).contiguous(),
                                         is_causal=is_causal, scale=scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, is_causal: bool = False, scale: float | None = None):
    """softmax(q k^T scale, causal) v over [B, H, T, Dh]; same contract as
    ops.attention.mha with no bias. Differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _Flash.apply(q, k, v, bool(is_causal), float(scale))
