"""Fused pre-norm attention block,
out = x + W_out @ MHA(split_heads(W_qkv @ LN(x) + b_qkv)) + b_out, forward and
backward (counterpart of construction_clip_tpu/ops/pallas_attention_block.py).

`fused_attention_block` is a `torch.autograd.Function` whose forward is K1
(csrc/attention_block.cu) and whose backward is K3 (csrc/attention_block_bwd.cu)
on CUDA tensors, and the plain versions on CPU tensors. On the card `route`
picks the chain of both kernels: the tensor-core chain (wgmma, TMA) for bf16 at
dh = 64 or 96, the SIMT chain for fp32 and other widths (in fp32 its weight
products run on csrc/gemm_f32.cuh's GEMM, in bf16 on csrc/gemm.cuh's); a launch
that fails raises and never retries on the other route. K3 recomputes LN, qkv
and the probabilities from x, as the Pallas backward does, so the Function
saves only its inputs; its tensor-core route and its fp32 route also hand back
h = T(LN(x)), the operand of W_qkv's gradient, which the Function recomputes
otherwise (the bf16 SIMT route). Where autograd records no
graph (serving under `torch.inference_mode()`, or no input requiring grad),
nothing is kept after the forward. The plain versions keep the Pallas kernels' rounding
points (see the CUDA sources), so on the card kernel and plain version agree to
summation order.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops.attention import NEG_INF, merge_heads, split_heads
from construction_clip_tpu_torch.ops.norms import layer_norm

MAX_T = 256
MAX_DH = 128             # K3's per-lane register tiles (csrc/attention_tiles.cuh)
TC_DH = (64, 96)         # head widths of K1/K3's tensor-core routes (attention_tc.cuh)
MAX_SMEM_BYTES = 232448  # a Hopper block's dynamic shared memory limit
_ATTN_WARPS = 4


def attention_smem_bytes(t: int, dh: int) -> int:
    """The gate's shared-memory budget (K1, K3 and K7): a head's K (rows padded
    to dh+1) and V in fp32 plus four warps' logits and query rows, the
    footprint of the one-warp-a-row attention launch the gate was set for.
    The formula stays so that the gate admits the same shapes; the attention
    pass that runs now (csrc/row_attention.cuh) holds a block's rows' score
    panel and two streamed tiles, which fit a block's shared memory at every
    shape this budget admits."""
    return 4 * (t * (dh + 1) + t * dh + _ATTN_WARPS * (t + dh))


def route(dtype, dh: int) -> str:
    """The chain K1 and K3 launch on the card: "tc" (bf16 products on the
    tensor cores) for bf16 at a head width of TC_DH, else "simt" (fp32 FMA;
    fp32 on the tensor cores would be TF32)."""
    return "tc" if dtype == torch.bfloat16 and dh in TC_DH else "simt"


def supported(x, n_heads: int) -> bool:
    """The JAX gates (fp32/bf16, heads divide the width, T <= 256), with the
    Hopper shared-memory and register budgets in place of the TPU's VMEM
    budget; one gate for K1 and K3."""
    b, t, d = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        return False
    if d % n_heads or d // n_heads > MAX_DH:
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


def fused_attention_block_bwd_plain(x, g, ln_s, ln_b, w_qkv, b_qkv, w_out, *,
                                    n_heads: int, causal: bool = False, eps: float = 1e-5):
    """-> dx, dqkv [B, T, 3D], merged [B, T, D], dln_scale, dln_bias (fp32),
    with _bwd_kernel's rounding points: h, qkv, p_lo, dmg and ds in the input
    dtype; p, dp and the LN backward in fp32."""
    b, t, d = x.shape
    dtype = x.dtype
    scale = (d // n_heads) ** -0.5
    x32, g32, s32 = x.float(), g.float(), ln_s.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    h = (xhat * s32 + ln_b.float()).to(dtype)
    qkv = (h.float() @ w_qkv.float()).to(dtype) + b_qkv
    q, k, v = (split_heads(z, n_heads).float() for z in qkv.chunk(3, dim=-1))
    dmg = split_heads((g32 @ w_out.float().mT).to(dtype), n_heads).float()
    logits = q @ k.mT * scale
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        logits = torch.where(keep, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    p_lo = p.to(dtype).float()
    merged = (p_lo @ v).to(dtype)
    dp = dmg @ v.mT
    dv = (p_lo.mT @ dmg).to(dtype)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(dtype).float()
    dq = (ds @ k).to(dtype)
    dk = (ds.mT @ q).to(dtype)
    dqkv = torch.cat([merge_heads(dq), merge_heads(dk), merge_heads(dv)], dim=-1)
    dh = dqkv.float() @ w_qkv.float().mT
    dxhat = dh * s32
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (g32 + rstd * (dxhat - m1 - xhat * m2)).to(dtype)
    return (dx, dqkv, merge_heads(merged), (dh * xhat).sum(dim=(0, 1)),
            dh.sum(dim=(0, 1)))


def _check_kernel_args(what, x, tensors, shapes, n_heads):
    if not supported(x, n_heads):
        raise ValueError(f"{what} does not take {tuple(x.shape)} {x.dtype} "
                         f"with {n_heads} heads")
    for a, shape in zip(tensors, shapes):
        if a.device != x.device or a.dtype != x.dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"{what} wants contiguous {x.dtype} {shape} on {x.device}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")


def fused_attention_block_fwd(x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, *, n_heads: int,
                              causal: bool = False, eps: float = 1e-5):
    """The forward alone: K1 on CUDA tensors, the plain version on CPU tensors."""
    args = (ln_s, ln_b, w_qkv, b_qkv, w_out, b_out)
    if _build.on_cpu(x, "fused_attention_block"):
        return fused_attention_block_plain(x, *args, n_heads=n_heads, causal=causal, eps=eps)
    b, t, d = x.shape
    _check_kernel_args("fused_attention_block", x, (x,) + args,
                       ((b, t, d), (d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,)), n_heads)
    lib = _build.load_library()
    tc = route(x.dtype, d // n_heads) == "tc"
    entry = lib.cct_attention_block_fwd_tc if tc else lib.cct_attention_block_fwd
    qkv = torch.empty((b * t, 3 * d), dtype=x.dtype, device=x.device)
    merged = torch.empty((b * t, d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = entry(
            _build.dtype_code(x.dtype), x.data_ptr(), *(a.data_ptr() for a in args),
            qkv.data_ptr(), merged.data_ptr(), out.data_ptr(), b, t, d, n_heads,
            int(causal), float(eps), float((d // n_heads) ** -0.5),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_attention_block")
    tracing.count("k1")
    if tc:
        tracing.count("k1.tc")
    return out


def fused_attention_block_bwd(x, g, ln_s, ln_b, w_qkv, b_qkv, w_out, *, n_heads: int,
                              causal: bool = False, eps: float = 1e-5, with_h: bool = False):
    """-> dx, dqkv, merged, dln_scale, dln_bias: K3 on CUDA tensors, the plain
    version on CPU tensors. With `with_h`, also h = T(LN(x)) where K3 left it
    in its workspace (the tensor-core route, and fp32), else None."""
    args = (ln_s, ln_b, w_qkv, b_qkv, w_out)
    if _build.on_cpu(x, "fused_attention_block_bwd"):
        grads = fused_attention_block_bwd_plain(x, g, *args, n_heads=n_heads, causal=causal,
                                                eps=eps)
        return (*grads, None) if with_h else grads
    b, t, d = x.shape
    _check_kernel_args("fused_attention_block_bwd", x, (x, g) + args,
                       ((b, t, d), (b, t, d), (d,), (d,), (d, 3 * d), (3 * d,), (d, d)),
                       n_heads)
    lib = _build.load_library()
    dev, dtype = x.device, x.dtype
    tc = route(dtype, d // n_heads) == "tc"
    entry = lib.cct_attention_block_bwd_tc if tc else lib.cct_attention_block_bwd
    # qkv [B*T, 3D] and dmg [B*T, D]; the tensor-core route and fp32 leave h [B*T, D]
    # after them
    leaves_h = tc or dtype == torch.float32
    work_t = torch.empty((5 if leaves_h else 4) * b * t * d, dtype=dtype, device=dev)
    work_f = torch.empty(lib.cct_attention_block_bwd_work_floats(b, t, d, n_heads),
                         dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dqkv = torch.empty((b, t, 3 * d), dtype=dtype, device=dev)
    merged = torch.empty((b, t, d), dtype=dtype, device=dev)
    dln_s = torch.empty(d, dtype=torch.float32, device=dev)
    dln_b = torch.empty(d, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = entry(
            _build.dtype_code(dtype), x.data_ptr(), g.data_ptr(),
            *(a.data_ptr() for a in args), work_t.data_ptr(), work_f.data_ptr(),
            dx.data_ptr(), dqkv.data_ptr(), merged.data_ptr(), dln_s.data_ptr(),
            dln_b.data_ptr(), b, t, d, n_heads, int(causal), float(eps),
            float((d // n_heads) ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_attention_block_bwd")
    tracing.count("k3")
    if tc:
        tracing.count("k3.tc")
    grads = (dx, dqkv, merged, dln_s, dln_b)
    if not with_h:
        return grads
    return (*grads, work_t[4 * b * t * d:].view(b, t, d) if leaves_h else None)


def _weight_grad(a, b, dtype):
    """a^T b over all rows, rounded to `dtype` (a bf16 matmul sums in fp32)."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a.mT @ b).to(dtype)


class _FusedBlock(torch.autograd.Function):
    """K1 forward, K3 backward; the weight gradients are two matmuls over K3's
    staged operands, as _fused_bwd leaves them to XLA."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, n_heads, causal, eps):
        ctx.save_for_backward(x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out)
        ctx.cfg = (n_heads, causal, eps)
        return fused_attention_block_fwd(x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out,
                                         n_heads=n_heads, causal=causal, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out = ctx.saved_tensors
        n_heads, causal, eps = ctx.cfg
        g = g.to(x.dtype).contiguous()
        dx, dqkv, merged, dln_s, dln_b, h = fused_attention_block_bwd(
            x, g, ln_s, ln_b, w_qkv, b_qkv, w_out, n_heads=n_heads, causal=causal, eps=eps,
            with_h=True)
        if h is None:
            h = layer_norm(x, ln_s, ln_b, eps=eps)
        return (dx, dln_s.to(ln_s.dtype), dln_b.to(ln_b.dtype),
                _weight_grad(h, dqkv, w_qkv.dtype),
                dqkv.sum(dim=(0, 1), dtype=torch.float32).to(b_qkv.dtype),
                _weight_grad(merged, g, w_out.dtype),
                g.sum(dim=(0, 1), dtype=torch.float32).to(b_out.dtype), None, None, None)


def fused_attention_block(x, ln_params, attn_params, *, n_heads: int,
                          causal: bool = False, eps: float = 1e-5):
    """x [B, T, D] -> x + Attn(LN(x)); params as in models/blocks."""
    args = (ln_params["scale"], ln_params["bias"], attn_params["w_qkv"],
            attn_params["b_qkv"], attn_params["w_out"], attn_params["b_out"])
    return _FusedBlock.apply(x, *args, n_heads, bool(causal), float(eps))
