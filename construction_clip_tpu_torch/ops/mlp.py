"""Fused pre-norm MLP residual,
out = x + W_proj . quick_gelu(W_fc . LN(x) + b_fc) + b_proj (counterpart of
construction_clip_tpu/ops/pallas_mlp.py).

`fused_mlp_residual` is a `torch.autograd.Function` whose forward is K9
(csrc/mlp_residual.cu) on CUDA tensors and `fused_mlp_residual_plain` on CPU
tensors. On the card `route` picks K9's chain: the tensor-core chain (wgmma,
TMA) for bf16 where D and the hidden width are multiples of 8, the SIMT chain
otherwise, whose products run on csrc/gemm_f32.cuh's GEMM in fp32 and on
csrc/gemm.cuh's in bf16 (`gemm_route`); a launch that fails raises and never
retries on the other route. Its backward recomputes `_ref_math`, the composable math, and takes
its gradient, as the Pallas kernel's custom_vjp does: the JAX package has no
backward kernel for this function, so neither has the port (the backward's
GEMMs are cuBLAS's).

The plain version keeps the Pallas kernel's rounding points: LN statistics
and affine in fp32, rounded to x's dtype; h . W_fc summed in fp32, rounded,
then + b_fc in x's dtype; QuickGELU in x's dtype (ops/activations, whose
bf16 constants round first); h . W_proj summed in fp32; the output
T(x32 + y + b_proj32) rounded once. K9 rounds at the same points.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops.activations import quick_gelu
from construction_clip_tpu_torch.ops.norms import layer_norm


def supported(x, w_fc) -> bool:
    """The JAX gate without its VMEM bound: [B, T, D] in fp32 or bf16. The
    Pallas kernel holds both weight matrices in VMEM, hence its 12 MiB limit;
    K9 streams its weights from HBM, so it takes any width."""
    return x.dim() == 3 and x.dtype in (torch.float32, torch.bfloat16)


def route(dtype, d: int, hidden: int) -> str:
    """The chain K9 launches on the card: "tc" (bf16 products on the tensor
    cores) for bf16 where D and the hidden width are multiples of 8 (TMA's
    16-byte row pitch), else "simt" (fp32 FMA; fp32 on the tensor cores would
    be TF32)."""
    return "tc" if dtype == torch.bfloat16 and d % 8 == 0 and hidden % 8 == 0 else "simt"


def gemm_route(dtype, d: int, hidden: int) -> str:
    """What K9's two weight products run on: "gemm_tc" (wgmma, the tensor-core
    route), "gemm_f32" (fp32 FMA fed by a TMA ring, after one LN pass a row:
    the SIMT route in fp32) or "block_gemm" (the LN-prologue GEMM: the SIMT
    route in bf16, where D or the hidden width is no multiple of 8); the C
    entries choose by the same rule."""
    if route(dtype, d, hidden) == "tc":
        return "gemm_tc"
    return "gemm_f32" if dtype == torch.float32 else "block_gemm"


def fused_mlp_residual_plain(x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, *, eps: float = 1e-5):
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    h = ((x32 - mean) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()).to(dtype)
    h = quick_gelu((h.float() @ w_fc.float()).to(dtype) + b_fc)
    y = h.float() @ w_proj.float()
    return (x32 + y + b_proj.float()).to(dtype)


def _ref_math(x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, eps):
    h = layer_norm(x, ln_s, ln_b, eps=eps)
    h = quick_gelu(h @ w_fc + b_fc)
    return x + h @ w_proj + b_proj


def fused_mlp_residual_fwd(x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, *, eps: float = 1e-5):
    """The forward alone: K9 on CUDA tensors, the plain version on CPU tensors."""
    args = (ln_s, ln_b, w_fc, b_fc, w_proj, b_proj)
    if _build.on_cpu(x, "fused_mlp_residual"):
        return fused_mlp_residual_plain(x, *args, eps=eps)
    if not supported(x, w_fc):
        raise ValueError(f"fused_mlp_residual does not take {tuple(x.shape)} {x.dtype}")
    b, t, d = x.shape
    hidden = w_fc.shape[-1]
    shapes = ((b, t, d), (d,), (d,), (d, hidden), (hidden,), (hidden, d), (d,))
    names = ("x", "ln_scale", "ln_bias", "w_fc", "b_fc", "w_proj", "b_proj")
    for name, a, shape in zip(names, (x,) + args, shapes):
        if a.device != x.device or a.dtype != x.dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"fused_mlp_residual wants {name} contiguous {x.dtype} {shape} "
                             f"on {x.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")
    lib = _build.load_library()
    tc = route(x.dtype, d, hidden) == "tc"
    entry = lib.cct_mlp_residual_tc if tc else lib.cct_mlp_residual
    h = torch.empty((b * t, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = entry(
            _build.dtype_code(x.dtype), x.data_ptr(), *(a.data_ptr() for a in args),
            h.data_ptr(), out.data_ptr(), b * t, d, hidden, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_mlp_residual")
    tracing.count("k9")
    if tc:
        tracing.count("k9.tc")
    return out


class _FusedMLP(torch.autograd.Function):
    """K9 forward; backward by autograd through `_ref_math` recomputed from the
    saved inputs (pallas_mlp._fused_bwd)."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, eps):
        ctx.save_for_backward(x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj)
        ctx.eps = eps
        return fused_mlp_residual_fwd(x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, eps=eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[:7]) if need]
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(i in wanted) for i, a in enumerate(saved)]
            out = _ref_math(*inputs, ctx.eps)
            grads = iter(torch.autograd.grad(out, [inputs[i] for i in wanted], g))
        return tuple(next(grads) if i in wanted else None for i in range(7)) + (None,)


def fused_mlp_residual(x, mlp_params, ln_params, *, eps: float = 1e-5):
    """x [B, T, D] -> x + MLP(LN(x)) with QuickGELU; params as in models/blocks
    (w_fc [D, H], w_proj [H, D], ln scale/bias)."""
    return _FusedMLP.apply(x, ln_params["scale"], ln_params["bias"], mlp_params["w_fc"],
                           mlp_params["b_fc"], mlp_params["w_proj"], mlp_params["b_proj"],
                           float(eps))
