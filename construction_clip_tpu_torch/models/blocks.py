"""Pre-norm transformer blocks over stacked layer params (counterpart of
construction_clip_tpu/models/blocks.py): LN -> fused-QKV attention -> residual,
LN -> MLP(act) -> residual. Params for L layers are stacked along a leading axis
(the JAX layout); `apply_stack` walks them in a Python loop.

The attention half takes the fused block (ops/attention_block.py, kernel K1)
exactly where the JAX package takes its Pallas block: no bias, and `supported`.
The MLP half takes the fused MLP residual (ops/mlp.py, kernel K9) where the JAX
package takes its Pallas MLP: `USE_FUSED_MLP` on, a QuickGELU block, the kernel
impl and `mlp.supported`. `USE_FUSED_MLP` is the JAX package's switch, off by
default as there; otherwise the MLP is plain PyTorch (cuBLAS GEMMs and
elementwise ops).
"""

from __future__ import annotations

from typing import Callable

from construction_clip_tpu_torch.core.params import tree_map
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import mlp
from construction_clip_tpu_torch.ops.activations import quick_gelu
from construction_clip_tpu_torch.ops.attention import qkv_attention, resolve_impl
from construction_clip_tpu_torch.ops.norms import layer_norm

USE_FUSED_MLP = False   # construction_clip_tpu/models/blocks.py:104, off there too


def apply_block(params, x, *, n_heads: int, act: Callable, bias=None,
                is_causal: bool = False, ln_eps: float = 1e-5):
    if bias is None and resolve_impl() == "kernel" and fab.supported(x, n_heads):
        x = fab.fused_attention_block(x, params["ln_1"], params["attn"], n_heads=n_heads,
                                      causal=is_causal, eps=ln_eps)
    else:
        h = layer_norm(x, params["ln_1"]["scale"], params["ln_1"]["bias"], eps=ln_eps)
        x = x + qkv_attention(h, params["attn"], n_heads, bias=bias, is_causal=is_causal)
    return _mlp_residual(x, params, act, ln_eps)


def _mlp_residual(x, params, act, ln_eps):
    if USE_FUSED_MLP and act is quick_gelu and resolve_impl() == "kernel" \
            and mlp.supported(x, params["mlp"]["w_fc"]):
        return mlp.fused_mlp_residual(x, params["mlp"], params["ln_2"], eps=ln_eps)
    h = layer_norm(x, params["ln_2"]["scale"], params["ln_2"]["bias"], eps=ln_eps)
    h = act(h @ params["mlp"]["w_fc"] + params["mlp"]["b_fc"])
    return x + (h @ params["mlp"]["w_proj"] + params["mlp"]["b_proj"])


def apply_stack(stacked_params, x, *, n_heads: int, act: Callable, bias=None,
                is_causal: bool = False, ln_eps: float = 1e-5):
    """Apply the L stacked blocks in order. The layers are views from one
    `unbind` per leaf, whose backward stacks the L gradients in one op (a view
    per layer would each scatter into a zeroed copy of the whole stack)."""
    layers = tree_map(lambda z: z.unbind(0), stacked_params)
    for index in range(stacked_params["ln_1"]["scale"].shape[0]):
        x = apply_block(tree_map(lambda views: views[index], layers), x, n_heads=n_heads,
                        act=act, bias=bias, is_causal=is_causal, ln_eps=ln_eps)
    return x
