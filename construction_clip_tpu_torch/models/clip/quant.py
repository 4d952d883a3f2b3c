"""int8 serving path for the CLIP image tower (counterpart of
construction_clip_tpu/models/clip/quant.py).

The patch embedding, each block's four GEMMs and the output projection run as
int8 products with per-row dynamic activation quantization (ops/quant.py);
LayerNorm, softmax and the per-head attention stay bf16/fp32. The attention
half of a block is K7 (ops/attention_block_int8.py) under the "kernel" impl
where its gate takes the shape, and the composable int8_linear math of the JAX
package's fallback under "plain". The two round differently: the composable
math rounds the LN output and the merged heads to x's dtype before quantizing
them and adds the residual after the cast, K7 does neither.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.params import as_tree, layer, tree_map
from construction_clip_tpu_torch.models.clip.model import _act, _l2_normalize, patchify
from construction_clip_tpu_torch.ops import attention_block_int8 as fab8
from construction_clip_tpu_torch.ops.attention import merge_heads, resolve_impl, split_heads
from construction_clip_tpu_torch.ops.norms import layer_norm
from construction_clip_tpu_torch.ops.quant import int8_linear, quantize_tree

_QUANT_PATHS = (
    ("vision", "patch_embed"),
    ("vision", "blocks", "attn", "w_qkv"),
    ("vision", "blocks", "attn", "w_out"),
    ("vision", "blocks", "mlp", "w_fc"),
    ("vision", "blocks", "mlp", "w_proj"),
    ("vision", "proj"),
)


def quantize_clip(params):
    """Full-precision CLIP params -> int8-serving params: the vision tower's
    patch embed, block GEMMs and output projection become {"q": int8, "s":
    fp32} leaves; every other float leaf is cast to bf16."""
    params = tree_map(lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x,
                      as_tree(params))
    return quantize_tree(params, _QUANT_PATHS)


def is_quantized_clip(params) -> bool:
    return isinstance(params["vision"]["patch_embed"], dict)


def _attn_residual_q(x, ln_1, qattn, n_heads: int, eps: float = 1e-5):
    """x + Attn(LN(x)) with int8 weights: K7 under the kernel impl where it
    takes the shape, the composable int8_linear math otherwise."""
    if resolve_impl() == "kernel" and fab8.supported(x, n_heads):
        return fab8.fused_attention_block_int8(x, ln_1, qattn, n_heads=n_heads, eps=eps)
    h = layer_norm(x, ln_1["scale"], ln_1["bias"], eps=eps)
    qkv = int8_linear(h, qattn["w_qkv"]["q"], qattn["w_qkv"]["s"], qattn["b_qkv"],
                      out_dtype=x.dtype)
    q, k, v = (split_heads(z, n_heads) for z in qkv.chunk(3, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).to(x.dtype)
    return x + int8_linear(merge_heads(o), qattn["w_out"]["q"], qattn["w_out"]["s"],
                           qattn["b_out"], out_dtype=x.dtype)


def encode_image_int8(qparams, cfg: CLIPConfig, images, *, normalize: bool = False):
    """images [B, H, W, 3] float -> [B, embed_dim] bf16 features: encode_image's
    math with the patch, block and projection GEMMs in int8."""
    v = cfg.vision
    p = qparams["vision"]
    act = _act(cfg)
    bf16 = torch.bfloat16
    x = patchify(images.to(bf16), v.patch_size)
    x = int8_linear(x, p["patch_embed"]["q"], p["patch_embed"]["s"], out_dtype=bf16)
    cls = p["class_emb"].expand(x.shape[0], 1, v.width)
    x = torch.cat([cls, x], dim=1) + p["pos_emb"]
    x = layer_norm(x, p["ln_pre"]["scale"], p["ln_pre"]["bias"])
    for index in range(p["blocks"]["ln_1"]["scale"].shape[0]):
        lp = layer(p["blocks"], index)
        x = _attn_residual_q(x, lp["ln_1"], lp["attn"], v.heads)
        y = layer_norm(x, lp["ln_2"]["scale"], lp["ln_2"]["bias"])
        mlp = lp["mlp"]
        y = act(int8_linear(y, mlp["w_fc"]["q"], mlp["w_fc"]["s"], mlp["b_fc"], out_dtype=bf16))
        x = x + int8_linear(y, mlp["w_proj"]["q"], mlp["w_proj"]["s"], mlp["b_proj"],
                            out_dtype=bf16)
    x = layer_norm(x[:, 0, :], p["ln_post"]["scale"], p["ln_post"]["bias"])
    feats = int8_linear(x, p["proj"]["q"], p["proj"]["s"], out_dtype=bf16)
    return _l2_normalize(feats) if normalize else feats
