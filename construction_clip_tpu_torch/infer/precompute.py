"""Image embedding + zero-shot classification in one call (counterpart of
construction_clip_tpu/infer/precompute.py:make_embed_classify_fn)."""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text
from construction_clip_tpu_torch.models.clip.quant import encode_image_int8, is_quantized_clip


def make_embed_classify_fn(params, cfg: CLIPConfig, ct_tokens, vt_tokens, *,
                           policy: Policy = DEFAULT_POLICY):
    """images -> (embeddings [B, E], caption_type idx [B], violation_type idx [B]).

    The label features (caption-type and violation-type prompts through the causal
    text tower, under the policy) are computed once, here, on the params' device.
    An int8-serving tree (models/clip/quant.quantize_clip) is detected by its
    structure and its image tower runs encode_image_int8 (bf16 features)."""
    device = params["text"]["tok_emb"].device
    with torch.inference_mode():
        ct_feats = encode_text(params, cfg, torch.as_tensor(ct_tokens, device=device),
                               policy=policy, normalize=True)
        vt_feats = encode_text(params, cfg, torch.as_tensor(vt_tokens, device=device),
                               policy=policy, normalize=True)

    quantized = is_quantized_clip(params)

    @torch.inference_mode()
    def embed_classify(images):
        if quantized:
            emb = encode_image_int8(params, cfg, images, normalize=False)
        else:
            emb = encode_image(params, cfg, images, policy=policy, normalize=False)
        normed = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        # the product promotes as jnp's does: bf16 features times fp32 labels in fp32
        normed = normed.to(torch.promote_types(normed.dtype, ct_feats.dtype))
        ct = (normed @ ct_feats.T).argmax(dim=-1)
        vt = (normed @ vt_feats.T).argmax(dim=-1)
        return emb, ct, vt

    return embed_classify
