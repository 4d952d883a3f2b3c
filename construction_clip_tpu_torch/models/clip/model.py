"""OpenAI-CLIP-compatible two-tower model (counterpart of
construction_clip_tpu/models/clip/model.py), over the JAX parameter layout.

  vision: patch embed as a GEMM over unfolded patches (no bias) -> [CLS] + pos
          embed -> ln_pre -> pre-norm blocks (QuickGELU) -> ln_post on CLS -> proj.
  text:   token + pos embed -> causal pre-norm blocks -> ln_final -> features at
          the argmax token id (EOT has the largest BPE id) -> proj.
Images are NHWC. Features come out in the policy's output dtype.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.blocks import apply_stack
from construction_clip_tpu_torch.ops.activations import quick_gelu
from construction_clip_tpu_torch.ops.embedding import embedding
from construction_clip_tpu_torch.ops.norms import layer_norm


def _act(cfg: CLIPConfig):
    return quick_gelu if cfg.quick_gelu else torch.nn.functional.gelu


def patchify(images, patch_size: int):
    """[B, H, W, 3] -> [B, n_patches, 3*p*p], row-major patch order; features
    within a patch in (C, ph, pw) order, as a torch Conv2d kernel flattens."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch_size * patch_size)


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def encode_image(params, cfg: CLIPConfig, images, *, policy: Policy = DEFAULT_POLICY,
                 normalize: bool = False, return_probs: bool = False, probs_probe=None,
                 remat=False, tp=None):
    """images: [B, H, W, 3] float, already preprocessed. Returns [B, embed_dim];
    with return_probs, (features, the blocks' probabilities [L, B, H, T, T]).
    probs_probe: apply_stack's differentiation port, [L, B, H, T, T] zeros.
    remat: apply_stack's, for the image tower's blocks. tp: apply_stack's, the
    "model" line whose shard `params` is (parallel/sharding.py)."""
    v = cfg.vision
    with tracing.span("tower.image"):
        p = policy.cast_to_compute(params["vision"])
        x = patchify(images.to(policy.compute_dtype), v.patch_size)
        x = x @ p["patch_embed"]
        cls = p["class_emb"].expand(x.shape[0], 1, v.width)
        x = torch.cat([cls, x], dim=1) + p["pos_emb"]
        x = layer_norm(x, p["ln_pre"]["scale"], p["ln_pre"]["bias"])
        x = apply_stack(p["blocks"], x, n_heads=v.heads, act=_act(cfg),
                        return_probs=return_probs, probs_probe=probs_probe, remat=remat, tp=tp)
        x, probs = x if return_probs else (x, None)
        x = layer_norm(x[:, 0, :], p["ln_post"]["scale"], p["ln_post"]["bias"])
        feats = policy.cast_to_output(x @ p["proj"])
        feats = _l2_normalize(feats) if normalize else feats
    return (feats, probs) if return_probs else feats


def encode_text(params, cfg: CLIPConfig, tokens, *, policy: Policy = DEFAULT_POLICY,
                normalize: bool = False, return_probs: bool = False, probs_probe=None,
                tp=None):
    """tokens: [B, context_length] int. Returns [B, embed_dim], taken at
    argmax(tokens), the EOT position; return_probs, probs_probe and tp as in
    encode_image."""
    t = cfg.text
    p = policy.cast_to_compute(params["text"])
    tokens = tokens.long()
    x = embedding(p["tok_emb"], tokens) + p["pos_emb"][: tokens.shape[1]]
    x = apply_stack(p["blocks"], x, n_heads=t.heads, act=_act(cfg), is_causal=True,
                    return_probs=return_probs, probs_probe=probs_probe, tp=tp)
    x, probs = x if return_probs else (x, None)
    x = layer_norm(x, p["ln_final"]["scale"], p["ln_final"]["bias"])
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    feats = policy.cast_to_output(x @ p["proj"])
    feats = _l2_normalize(feats) if normalize else feats
    return (feats, probs) if return_probs else feats


def clip_forward(params, cfg: CLIPConfig, images, tokens, *, policy: Policy = DEFAULT_POLICY,
                 remat=False, tp=None):
    """(logits_per_image [B_i, B_t], logits_per_text [B_t, B_i]). remat goes to
    the image tower only, as in the JAX package; tp to both."""
    img = encode_image(params, cfg, images, policy=policy, normalize=True, remat=remat, tp=tp)
    txt = encode_text(params, cfg, tokens, policy=policy, normalize=True, tp=tp)
    logits_per_image = torch.exp(params["logit_scale"]) * img @ txt.T
    return logits_per_image, logits_per_image.T
