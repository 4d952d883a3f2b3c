"""Zero-shot classification over label prompt sets (counterpart of
construction_clip_tpu/infer/zeroshot.py): label prompt features are computed
once, and a batch of images is classified by one product with them; softmax
over exp(logit_scale) times the cosine similarities, argmax over the
probabilities.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text


@torch.inference_mode()
def label_features(params, cfg: CLIPConfig, label_tokens, *,
                   policy: Policy = DEFAULT_POLICY):
    """[n_labels, ctx] tokens (numpy or tensor) -> [n_labels, embed]
    L2-normalized features, on the params' device."""
    params = as_tree(params)
    tokens = torch.as_tensor(label_tokens, device=params["text"]["tok_emb"].device)
    return encode_text(params, cfg, tokens, policy=policy, normalize=True)


@torch.inference_mode()
def classify_batch(params, cfg: CLIPConfig, images, label_feats, *,
                   policy: Policy = DEFAULT_POLICY):
    """images [B, H, W, 3] (preprocessed) x label_feats [L, E] -> (probs [B, L]
    fp32, pred [B])."""
    params = as_tree(params)
    img = encode_image(params, cfg, images, policy=policy, normalize=True)
    logits = torch.exp(params["logit_scale"]) * img @ label_feats.T
    probs = torch.softmax(logits.float(), dim=-1)
    return probs, probs.argmax(dim=-1)


def classify(params, cfg: CLIPConfig, images, label_tokens, *,
             policy: Policy = DEFAULT_POLICY):
    feats = label_features(params, cfg, label_tokens, policy=policy)
    return classify_batch(params, cfg, images, feats, policy=policy)
