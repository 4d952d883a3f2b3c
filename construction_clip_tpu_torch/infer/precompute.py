"""Image embedding + zero-shot classification in one call, and the corpus
precompute built on it, the parse_coco.py equivalent (counterpart of
construction_clip_tpu/infer/precompute.py): every annotation's image through
the image tower, its caption type and violation type classified against the
label prompts, and an archive of {embeddings, attributes, captions} that the
ClipCap training reads.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.data.labels import (
    CAPTION_TYPE_PROMPTS, VIOLATION_TYPES, attribute_string)
from construction_clip_tpu_torch.data.pipeline import default_load_image, host_shape_unify
from construction_clip_tpu_torch.data.preprocess import preprocess_batch
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


def precompute_corpus(params, cfg: CLIPConfig, annotations, tokenizer, *,
                      image_root: str = "", batch_size: int = 64,
                      load_image: Optional[Callable] = None,
                      preprocess: Optional[Callable] = None,
                      policy: Policy = DEFAULT_POLICY,
                      out_path: Optional[str] = None):
    """annotations: list[Annotation]. Returns a dict with embeddings [N, E]
    fp32, attributes [N] str and captions [N] str, and saves it as .npz when
    `out_path` is given. Images are read by `load_image(path)` (PIL by default),
    unified to 256x256 uint8 on the host, and turned into model inputs by
    `preprocess(u8)` (preprocess_batch on the params' device by default). An
    image that cannot be read is skipped, as the reference does. An annotation
    with an empty caption takes its violation_list (reference ClipCocoDataset,
    CLIP_prefix_caption/train.py:85-86)."""
    params = as_tree(params)
    device = params["text"]["tok_emb"].device
    load_image = load_image or default_load_image
    preprocess = preprocess or (
        lambda u8: preprocess_batch(u8, cfg.vision.image_size, device=device))

    ct_tokens = tokenizer.tokenize(list(CAPTION_TYPE_PROMPTS), cfg.text.context_length)
    vt_tokens = tokenizer.tokenize(list(VIOLATION_TYPES), cfg.text.context_length)
    fn = make_embed_classify_fn(params, cfg, ct_tokens, vt_tokens, policy=policy)

    embs, attrs, caps = [], [], []
    batch_imgs, kept = [], []

    def flush():
        if not batch_imgs:
            return
        emb, ct, vt = fn(preprocess(np.stack(batch_imgs)))
        embs.append(emb.float().cpu().numpy())
        for a, c, v in zip(kept, ct.tolist(), vt.tolist()):
            attrs.append(attribute_string(CAPTION_TYPE_PROMPTS[c], VIOLATION_TYPES[v]))
            caps.append(a.caption if a.caption else a.violation_list)
        batch_imgs.clear()
        kept.clear()

    for a in annotations:
        try:
            img = load_image(os.path.join(image_root, a.file_name))
        except (FileNotFoundError, OSError) as e:   # the reference's skip-on-error
            print(f"skip {a.file_name}: {e}")
            continue
        batch_imgs.append(host_shape_unify(img, 256))
        kept.append(a)
        if len(batch_imgs) == batch_size:
            flush()
    flush()

    out = {
        "embeddings": (np.concatenate(embs) if embs
                       else np.zeros((0, cfg.text.embed_dim), np.float32)),
        "attributes": np.asarray(attrs, dtype=object),
        "captions": np.asarray(caps, dtype=object),
    }
    if out_path:
        np.savez(out_path, embeddings=out["embeddings"], attributes=np.asarray(attrs),
                 captions=np.asarray(caps))
    return out


def load_reference_pickle(path: str) -> dict:
    """The reference's parse_coco pickle ({"clip_embedding": Tensor [N, 512],
    "captions": [annotation + {clip_embedding: idx, attribute: str}]},
    reference parse_coco.py:55-65) as the archive dict precompute_corpus
    returns."""
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f)
    emb = data.get("clip_embedding", data.get("clip_embeddings"))
    if hasattr(emb, "detach"):
        emb = emb.detach().cpu().numpy()
    captions, attrs = [], []
    for ann in data["captions"]:
        captions.append(ann.get("caption") or ann.get("violation_list") or "")
        attrs.append(ann.get("attribute", ""))
    return {"embeddings": np.asarray(emb, dtype=np.float32),
            "attributes": np.asarray(attrs, dtype=object),
            "captions": np.asarray(captions, dtype=object)}


def load_archive(path: str) -> dict:
    """Either the .npz precompute_corpus writes or the reference's .pkl."""
    if path.endswith(".pkl"):
        return load_reference_pickle(path)
    return dict(np.load(path, allow_pickle=True))
