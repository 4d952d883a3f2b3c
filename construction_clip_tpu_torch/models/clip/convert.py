"""Checkpoint converters (counterpart of construction_clip_tpu/models/clip/
convert.py): OpenAI `clip` and HF `CLIPModel` state dicts -> the port's numpy
tree, ready for `convert.to_params`.

Both naming schemes of the .pt files that users bring are read:

  OpenAI: visual.conv1.weight, visual.transformer.resblocks.{i}.attn.in_proj_weight, ...
  HF:     vision_model.encoder.layers.{i}.self_attn.q_proj.weight, ...

The tree is the JAX package's layout (`convert.init_clip`): weights input-major
([in, out], y = x @ W), per-layer params stacked along a leading L axis. The
leaves are numpy arrays in the checkpoint's dtype, made on the host.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from construction_clip_tpu_torch.core.configs import CLIPConfig, TextConfig, VisionConfig
from construction_clip_tpu_torch.core.params import stack_trees


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _ln(sd, prefix):
    return {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}


def _conv_to_patch_embed(w):
    """torch conv kernel [width, C, p, p] -> [C*p*p, width], as models/clip's patchify."""
    w = _np(w)
    return np.ascontiguousarray(w.reshape(w.shape[0], -1).T)


def _t(x) -> np.ndarray:
    """torch Linear [out, in] -> [in, out]."""
    return np.ascontiguousarray(_np(x).T)


def config_from_openai_state_dict(sd: Mapping) -> CLIPConfig:
    """The architecture of an OpenAI-format state dict (ViT variants only)."""
    width = _np(sd["visual.conv1.weight"]).shape[0]
    patch = _np(sd["visual.conv1.weight"]).shape[-1]
    n_pos = _np(sd["visual.positional_embedding"]).shape[0]
    image_size = patch * int(round((n_pos - 1) ** 0.5))
    v_layers = len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")})
    t_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    embed_dim = _np(sd["text_projection"]).shape[1]
    t_width = _np(sd["token_embedding.weight"]).shape[1]
    vocab = _np(sd["token_embedding.weight"]).shape[0]
    ctx = _np(sd["positional_embedding"]).shape[0]
    return CLIPConfig(
        vision=VisionConfig(image_size=image_size, patch_size=patch, width=width,
                            layers=v_layers, heads=width // 64, embed_dim=embed_dim),
        text=TextConfig(vocab_size=vocab, context_length=ctx, width=t_width,
                        layers=t_layers, heads=t_width // 64, embed_dim=embed_dim))


def _openai_block(sd, prefix):
    return {
        "ln_1": _ln(sd, prefix + ".ln_1"),
        "attn": {"w_qkv": _t(sd[prefix + ".attn.in_proj_weight"]),
                 "b_qkv": _np(sd[prefix + ".attn.in_proj_bias"]),
                 "w_out": _t(sd[prefix + ".attn.out_proj.weight"]),
                 "b_out": _np(sd[prefix + ".attn.out_proj.bias"])},
        "ln_2": _ln(sd, prefix + ".ln_2"),
        "mlp": {"w_fc": _t(sd[prefix + ".mlp.c_fc.weight"]),
                "b_fc": _np(sd[prefix + ".mlp.c_fc.bias"]),
                "w_proj": _t(sd[prefix + ".mlp.c_proj.weight"]),
                "b_proj": _np(sd[prefix + ".mlp.c_proj.bias"])},
    }


def from_openai_state_dict(sd: Mapping, cfg: CLIPConfig | None = None):
    """-> (tree, cfg); cfg is read from the state dict when not given."""
    if cfg is None:
        cfg = config_from_openai_state_dict(sd)
    v, t = cfg.vision, cfg.text
    vision = {
        "patch_embed": _conv_to_patch_embed(sd["visual.conv1.weight"]),
        "class_emb": _np(sd["visual.class_embedding"]),
        "pos_emb": _np(sd["visual.positional_embedding"]),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": stack_trees([_openai_block(sd, f"visual.transformer.resblocks.{i}")
                               for i in range(v.layers)]),
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _np(sd["visual.proj"]),   # already [width, embed]
    }
    text = {
        "tok_emb": _np(sd["token_embedding.weight"]),
        "pos_emb": _np(sd["positional_embedding"]),
        "blocks": stack_trees([_openai_block(sd, f"transformer.resblocks.{i}")
                               for i in range(t.layers)]),
        "ln_final": _ln(sd, "ln_final"),
        "proj": _np(sd["text_projection"]),   # already [width, embed]
    }
    tree = {"vision": vision, "text": text,
            "logit_scale": np.asarray(float(_np(sd["logit_scale"])), np.float32)}
    return tree, cfg


def _hf_block(sd, prefix):
    q, k, v = (prefix + f".self_attn.{n}_proj" for n in "qkv")
    return {
        "ln_1": _ln(sd, prefix + ".layer_norm1"),
        "attn": {"w_qkv": np.concatenate([_t(sd[n + ".weight"]) for n in (q, k, v)], axis=1),
                 "b_qkv": np.concatenate([_np(sd[n + ".bias"]) for n in (q, k, v)]),
                 "w_out": _t(sd[prefix + ".self_attn.out_proj.weight"]),
                 "b_out": _np(sd[prefix + ".self_attn.out_proj.bias"])},
        "ln_2": _ln(sd, prefix + ".layer_norm2"),
        "mlp": {"w_fc": _t(sd[prefix + ".mlp.fc1.weight"]),
                "b_fc": _np(sd[prefix + ".mlp.fc1.bias"]),
                "w_proj": _t(sd[prefix + ".mlp.fc2.weight"]),
                "b_proj": _np(sd[prefix + ".mlp.fc2.bias"])},
    }


def from_hf_state_dict(sd: Mapping, cfg: CLIPConfig):
    """A HF transformers CLIPModel state dict (quick_gelu checkpoints) -> tree."""
    v, t = cfg.vision, cfg.text
    # HF spells it "pre_layrnorm" (sic)
    pre_ln = "vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd \
        else "vision_model.pre_layernorm"
    vision = {
        "patch_embed": _conv_to_patch_embed(sd["vision_model.embeddings.patch_embedding.weight"]),
        "class_emb": _np(sd["vision_model.embeddings.class_embedding"]).reshape(-1),
        "pos_emb": _np(sd["vision_model.embeddings.position_embedding.weight"]),
        "ln_pre": _ln(sd, pre_ln),
        "blocks": stack_trees([_hf_block(sd, f"vision_model.encoder.layers.{i}")
                               for i in range(v.layers)]),
        "ln_post": _ln(sd, "vision_model.post_layernorm"),
        "proj": _t(sd["visual_projection.weight"]),
    }
    text = {
        "tok_emb": _np(sd["text_model.embeddings.token_embedding.weight"]),
        "pos_emb": _np(sd["text_model.embeddings.position_embedding.weight"]),
        "blocks": stack_trees([_hf_block(sd, f"text_model.encoder.layers.{i}")
                               for i in range(t.layers)]),
        "ln_final": _ln(sd, "text_model.final_layer_norm"),
        "proj": _t(sd["text_projection.weight"]),
    }
    return {"vision": vision, "text": text,
            "logit_scale": np.asarray(float(_np(sd["logit_scale"])), np.float32)}


def load_torch_checkpoint(path: str, *, allow_pickle: bool = False) -> dict:
    """A .pt state dict (a plain state_dict, or an OpenAI JIT archive) as numpy.

    Plain state dicts load with weights_only=True (no code from the file runs).
    JIT archives and pickled Modules need full unpickling, which runs code from
    the file: that path is refused unless `allow_pickle` or the environment's
    CCTPU_UNSAFE_PICKLE=1 says the file is trusted.
    """
    import os
    import pickle

    import torch

    allow_pickle = allow_pickle or os.environ.get("CCTPU_UNSAFE_PICKLE") == "1"
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError):
        # only an unpickling failure means "needs full pickle"; an IO error
        # propagates as itself
        if not allow_pickle:
            raise ValueError(
                f"{path} is not a plain state_dict; loading it requires full pickle "
                "execution (arbitrary code from the file). Set CCTPU_UNSAFE_PICKLE=1 "
                "if you trust this checkpoint.")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: _np(v) for k, v in obj.items()}
