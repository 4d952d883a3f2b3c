"""Parameters for the port.

`to_params` turns a JAX package parameter tree (from `init_clip`, `init_clipcap`
or `init_gpt2`, or a checkpoint) into a ParamTree. The port keeps the JAX layout,
so this is a plain copy of each leaf; leaves may be numpy arrays or anything
`np.asarray` takes (a JAX array included, without this module importing jax).

`init_clip`, `init_gpt2` and `init_clipcap` build random trees at the JAX
initialisers' shapes and scales from a numpy seed, for machines without JAX.
They draw other numbers than jax.random: for parity with the JAX package, make
the tree there and copy it with `to_params`.
"""

from __future__ import annotations

import numpy as np
import torch

from construction_clip_tpu_torch.core.configs import CLIPConfig, ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.params import ParamTree, tree_map


def to_params(tree, *, dtype=None, device=None, trainable: bool = False) -> ParamTree:
    """A nested dict of arrays -> ParamTree (floating leaves cast to `dtype` when
    given), on `device`; `trainable` leaves require grad (serving keeps them
    frozen)."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t

    return ParamTree(tree_map(leaf, tree), trainable=trainable)


def _normal(rng, shape, std, dtype):
    return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std)).astype(dtype)


def _ln(width, dtype):
    return {"scale": np.ones((width,), dtype), "bias": np.zeros((width,), dtype)}


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def _block(rng, width, mlp_ratio, dtype):
    hidden = int(width * mlp_ratio)
    std = width ** -0.5
    return {
        "ln_1": _ln(width, dtype),
        "attn": {"w_qkv": _normal(rng, (width, 3 * width), std, dtype),
                 "b_qkv": np.zeros((3 * width,), dtype),
                 "w_out": _normal(rng, (width, width), std, dtype),
                 "b_out": np.zeros((width,), dtype)},
        "ln_2": _ln(width, dtype),
        "mlp": {"w_fc": _normal(rng, (width, hidden), std, dtype),
                "b_fc": np.zeros((hidden,), dtype),
                "w_proj": _normal(rng, (hidden, width), hidden ** -0.5, dtype),
                "b_proj": np.zeros((width,), dtype)},
    }


def _stack_init(rng, layers, width, mlp_ratio=4.0, dtype=np.float32):
    return _stack([_block(rng, width, mlp_ratio, dtype) for _ in range(layers)])


def init_clip(seed: int, cfg: CLIPConfig, dtype=np.float32) -> dict:
    """Numpy tree at construction_clip_tpu.models.clip.init_clip's shapes/scales."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    vs = v.width ** -0.5
    vision = {
        "patch_embed": _normal(rng, (3 * v.patch_size * v.patch_size, v.width), vs, dtype),
        "class_emb": _normal(rng, (v.width,), vs, dtype),
        "pos_emb": _normal(rng, (v.seq_len, v.width), vs, dtype),
        "ln_pre": _ln(v.width, dtype),
        "blocks": _stack_init(rng, v.layers, v.width, dtype=dtype),
        "ln_post": _ln(v.width, dtype),
        "proj": _normal(rng, (v.width, v.embed_dim), vs, dtype),
    }
    text = {
        "tok_emb": _normal(rng, (t.vocab_size, t.width), 0.02, dtype),
        "pos_emb": _normal(rng, (t.context_length, t.width), 0.01, dtype),
        "blocks": _stack_init(rng, t.layers, t.width, dtype=dtype),
        "ln_final": _ln(t.width, dtype),
        "proj": _normal(rng, (t.width, t.embed_dim), t.width ** -0.5, dtype),
    }
    return {"vision": vision, "text": text,
            "logit_scale": np.asarray(cfg.logit_scale_init, np.float32)}


def init_gpt2(seed: int, cfg: GPT2Config, dtype=np.float32) -> dict:
    """Numpy tree at construction_clip_tpu.models.gpt2.init_gpt2's shapes/scales."""
    rng = np.random.default_rng(seed)
    d, h = cfg.n_embd, 4 * cfg.n_embd

    def block():
        return {
            "ln_1": _ln(d, dtype),
            "attn": {"c_attn_w": _normal(rng, (d, 3 * d), 0.02, dtype),
                     "c_attn_b": np.zeros((3 * d,), dtype),
                     "c_proj_w": _normal(rng, (d, d), 0.02, dtype),
                     "c_proj_b": np.zeros((d,), dtype)},
            "ln_2": _ln(d, dtype),
            "mlp": {"c_fc_w": _normal(rng, (d, h), 0.02, dtype),
                    "c_fc_b": np.zeros((h,), dtype),
                    "c_proj_w": _normal(rng, (h, d), 0.02, dtype),
                    "c_proj_b": np.zeros((d,), dtype)},
        }

    return {
        "wte": _normal(rng, (cfg.vocab_size, d), 0.02, dtype),
        "wpe": _normal(rng, (cfg.n_positions, d), 0.01, dtype),
        "blocks": _stack([block() for _ in range(cfg.n_layer)]),
        "ln_f": _ln(d, dtype),
    }


def init_mapper(seed: int, ccfg: ClipCapConfig, gcfg: GPT2Config, dtype=np.float32) -> dict:
    """The MLP mapper at construction_clip_tpu.models.clipcap.init_mapper's
    shapes/scales."""
    if ccfg.mapper != "mlp":
        raise NotImplementedError(f"mapper {ccfg.mapper!r} is not ported yet (only 'mlp')")
    rng = np.random.default_rng(seed)
    hidden = (gcfg.n_embd * ccfg.prefix_length) // 2
    out = gcfg.n_embd * ccfg.prefix_length
    return {"w1": _normal(rng, (ccfg.clip_dim, hidden), ccfg.clip_dim ** -0.5, dtype),
            "b1": np.zeros((hidden,), dtype),
            "w2": _normal(rng, (hidden, out), hidden ** -0.5, dtype),
            "b2": np.zeros((out,), dtype)}


def init_clipcap(seed: int, ccfg: ClipCapConfig, gcfg: GPT2Config, dtype=np.float32,
                 gpt_params=None) -> dict:
    """{"mapper", "gpt"} as construction_clip_tpu.models.clipcap.init_clipcap."""
    return {"mapper": init_mapper(seed, ccfg, gcfg, dtype),
            "gpt": gpt_params if gpt_params is not None else init_gpt2(seed + 1, gcfg, dtype)}
