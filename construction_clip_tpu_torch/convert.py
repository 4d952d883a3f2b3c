"""Parameters for the port.

`to_params` turns a JAX package parameter tree (from `init_clip`, `init_clipcap`,
`init_gpt2`, `init_t5` or `init_clipcap_t5`, or a checkpoint) into a ParamTree.
The port keeps the JAX layout, so this is a plain copy of each leaf; leaves may
be numpy arrays or anything `np.asarray` takes (a JAX array included, without
this module importing jax). A quantized leaf {"q": int8, "s": scale} (the T5
head of `quantize_t5_head`) keeps its int8 table and fp32 scale whatever
`dtype` asks. A bfloat16 leaf (the `ml_dtypes` arrays that `np.array` makes
of a JAX bf16 array, as in a tree of the JAX package's quantizers) is carried
bit for bit through a uint16 view.

For int8 serving, convert the full-precision tree and quantize it in the port
(models/clip/quant.quantize_clip, models/gpt2.quantize_gpt2), which gives the
JAX quantizers' bits on the same weights.

The detector's tree is the exception: `to_detector_params` permutes its
convolutions from the JAX tree's HWIO to OIHW (channels-last) once, when the
weights are carried across, and `from_detector_params` permutes them back.

`init_clip`, `init_gpt2`, `init_clipcap`, `init_t5`, `init_clipcap_t5`,
`init_fasterrcnn`, `init_resnet50` and `init_lstm_captioner` build random
trees at the JAX initialisers' shapes and scales from a numpy seed, for
machines without JAX.
They draw other numbers than jax.random: for parity with the JAX package, make
the tree there and copy it with `to_params`. Given `SHAPES` for the seed, they
draw nothing and return the tree's shapes and dtypes alone (zero-stride views
of one zero), the template that `train/checkpoint.load_params_npz` checks a
file against.
"""

from __future__ import annotations

import numpy as np
import torch

from construction_clip_tpu_torch.core.configs import (
    CLIPConfig, ClipCapConfig, GPT2Config, T5Config)
from construction_clip_tpu_torch.core.params import ParamTree


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "s"} and \
        np.asarray(node["q"]).dtype == np.int8


def _tensor(a, cast, device):
    """One leaf as a tensor of its own (bf16 through a uint16 view), floating
    leaves cast to `cast` where given, on `device`."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if cast is not None and t.is_floating_point():
        t = t.to(cast)
    return t.to(device) if device is not None else t


def to_params(tree, *, dtype=None, device=None, trainable: bool = False) -> ParamTree:
    """A nested dict of arrays -> ParamTree (floating leaves cast to `dtype` when
    given, except a quantized leaf's fp32 scale), on `device`; `trainable`
    leaves require grad (serving keeps them frozen)."""
    def convert(node, cast):
        if isinstance(node, dict):
            cast = None if _is_quantized(node) else cast
            return {k: convert(v, cast) for k, v in node.items()}
        return _tensor(node, cast, device)

    return ParamTree(convert(tree, dtype), trainable=trainable)


class _Shapes:
    """The seed that asks an init_* for its tree's shapes alone (`SHAPES`)."""

    def __add__(self, other):   # init_clipcap seeds GPT-2 with seed + 1
        return self


SHAPES = _Shapes()


def _rng(seed):
    return seed if isinstance(seed, _Shapes) else np.random.default_rng(seed)


def _normal(rng, shape, std, dtype):
    if isinstance(rng, _Shapes):
        return np.broadcast_to(np.zeros((), dtype), shape)
    return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std)).astype(dtype)


def _ln(width, dtype):
    return {"scale": np.ones((width,), dtype), "bias": np.zeros((width,), dtype)}


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    if blocks[0].ndim and not any(blocks[0].strides):   # SHAPES' views stay views
        return np.broadcast_to(blocks[0], (len(blocks),) + blocks[0].shape)
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
    rng = _rng(seed)
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
    rng = _rng(seed)
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
    """The MLP or transformer mapper (ccfg.mapper) at
    construction_clip_tpu.models.clipcap.init_mapper's shapes/scales."""
    rng = _rng(seed)
    d = gcfg.n_embd
    if ccfg.mapper == "mlp":
        hidden = (d * ccfg.prefix_length) // 2
        out = d * ccfg.prefix_length
        return {"w1": _normal(rng, (ccfg.clip_dim, hidden), ccfg.clip_dim ** -0.5, dtype),
                "b1": np.zeros((hidden,), dtype),
                "w2": _normal(rng, (hidden, out), hidden ** -0.5, dtype),
                "b2": np.zeros((out,), dtype)}
    if ccfg.mapper == "transformer":
        return {"proj": _normal(rng, (ccfg.clip_dim, ccfg.clip_length * d),
                                ccfg.clip_dim ** -0.5, dtype),
                "proj_b": np.zeros((ccfg.clip_length * d,), dtype),
                "prefix_const": _normal(rng, (ccfg.prefix_length, d), 0.02, dtype),
                "blocks": _stack_init(rng, ccfg.mapper_layers, d, mlp_ratio=2.0, dtype=dtype)}
    raise ValueError(f"unknown mapper {ccfg.mapper!r}")


def init_clipcap(seed: int, ccfg: ClipCapConfig, gcfg: GPT2Config, dtype=np.float32,
                 gpt_params=None) -> dict:
    """{"mapper", "gpt"} as construction_clip_tpu.models.clipcap.init_clipcap."""
    return {"mapper": init_mapper(seed, ccfg, gcfg, dtype),
            "gpt": gpt_params if gpt_params is not None else init_gpt2(seed + 1, gcfg, dtype)}


def init_t5(seed: int, cfg: T5Config, dtype=np.float32) -> dict:
    """Numpy tree at construction_clip_tpu.models.t5.init_t5's shapes/scales."""
    rng = _rng(seed)
    d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv

    def attn():
        return {"q": _normal(rng, (d, inner), (d * cfg.d_kv) ** -0.5, dtype),
                "k": _normal(rng, (d, inner), d ** -0.5, dtype),
                "v": _normal(rng, (d, inner), d ** -0.5, dtype),
                "o": _normal(rng, (inner, d), inner ** -0.5, dtype)}

    def ffn():
        return {"wi_0": _normal(rng, (d, cfg.d_ff), d ** -0.5, dtype),
                "wi_1": _normal(rng, (d, cfg.d_ff), d ** -0.5, dtype),
                "wo": _normal(rng, (cfg.d_ff, d), cfg.d_ff ** -0.5, dtype)}

    def ones():
        return np.ones((d,), dtype)

    buckets = cfg.relative_attention_num_buckets
    return {
        "shared": _normal(rng, (cfg.vocab_size, d), 1.0, dtype),
        "enc_rel_emb": _normal(rng, (buckets, cfg.num_heads), 1.0, dtype),
        "dec_rel_emb": _normal(rng, (buckets, cfg.num_heads), 1.0, dtype),
        "encoder": _stack([{"ln_attn": ones(), "attn": attn(), "ln_ffn": ones(), "ffn": ffn()}
                           for _ in range(cfg.num_layers)]),
        "enc_final_ln": ones(),
        "decoder": _stack([{"ln_self": ones(), "self_attn": attn(), "ln_cross": ones(),
                            "cross_attn": attn(), "ln_ffn": ones(), "ffn": ffn()}
                           for _ in range(cfg.num_decoder_layers)]),
        "dec_final_ln": ones(),
        "lm_head": _normal(rng, (d, cfg.vocab_size), d ** -0.5, dtype),
    }


def init_clipcap_t5(seed: int, ccfg: ClipCapConfig, tcfg: T5Config, dtype=np.float32,
                    t5_params=None) -> dict:
    """{"mapper", "t5"} as construction_clip_tpu.models.clipcap.t5_model.init_clipcap_t5
    (the mapper sized by the T5 width)."""
    from construction_clip_tpu_torch.models.clipcap.t5_model import mapper_shape

    return {"mapper": init_mapper(seed, ccfg, mapper_shape(tcfg), dtype),
            "t5": t5_params if t5_params is not None else init_t5(seed + 1, tcfg, dtype)}


# ---- the Faster R-CNN detector (models/detection.py) ---------------------------------

def init_resnet50(seed, dtype=np.float32) -> dict:
    """Numpy tree at construction_clip_tpu.models.resnet.init_resnet50's
    shapes and scales (HWIO convolutions, He-normal; BatchNorm as identity
    scale/shift)."""
    from construction_clip_tpu_torch.models.resnet import STAGES, WIDTHS

    rng = _rng(seed)

    def conv(h, w, i, o):
        return _normal(rng, (h, w, i, o), (2.0 / (h * w * i)) ** 0.5, dtype)

    def bn(c):
        return {"scale": np.ones((c,), dtype), "shift": np.zeros((c,), dtype)}

    stages, c_in = [], 64
    for n, width in zip(STAGES, WIDTHS):
        blocks = []
        for _ in range(n):
            p = {"conv1": conv(1, 1, c_in, width), "bn1": bn(width),
                 "conv2": conv(3, 3, width, width), "bn2": bn(width),
                 "conv3": conv(1, 1, width, width * 4), "bn3": bn(width * 4)}
            if c_in != width * 4:
                p["downsample"] = {"conv": conv(1, 1, c_in, width * 4), "bn": bn(width * 4)}
            blocks.append(p)
            c_in = width * 4
        stages.append(blocks)
    return {"stem": {"conv": conv(7, 7, 3, 64), "bn": bn(64)}, "stages": stages}


def init_fasterrcnn(seed, *, num_classes: int = 8, fpn_channels: int = 256,
                    dtype=np.float32) -> dict:
    """Numpy tree at construction_clip_tpu.models.detection.init_fasterrcnn's
    shapes and scales (the JAX layout: HWIO convolutions, [in, out] linears;
    lists for the stages and the FPN's levels)."""
    from construction_clip_tpu_torch.models.detection import ASPECT_RATIOS
    from construction_clip_tpu_torch.models.resnet import WIDTHS

    rng = _rng(seed)
    backbone = init_resnet50(rng, dtype)   # default_rng passes a Generator through

    def lin(i, o, std=0.01):
        return {"w": _normal(rng, (i, o), std, dtype), "b": np.zeros((o,), dtype)}

    def conv3(i, o):
        return {"w": _normal(rng, (3, 3, i, o), 0.01, dtype), "b": np.zeros((o,), dtype)}

    a = len(ASPECT_RATIOS)
    return {
        "backbone": backbone,
        "fpn": {"inner": [lin(w * 4, fpn_channels) for w in WIDTHS],
                "layer": [conv3(fpn_channels, fpn_channels) for _ in WIDTHS]},
        "rpn": {"conv": conv3(fpn_channels, fpn_channels),
                "cls": lin(fpn_channels, a), "bbox": lin(fpn_channels, a * 4)},
        "box_head": {"fc6": lin(fpn_channels * 7 * 7, 1024), "fc7": lin(1024, 1024),
                     "cls_score": lin(1024, num_classes),
                     "bbox_pred": lin(1024, num_classes * 4)},
    }


def to_detector_params(tree, *, dtype=None, device=None, trainable: bool = False) -> dict:
    """A detector tree in the JAX layout (`init_fasterrcnn` of either package,
    `models/detection.from_torchvision_state_dict`, leaves numpy or JAX
    arrays) -> the port's: nested dicts and lists of tensors on `device`,
    floating leaves in `dtype` where given; frozen for serving, or with
    `trainable` leaf tensors that require grad (train/detection.py trains
    every leaf, BatchNorm's scale and shift included).

    This is the one place the port transposes weights: every 4-D leaf (a
    convolution, HWIO in the JAX tree) is permuted to torch's OIHW and kept
    in channels-last memory, the layout cuDNN's NHWC kernels read forward
    and backward, once here and never per call. Linear weights stay [in,
    out]. `from_detector_params` is the inverse."""
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        t = _tensor(node, dtype, device)
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        if trainable and t.is_floating_point():
            t.requires_grad_()
        return t

    return convert(tree)


def from_detector_params(params) -> dict:
    """The port's detector tree (or a tree of its gradients) -> the JAX
    layout in numpy: 4-D leaves from OIHW back to HWIO, every other leaf as
    it is, floating leaves in fp32. `train/checkpoint.save_params_npz` of it
    writes what the JAX package's `load_params_npz` reads."""
    if isinstance(params, dict):
        return {k: from_detector_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [from_detector_params(v) for v in params]
    t = params.detach()
    t = (t.float() if t.is_floating_point() else t).cpu()
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    return np.ascontiguousarray(t.numpy())


# ---- the show-attend-tell captioner (models/lstm_captioner.py) -------------------------

def _uniform(rng, shape, bound, dtype):
    if isinstance(rng, _Shapes):
        return np.broadcast_to(np.zeros((), dtype), shape)
    return rng.uniform(-bound, bound, shape).astype(dtype)


def init_lstm_captioner(seed, *, vocab_size: int, embed_size: int = 300,
                        attention_dim: int = 256, encoder_dim: int = 2048,
                        decoder_dim: int = 512, dtype=np.float32, embeddings=None) -> dict:
    """Numpy tree at construction_clip_tpu.models.lstm_captioner.
    init_lstm_captioner's shapes and scales: torch nn.Linear's U(+-1/sqrt(in))
    for each linear's weight and bias, the LSTM's U(+-1/sqrt(decoder_dim)),
    the embedding N(0, 0.1) unless `embeddings` is given."""
    rng = _rng(seed)

    def lin(i, o):
        bound = 1.0 / i ** 0.5
        return {"w": _uniform(rng, (i, o), bound, dtype), "b": _uniform(rng, (o,), bound, dtype)}

    lstm_in, bound = embed_size + encoder_dim, 1.0 / decoder_dim ** 0.5
    return {
        "embedding": np.asarray(embeddings, dtype) if embeddings is not None else
        _normal(rng, (vocab_size, embed_size), 0.1, dtype),
        "att_W": lin(decoder_dim, attention_dim),
        "att_U": lin(encoder_dim, attention_dim),
        "att_A": lin(attention_dim, 1),
        "init_h": lin(encoder_dim, decoder_dim),
        "init_c": lin(encoder_dim, decoder_dim),
        # torch LSTMCell's gates (i, f, g, o), stored input-major: w_ih [in, 4H]
        "w_ih": _uniform(rng, (lstm_in, 4 * decoder_dim), bound, dtype),
        "b_ih": _uniform(rng, (4 * decoder_dim,), bound, dtype),
        "w_hh": _uniform(rng, (decoder_dim, 4 * decoder_dim), bound, dtype),
        "b_hh": _uniform(rng, (4 * decoder_dim,), bound, dtype),
        "fcn": lin(decoder_dim, vocab_size),
    }
