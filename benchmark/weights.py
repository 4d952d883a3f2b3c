"""Seeded CLIP parameters and inputs, made on the device.

The benchmark makes every input itself and hands the same to the program and
to the reference: the weights (the JAX package's init_clip shapes and scales,
in its stacked-layer layout), staged uint8 images and token ids. All of it is
drawn from one `torch.Generator` on the device, the weights' normal draws in
one call, so a seed gives the same numbers on every run and set-up stays short.
"""

from __future__ import annotations

import torch

# generator streams drawn from one seed
WEIGHTS, LABELS, IMAGES, TOKENS = range(4)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 4) + stream)
    return g


def _block_leaves(prefix, layers: int, width: int):
    hidden = 4 * width
    s = width ** -0.5
    return [
        (prefix + ("ln_1", "scale"), (layers, width), ("ones",)),
        (prefix + ("ln_1", "bias"), (layers, width), ("zeros",)),
        (prefix + ("attn", "w_qkv"), (layers, width, 3 * width), ("normal", s)),
        (prefix + ("attn", "b_qkv"), (layers, 3 * width), ("zeros",)),
        (prefix + ("attn", "w_out"), (layers, width, width), ("normal", s)),
        (prefix + ("attn", "b_out"), (layers, width), ("zeros",)),
        (prefix + ("ln_2", "scale"), (layers, width), ("ones",)),
        (prefix + ("ln_2", "bias"), (layers, width), ("zeros",)),
        (prefix + ("mlp", "w_fc"), (layers, width, hidden), ("normal", s)),
        (prefix + ("mlp", "b_fc"), (layers, hidden), ("zeros",)),
        (prefix + ("mlp", "w_proj"), (layers, hidden, width), ("normal", hidden ** -0.5)),
        (prefix + ("mlp", "b_proj"), (layers, width), ("zeros",)),
    ]


def clip_leaves(cfg: dict) -> list:
    """(path, shape, init) of every leaf of the CLIP tree, in a fixed order."""
    v, t = cfg["vision"], cfg["text"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    vs = v["width"] ** -0.5
    return [
        (("vision", "patch_embed"), (3 * v["patch_size"] ** 2, v["width"]), ("normal", vs)),
        (("vision", "class_emb"), (v["width"],), ("normal", vs)),
        (("vision", "pos_emb"), (seq, v["width"]), ("normal", vs)),
        (("vision", "ln_pre", "scale"), (v["width"],), ("ones",)),
        (("vision", "ln_pre", "bias"), (v["width"],), ("zeros",)),
        *_block_leaves(("vision", "blocks"), v["layers"], v["width"]),
        (("vision", "ln_post", "scale"), (v["width"],), ("ones",)),
        (("vision", "ln_post", "bias"), (v["width"],), ("zeros",)),
        (("vision", "proj"), (v["width"], v["embed_dim"]), ("normal", vs)),
        (("text", "tok_emb"), (t["vocab_size"], t["width"]), ("normal", 0.02)),
        (("text", "pos_emb"), (t["context_length"], t["width"]), ("normal", 0.01)),
        *_block_leaves(("text", "blocks"), t["layers"], t["width"]),
        (("text", "ln_final", "scale"), (t["width"],), ("ones",)),
        (("text", "ln_final", "bias"), (t["width"],), ("zeros",)),
        (("text", "proj"), (t["width"], t["embed_dim"]), ("normal", t["width"] ** -0.5)),
        (("logit_scale",), (), ("const", cfg["logit_scale_init"])),
    ]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def clip_params(cfg: dict, seed: int, device) -> dict:
    """The nested dict of fp32 tensors on `device` for `seed`."""
    leaves = clip_leaves(cfg)
    total = sum(_numel(shape) for _, shape, init in leaves if init[0] == "normal")
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device), device=device)
    tree, offset = {}, 0
    for path, shape, init in leaves:
        if init[0] == "normal":
            n = _numel(shape)
            leaf = flat[offset: offset + n].view(shape) * init[1]
            offset += n
        elif init[0] == "ones":
            leaf = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            leaf = torch.zeros(shape, device=device)
        else:
            leaf = torch.full(shape, float(init[1]), device=device)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaf_items(tree, prefix=()):
    """(dotted path, tensor) of every leaf of a nested dict, in key order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaf_items(value, prefix + (key,))
        else:
            yield ".".join(prefix + (key,)), value


def units(tree):
    """(name, tensor) of the parts whose norms the training check compares:
    each leaf, a stacked leaf layer by layer, and the fused q, k, v
    projection's weight and bias split into their three parts (a key's bias
    has no gradient under softmax, and is left out of the change by the
    check's rule on the reference's gradient)."""
    for name, leaf in leaf_items(tree):
        layers = [(f"{name}[{i}]", leaf[i]) for i in range(leaf.shape[0])] \
            if ".blocks." in name else [(name, leaf)]
        for lname, part in layers:
            if name.endswith(("w_qkv", "b_qkv")):
                for tag, third in zip("qkv", part.chunk(3, dim=-1)):
                    yield f"{lname}.{tag}", third
            else:
                yield lname, part


def images_u8(n: int, size: int, g: torch.Generator, device) -> torch.Tensor:
    """[n, size, size, 3] uint8 noise."""
    return torch.randint(0, 256, (n, size, size, 3), generator=g, device=device,
                         dtype=torch.uint8)


def token_ids(n: int, context: int, vocab: int, eot_range, g: torch.Generator,
              device) -> torch.Tensor:
    """[n, context] int32 CLIP-style ids: SOT (vocab - 2) first, ids below it,
    EOT (vocab - 1, the largest id, where the text tower reads its feature) at
    a position drawn in eot_range (inclusive), zeros after."""
    lo, hi = eot_range
    eot = torch.randint(lo, hi + 1, (n, 1), generator=g, device=device)
    ids = torch.randint(1, vocab - 2, (n, context), generator=g, device=device)
    pos = torch.arange(context, device=device)[None, :]
    ids = torch.where(pos < eot, ids, torch.zeros_like(ids))
    ids = torch.where(pos == eot, torch.full_like(ids, vocab - 1), ids)
    ids[:, 0] = vocab - 2
    return ids.to(torch.int32)
