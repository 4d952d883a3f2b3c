"""Pre-norm transformer blocks over stacked layer params (counterpart of
construction_clip_tpu/models/blocks.py): LN -> fused-QKV attention -> residual,
LN -> MLP(act) -> residual. Params for L layers are stacked along a leading axis
(the JAX layout); `apply_stack` walks them in a Python loop.

The attention half takes the fused block (ops/attention_block.py, kernel K1)
exactly where the JAX package takes its Pallas block: no bias, no
`return_probs` or `probs_probe` (the explainability probes, which need the
probabilities the fused block never forms), and `supported`.
The MLP half takes the fused MLP residual (ops/mlp.py, kernel K9) where the JAX
package takes its Pallas MLP: `USE_FUSED_MLP` on, a QuickGELU block, the kernel
impl and `mlp.supported`. `USE_FUSED_MLP` is the JAX package's switch, off by
default as there; otherwise the MLP is plain PyTorch (cuBLAS GEMMs and
elementwise ops).

`apply_stack(remat=...)` rematerialises each layer in the backward, with the
JAX package's policies (construction_clip_tpu/models/blocks.py:218-231): the
policy names the block's tensors that stay saved between forward and
backward, besides each layer's input; everything else is recomputed. The
block is one chain of stages, which apply_block runs uncut and remat cuts
after each saved tensor; each piece of the cut chain is one non-reentrant
`torch.utils.checkpoint` whose inputs are the tensors saved before it. A piece that is K1 alone runs as it is: K1's
Function saves only its inputs, as the JAX block's custom_vjp does, so
nothing of it is recomputed. `create_selective_checkpoint_contexts` would not
do: it decides by ATen op, and the port's kernels are launched through ctypes
inside autograd Functions, out of a dispatch mode's sight.

Tensor parallelism (`tp`, the mesh's "model" line; parallel/sharding.py)
takes a route of its own through the same chain of stages, when the block's
params are this rank's shard of a line of more than one rank: LN1, then `copy_to_model` (identity forward,
all-reduce backward), the column-parallel QKV product over the rank's
heads, `mha` over those heads (K4 forward and K5 backward on the card,
ops/attention.py), the row-parallel out product and `reduce_from_model`
(all-reduce forward, identity backward), and only then the replicated
b_out, once, and the residual; the MLP half likewise (column-parallel w_fc,
the activation, row-parallel w_proj, the reduce, b_proj). The stage names
are those of the one-device chain, so remat's policies mean what they mean
there; a checkpointed piece re-runs its all-reduce in the backward, on every
rank of the line in the same order. K1, K3 and K9 hold the whole block with
its residual, so the route takes none of them.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from construction_clip_tpu_torch.core.params import tree_map
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import mlp
from construction_clip_tpu_torch.ops.activations import quick_gelu
from construction_clip_tpu_torch.ops.attention import (
    merge_heads, mha, resolve_impl, split_heads)
from construction_clip_tpu_torch.ops.norms import layer_norm
from construction_clip_tpu_torch.parallel.sharding import (
    copy_to_model, local_heads, reduce_from_model)

USE_FUSED_MLP = False   # construction_clip_tpu/models/blocks.py:104, off there too


def apply_block(params, x, *, n_heads: int, act: Callable, bias=None,
                is_causal: bool = False, ln_eps: float = 1e-5, return_probs: bool = False,
                probs_probe=None, tp=None):
    """One block; with return_probs, (x, the fp32 probabilities [B, H, T, T]).
    It runs the block's chain of stages (_block_chain) uncut; remat cuts it.
    tp: the "model" line whose shard `params` is (the tensor-parallel route)."""
    probs = [] if return_probs else None
    x = _run_chain(params, x, None, n_heads=n_heads, act=act, bias=bias, is_causal=is_causal,
                   ln_eps=ln_eps, probs=probs, probs_probe=probs_probe, tp=tp)
    return (x, probs[0]) if return_probs else x


def _takes_k1(x, n_heads, bias) -> bool:
    """The attention half runs K1 (the probes aside)."""
    return bias is None and resolve_impl() == "kernel" and fab.supported(x, n_heads)


def _takes_k9(x, params, act) -> bool:
    """The MLP half runs K9."""
    return USE_FUSED_MLP and act is quick_gelu and resolve_impl() == "kernel" \
        and mlp.supported(x, params["mlp"]["w_fc"])


def _mlp_residual(x1, params, act, ln_eps):
    """The MLP half with its residual over the stream x1: the chain's MLP stages."""
    stages = _mlp_stages(params, x1, act, ln_eps)
    value = x1
    for _, fn, _ in stages:
        value = fn(value)
    return _close(stages, value, x1)


def _close(stages, value, x1):
    """The block's output from its last stage's value: K9's holds the residual."""
    return value if stages[-1][0] == "mlp_residual" else x1 + value


# policy -> the stage names it saves; a name that the block's route never forms
# (qkv inside K1, anything inside K9) saves nothing, as a checkpoint_name that
# never runs saves nothing in JAX
REMAT_POLICIES = {
    "dots": ("qkv_dot", "attn_out_dot", "mlp_preact_dot", "mlp_out_dot"),
    "save_qkv": ("qkv",),
    "save_mlp_hidden": ("mlp_hidden",),
    "save_qkv_attn_out": ("qkv", "attn_out"),
    "save_qkv_mlp": ("qkv", "mlp_hidden"),
    "save_attn_preact": ("attn_out", "mlp_preact"),
    "save_preact": ("mlp_preact",),
    "save_big": ("qkv", "mlp_hidden", "attn_out"),
}


def _block_chain(params, x, *, n_heads, act, bias, is_causal, ln_eps, probs=None,
                 probs_probe=None, tp=None):
    """The block as (stages, fused_attention): stages are (name, fn, reads_x1)
    in order, fn mapping the previous stage's value, or with reads_x1 the
    stream x1 after the attention half, to this stage's value. Without the
    probes the attention half is K1 where _takes_k1 says so, and K1 gives
    attn_out with the residual in it (x1 = attn_out, else x1 = x + attn_out).
    "*_dot" are the library GEMMs' products before their bias. `probs`, a
    list, receives the attention's fp32 probabilities; `probs_probe` is mha's.
    With `tp` over more than one rank, the tensor-parallel chain (_tp_chain);
    a line of one rank holds the whole block, which takes the chain below."""
    if tp is not None and tp.world > 1:
        if probs is not None or probs_probe is not None:
            raise ValueError("the tensor-parallel block takes no probes")
        return _tp_chain(params, x, n_heads=n_heads, act=act, bias=bias,
                         is_causal=is_causal, ln_eps=ln_eps, tp=tp), False
    a = params["attn"]
    fused = probs is None and probs_probe is None and _takes_k1(x, n_heads, bias)
    if fused:
        stages = [("attn_out", lambda x: fab.fused_attention_block(
            x, params["ln_1"], a, n_heads=n_heads, causal=is_causal, eps=ln_eps), False)]
    else:
        def core(qkv):
            q, k, v = (split_heads(z, n_heads) for z in qkv.chunk(3, dim=-1))
            out = mha(q, k, v, bias=bias, is_causal=is_causal,
                      return_probs=probs is not None, probs_probe=probs_probe)
            if probs is not None:
                out, p = out
                probs.append(p)
            return merge_heads(out)

        stages = [
            ("ln_1", lambda x: layer_norm(x, params["ln_1"]["scale"], params["ln_1"]["bias"],
                                          eps=ln_eps), False),
            ("qkv_dot", lambda h: h @ a["w_qkv"], False),
            ("qkv", lambda y: y + a["b_qkv"], False),
            ("merged", core, False),
            ("attn_out_dot", lambda h: h @ a["w_out"], False),
            ("attn_out", lambda y: y + a["b_out"], False),
        ]
    return stages + _mlp_stages(params, x, act, ln_eps), fused


def _tp_chain(params, x, *, n_heads, act, bias, is_causal, ln_eps, tp):
    """The chain over this rank's shard of the block (parallel/sharding.py):
    local heads, the partial products reduced over `tp` before the
    replicated biases."""
    if bias is not None:
        raise ValueError("the tensor-parallel block takes no attention bias")
    a, m = params["attn"], params["mlp"]
    heads = local_heads(n_heads, tp, a["w_qkv"], x.shape[-1])

    def core(qkv):
        q, k, v = (split_heads(z, heads) for z in qkv.chunk(3, dim=-1))
        return merge_heads(mha(q, k, v, is_causal=is_causal))

    def ln(name):
        return lambda h: copy_to_model(layer_norm(h, params[name]["scale"],
                                                  params[name]["bias"], eps=ln_eps), tp)

    return [
        ("ln_1", ln("ln_1"), False),
        ("qkv_dot", lambda h: h @ a["w_qkv"], False),
        ("qkv", lambda y: y + a["b_qkv"], False),
        ("merged", core, False),
        ("attn_out_dot", lambda h: reduce_from_model(h @ a["w_out"], tp), False),
        ("attn_out", lambda y: y + a["b_out"], False),
        ("ln_2", ln("ln_2"), True),
        ("mlp_preact_dot", lambda h: h @ m["w_fc"], False),
        ("mlp_preact", lambda y: y + m["b_fc"], False),
        ("mlp_hidden", act, False),
        ("mlp_out_dot", lambda h: reduce_from_model(h @ m["w_proj"], tp), False),
        ("mlp_out", lambda y: y + m["b_proj"], False),
    ]


def _mlp_stages(params, x1, act, ln_eps):
    """The MLP half's stages, the first reading the stream x1: K9's one stage
    gives the block's output ("mlp_residual"), else the last stage is the
    MLP's output before its residual."""
    m = params["mlp"]
    if _takes_k9(x1, params, act):
        return [("mlp_residual", lambda x1: mlp.fused_mlp_residual(
            x1, m, params["ln_2"], eps=ln_eps), True)]
    return [
        ("ln_2", lambda x1: layer_norm(x1, params["ln_2"]["scale"], params["ln_2"]["bias"],
                                       eps=ln_eps), True),
        ("mlp_preact_dot", lambda h: h @ m["w_fc"], False),
        ("mlp_preact", lambda y: y + m["b_fc"], False),
        ("mlp_hidden", act, False),
        ("mlp_out_dot", lambda h: h @ m["w_proj"], False),
        ("mlp_out", lambda y: y + m["b_proj"], False),
    ]


def _run_chain(params, x, names, **kw):
    """The block from its input x. names None: the chain uncut, with no
    checkpoint. Else the chain is cut after each stage in `names`: each piece
    is one checkpoint whose inputs are the values saved before it (the
    previous cut, and x and attn_out where it forms x1), and the K1 stage
    alone runs bare. The piece that forms x1 hands it out for the final
    residual add, which saves nothing, so x1 has the uncut chain's two
    consumers and the gradients its bits."""
    stages, fused = _block_chain(params, x, **kw)
    last = len(stages) - 1
    ends = [i for i, (name, _, _) in enumerate(stages[:last]) if name in (names or ())]
    ends.append(last)
    value, attn_out, x1, lo = x, None, None, 0
    for hi in ends:
        piece = stages[lo: hi + 1]
        reads_x1 = any(r for _, _, r in piece)
        makes_attn = any(name == "attn_out" for name, _, _ in piece)

        def run(value, x, attn_out, piece=piece):
            x1 = None
            for name, fn, r in piece:
                if r and x1 is None:
                    x1 = attn_out if fused else x + attn_out
                value = fn(x1 if r else value)
                if name == "attn_out":
                    attn_out = value
            return value, attn_out, x1

        args = (value, x if reads_x1 and not fused else None,
                attn_out if reads_x1 and not makes_attn else None)
        if names is None or (fused and lo == hi == 0):   # K1 saves only its inputs
            value, attn_out, made = run(*args)
        else:
            value, attn_out, made = checkpoint(run, *args, use_reentrant=False,
                                               preserve_rng_state=False)
        x1 = made if reads_x1 else x1
        lo = hi + 1
    return _close(stages, value, x1)


def apply_stack(stacked_params, x, *, n_heads: int, act: Callable, bias=None,
                is_causal: bool = False, ln_eps: float = 1e-5, return_probs: bool = False,
                probs_probe=None, remat=False, tp=None):
    """Apply the L stacked blocks in order. The layers are views from one
    `unbind` per leaf, whose backward stacks the L gradients in one op (a view
    per layer would each scatter into a zeroed copy of the whole stack).
    probs_probe: zeros [L, B, H, T, T], layer l's probe probs_probe[l]. With
    return_probs, returns (x, the probabilities stacked [L, B, H, T, T]).

    remat: False, True (each layer keeps only its input and recomputes the
    rest in the backward) or a policy of REMAT_POLICIES, which also keeps the
    tensors it names (construction_clip_tpu/models/blocks.py:146-187 gives
    their memory and recompute trade-offs at ViT-L/14):
      "qkv"        the fused projection x @ W_qkv + b (ops/attention.py's);
                   on the K1 route (T <= 256) it never exists, so "save_qkv"
                   recomputes K1 there, as in JAX
      "attn_out"   the attention output after W_out, before the residual; on
                   the K1 route, K1's whole output, residual included
      "mlp_preact" LN2(x1) @ W_fc + b_fc
      "mlp_hidden" act(mlp_preact)
    and "dots" cuts after the four projection GEMMs' products before their
    bias, the library products (the backward reads three: the proj product
    meets only its bias add, which needs nothing). The hand kernels' inner
    products (K1, K4, K9) stay inside them, as checkpoint_dots does not see
    inside a pallas_call; on the plain attention route (impl "plain", or an
    attention bias) the attention core's own two products are recomputed
    too. The towers draw no random numbers, so the checkpoints do not save
    the RNG state. Remat does not combine with return_probs or probs_probe.

    tp: the mesh's "model" line, whose shard of the blocks `stacked_params`
    is (parallel/sharding.shard_clip_params): over more than one rank every
    block takes the tensor-parallel route, and `n_heads` stays the tower's
    whole count."""
    if remat and (return_probs or probs_probe is not None):
        raise ValueError("remat does not combine with return_probs or probs_probe")
    # the stage names kept besides the layer input (None: no remat); an unknown
    # policy is a KeyError, as JAX's dict lookup
    names = (REMAT_POLICIES[remat] if isinstance(remat, str) else ()) if remat else None
    layers = tree_map(lambda z: z.unbind(0), stacked_params)
    probs = []
    for index in range(stacked_params["ln_1"]["scale"].shape[0]):
        lp = tree_map(lambda views: views[index], layers)
        kw = dict(n_heads=n_heads, act=act, bias=bias, is_causal=is_causal, ln_eps=ln_eps, tp=tp)
        if names is not None:
            x = _run_chain(lp, x, names, **kw)
            continue
        x = apply_block(lp, x, return_probs=return_probs,
                        probs_probe=None if probs_probe is None else probs_probe[index], **kw)
        if return_probs:
            x, p = x
            probs.append(p)
    return (x, torch.stack(probs)) if return_probs else x
