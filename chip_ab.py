#!/usr/bin/env python3
"""One phase of chip_smoke.py from two checkouts in turns on one card: A, B, B,
A, each run in a process of its own, so that both meet the same card and host.

    python3 chip_ab.py serve   path/to/checkout_a path/to/checkout_b
    python3 chip_ab.py serve_int8 path/to/checkout_a path/to/checkout_b
    python3 chip_ab.py train   path/to/checkout_a path/to/checkout_b
    python3 chip_ab.py kernels path/to/checkout_a path/to/checkout_b
    python3 chip_ab.py k10     path/to/checkout_a path/to/checkout_b
    python3 chip_ab.py sass    path/to/checkout_a path/to/checkout_b
    python3 chip_ab.py kernels path/to/checkout     (one checkout, one run)
    python3 chip_ab.py tiles   path/to/checkout

serve: phase 5 (ViT-B/32 + GPT-2 12x768 beam 3 in bf16 through
TorchPredictService, 10 requests from 4 threads). serve_int8: phase 16 (the
same requests through apps/serve.build_service with --int8). train: phase 9 (ViT-B/32
contrastive training, bf16, B=36, 10 steps; its median step). kernels: the
device time (CUDA-graph replay, chip_smoke.graph_ms) and wrapper time of K2
at R=24 and R=3 (H=12, Dh=64, cache_len 139, beam ancestry, bf16), of K3 at
[36,50,768] H=12 bf16, and of K1 and K9 at [8,50,768] and [36,50,768] bf16
(H=12; hidden 3072), each with its launches' device times (torch.profiler,
chip_smoke.kernel_device_ms) and the composed library version's device time
beside it (K1: chip_smoke.composed_block's forward; K9: the default MLP of
models/blocks), and of K7 at [8,50,768] bf16 and fp32 (H=12) with the
composed int8 block's device time beside it (models/clip/quant._attn_residual_q off the
kernel impl: cuBLASLt's int8 GEMM and torch ops), and of the int8 ViT-B/32
image tower (models/clip/quant.encode_image_int8, 12 K7 launches) at B=8, on
inputs drawn from one numpy seed in both trees; then a
digest (sha256 of the bytes) of the outputs of K3 (bf16 and fp32), K1 and K9
in fp32 and K7 (bf16 and fp32) on inputs of another seed, so that equal
digests show the two trees' bits equal (bf16 too for the tensor-core routes
of K1, K4 and K5); then K6's device and wrapper time at [8,224,224,3] and
[256,224,224,3] into bf16 and fp32, each with the digest of its output; last,
K4 and K5 at [9,16,257,64] bf16 and K1 and K3 at GPT-2's transformer mapper
([16,30,768], 8 heads of 96) bf16, each with the tensor-core launches it made.
The kernels run goes on with the fp32 route of K1 and K3: K1 at every shape
of chip_smoke's K1_SHAPES, K3 at every one of its K3_SHAPES, both at
[16,30,768] (H=8), each with its launches' device times and the composed
library block beside it (K1: its forward; K3: the block's whole backward
through autograd, and the composed block's), then one batch of the
predict_zeroshot app in fp32 (ViT-B/32, B=8
staged at 256, its default policy): host ms, device ms and K1 launches; and
digests of fp32 K1 and K3 at GPT-2's transformer mapper, ViT-B/32's text
tower in training ([36,77,512], causal) and fp32 at d = 18 (2 heads; rows of
72 bytes, no multiple of 16). Last, the SIMT route of K4 and K5: digests of
fp32 K4 and K5 at every shape of chip_smoke's FLASH_SHAPES and of bf16 K4/K5
at [9,16,257,80] (a head width off the tensor cores), each with its SIMT
launches; at each FLASH_SHAPES shape in fp32 the device and wrapper time of
K4 and of K5 (with K5's launches' device times), SDPA's fp32 forward and
backward device time with the kernels it ran (TF32 off), and the bound (the
(query, key) pairs the mask keeps); and one batch of the predict_zeroshot app
at ViT-L/14 in fp32 (B=8, T = 257 in the image tower: K4 on SIMT, 24 a batch):
host ms, device ms, K4 launches and the largest kernels. Each fp32 K1 and
K7 profile above also prints its attention pass's device ms
(ab_attention_pass: the launch named "attention"); then K7's SIMT entry
at [36,50,768] fp32 and [8,50,640] bf16 (8 heads of 80: p rounded) with its
launches and pass (ab_k7_simt), digests of bf16 K1 and K7 at [8,50,640]
(both on their SIMT attention) and of fp32 K1 and K7 at [36,50,768] (64-row
attention blocks), and fp32 K9 at [8,50,768] and [36,50,768]
(hidden 3072) and [9,77,512] (2048): device and wrapper ms, its launches,
the composed fp32 MLP's device ms, the bound and its digest (ab_k9_f32).
k10: phase 23 (K10 with 4 ranks time-slicing the card: each case's wrapper
time a call, the kernel alone, the plain version's time). sass: each
checkout builds its kernels; then the SASS of every tensor-core attention
pass at head width 64 (K1, K3, K4/K5, K7: attention_tc.cuh's kernels, which
a template may name differently in the two trees), and of the bf16 row pass
and wgmma GEMMs of K1 and K9 at the tiles [8,50,768] takes, is compared
instruction by instruction, addresses and encodings aside. tiles: K4's SIMT forward
(fp32 at [9,16,257,64], [8,16,257,64] and [2,8,1024,64] causal) built from
the checkout's csrc/ as it is and with parts taken out (TILE_VARIANTS: the
output product, the s product, both, or expf replaced by __expf), each
variant's device time by CUDA-graph replay: where its time goes.

Each checkout builds its own kernels. Prints each run's JSON lines with the
checkout they came from, then the card's name and power limit. Given one
checkout, a phase other than sass runs it once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

PRELUDE = r"""
import sys, tempfile
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
cs.phase_device()
"""

RUNS = {
    "serve": (("serve",), r"""
with tempfile.TemporaryDirectory() as tmp:
    clip_tok, lm_tok = cs.tokenizers(tmp)
cfgs = (cs.CLIPConfig.vit_b_32(), cs.GPT2Config(), cs.ClipCapConfig())
cs.phase_serve(cs.convert.init_clip(0, cfgs[0]), cs.convert.init_clipcap(1, cfgs[2], cfgs[1]),
               cfgs, clip_tok, lm_tok, "cuda")
"""),
    "serve_int8": (("int8_serve",), r"""
with tempfile.TemporaryDirectory() as tmp:
    clip_tok, lm_tok = cs.tokenizers(tmp)
cfgs = (cs.CLIPConfig.vit_b_32(), cs.GPT2Config(), cs.ClipCapConfig())
cs.phase_build()
cs.phase_int8_serve(cs.convert.init_clip(0, cfgs[0]), cs.convert.init_clipcap(1, cfgs[2], cfgs[1]),
                    clip_tok, lm_tok)
"""),
    "train": (("train_vit_b_32",), r"""
with tempfile.TemporaryDirectory() as tmp:
    clip_tok, _ = cs.tokenizers(tmp)
cfg = cs.CLIPConfig.vit_b_32()
batch = cs.class_balanced_batch(cfg, clip_tok, 4, 9, "cuda")
cs.phase_train("vit_b_32", cfg, cs.convert.init_clip(0, cfg), batch, 10, "cuda")
"""),
    "kernels": (("ab_k2", "ab_k3", "ab_k1", "ab_k9", "ab_k7", "ab_int8_tower", "ab_bits", "ab_k6",
                 "ab_k45", "ab_dh96", "ab_k1_f32", "ab_k3_f32", "ab_zeroshot_f32", "ab_k45_f32",
                 "ab_zeroshot_l14_f32", "ab_attention_pass", "ab_k7_simt", "ab_k9_f32"),
                r"""
cs.phase_build()


# the attention pass's device ms a call out of a profile of K1 or K7: the launch
# whose name holds "attention" (one a call on either route)
def attention_pass(kernel, shape, heads, causal, dtype, launched):
    passes = {n: ms for n, ms in launched.items() if "attention" in n}
    cs.say("ab_attention_pass", kernel=kernel, shape=shape, heads=heads, causal=causal,
           dtype=str(dtype), device_ms=sum(passes.values()), launches=sorted(passes))


rng = np.random.default_rng(2)
for rows in (24, 3):
    shape = (12, rows, 12, 140, 64)
    ck, cv = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()
              for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((rows, 12, 64)).astype(np.float32)).cuda().bfloat16()
    anc = torch.from_numpy(rng.integers(0, rows, (rows, 140), dtype=np.int32)).cuda()

    def k2():
        return cs.decode_step_attention(q, ck, cv, 11, 139, anc)

    cs.say("ab_k2", rows=rows, cache_len=139, device_ms=cs.graph_ms(k2), ms=cs.median_ms(k2))
x, ln, attn = cs._block_inputs(rng, 36, 50, 768, torch.bfloat16, "cuda")
g = torch.from_numpy(rng.standard_normal((36, 50, 768)).astype(np.float32)).cuda().bfloat16()
args = (ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"])

def k3():
    return cs.fused_attention_block_bwd(x, g, *args, n_heads=12, causal=False)

cs.say("ab_k3", shape=[36, 50, 768], device_ms=cs.graph_ms(k3), ms=cs.median_ms(k3, 11, 3))
for b in (8, 36):
    x, ln, attn = cs._block_inputs(rng, b, 50, 768, torch.bfloat16, "cuda")
    args = (ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"], attn["b_out"])

    def k1():
        return cs.fused_attention_block(x, ln, attn, n_heads=12)

    def composed():
        return cs.composed_block(x, *args, n_heads=12, causal=False)

    cs.say("ab_k1", shape=[b, 50, 768], device_ms=cs.graph_ms(k1), ms=cs.median_ms(k1),
           composed_device_ms=cs.graph_ms(composed), launch_device_ms=cs.kernel_device_ms(k1))
from construction_clip_tpu_torch.ops.activations import quick_gelu
for b in (8, 36):
    x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj = cs._mlp_inputs(rng, b, 50, 768, 3072,
                                                               torch.bfloat16)
    mlp_p = {"w_fc": w_fc, "b_fc": b_fc, "w_proj": w_proj, "b_proj": b_proj}
    ln_p = {"scale": ln_s, "bias": ln_b}

    def k9():
        return cs.fused_mlp_residual(x, mlp_p, ln_p)

    def composed():
        return cs.blocks._mlp_residual(x, {"mlp": mlp_p, "ln_2": ln_p}, quick_gelu, 1e-5)

    cs.say("ab_k9", shape=[b, 50, 768], hidden=3072, device_ms=cs.graph_ms(k9),
           ms=cs.median_ms(k9), composed_device_ms=cs.graph_ms(composed),
           launch_device_ms=cs.kernel_device_ms(k9))
from construction_clip_tpu_torch.models.clip.quant import _attn_residual_q
from construction_clip_tpu_torch.ops.attention import use_impl
for dtype in (torch.bfloat16, torch.float32):
    x, ln, qattn, _ = cs._int8_block_inputs(rng, 8, 50, 768, dtype, "cuda")

    def k7():
        return cs.fused_attention_block_int8(x, ln, qattn, n_heads=12)

    def composed():
        with use_impl("plain"):
            return _attn_residual_q(x, ln, qattn, 12)

    launched = cs.kernel_device_ms(k7)
    cs.say("ab_k7", shape=[8, 50, 768], dtype=str(dtype), device_ms=cs.graph_ms(k7),
           ms=cs.median_ms(k7), composed_device_ms=cs.graph_ms(composed),
           launch_device_ms=launched)
    attention_pass("K7", [8, 50, 768], 12, False, dtype, launched)
from construction_clip_tpu_torch.models.clip.quant import encode_image_int8, quantize_clip
cfg = cs.CLIPConfig.vit_b_32()
qp = quantize_clip(cs.convert.to_params(cs.convert.init_clip(0, cfg), device="cuda"))
images = torch.from_numpy(rng.standard_normal((8, 224, 224, 3)).astype(np.float32)).cuda()


def tower():
    with torch.inference_mode():
        return encode_image_int8(qp, cfg, images)


cs.say("ab_int8_tower", batch=8, device_ms=cs.graph_ms(tower), ms=cs.median_ms(tower, 11, 3))
del qp
import hashlib


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


rng = np.random.default_rng(3)
for dtype in (torch.bfloat16, torch.float32):
    x, ln, attn = cs._block_inputs(rng, 36, 50, 768, dtype, "cuda")
    g = torch.from_numpy(rng.standard_normal((36, 50, 768)).astype(np.float32)).cuda().to(dtype)
    cs.say("ab_bits", kernel="K3", dtype=str(dtype), digest=digest(*cs.fused_attention_block_bwd(
        x, g, ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"], n_heads=12)))
for b, t, d, h, causal in ((8, 50, 768, 12, False), (9, 77, 512, 8, True)):
    x, ln, attn = cs._block_inputs(rng, b, t, d, torch.float32, "cuda")
    cs.say("ab_bits", kernel="K1", dtype="torch.float32", shape=[b, t, d], digest=digest(
        cs.fused_attention_block(x, ln, attn, n_heads=h, causal=causal)))
x, *rest = cs._mlp_inputs(rng, 8, 50, 768, 3072, torch.float32)
cs.say("ab_bits", kernel="K9", dtype="torch.float32", digest=digest(cs.fused_mlp_residual(
    x, dict(zip(("w_fc", "b_fc", "w_proj", "b_proj"), rest[2:])),
    {"scale": rest[0], "bias": rest[1]})))
# K7's attention route beside its digest: the tensor-core pass (bf16) sums
# p . v in another order than the SIMT pass, so the two routes' bits differ
k7 = cs.fused_attention_block_int8
for dtype in (torch.bfloat16, torch.float32):
    x, ln, qattn, _ = cs._int8_block_inputs(rng, 8, 50, 768, dtype, "cuda")
    before = cs.counted("k7.tc")
    out = k7(x, ln, qattn, n_heads=12)
    cs.say("ab_bits", kernel="K7", dtype=str(dtype), digest=digest(out),
           attention_route="tc" if cs.counted("k7.tc") != before else "simt")
x, ln, attn = cs._block_inputs(rng, 8, 50, 768, torch.bfloat16, "cuda")
cs.say("ab_bits", kernel="K1", dtype="torch.bfloat16", shape=[8, 50, 768], digest=digest(
    cs.fused_attention_block(x, ln, attn, n_heads=12)))
q, k, v, go = (torch.from_numpy(rng.standard_normal((9, 16, 257, 64)).astype(np.float32))
               .cuda().bfloat16() for _ in range(4))
cs.say("ab_bits", kernel="K4", dtype="torch.bfloat16", digest=digest(
    cs.flash_attention_fwd(q, k, v, is_causal=False, scale=0.125)))
cs.say("ab_bits", kernel="K5", dtype="torch.bfloat16", digest=digest(
    *cs.flash_attention_bwd(q, k, v, go, is_causal=True, scale=0.125)))
from construction_clip_tpu_torch.data.preprocess import CLIP_MEAN, CLIP_STD
rng = np.random.default_rng(4)
for shape in ((8, 224, 224, 3), (256, 224, 224, 3)):
    u8 = torch.from_numpy((rng.random(shape) * 256).astype(np.uint8)).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        def k6():
            return cs.normalize_u8(u8, mean=CLIP_MEAN, std=CLIP_STD, out_dtype=dtype)

        device_ms = cs.graph_ms(k6)
        cs.say("ab_k6", shape=list(shape), dtype=str(dtype), device_ms=device_ms,
               ms=cs.median_ms(k6), share_of_bound=cs.bound(cs.nbytes(u8, k6()), {})["bound_ms"]
               / device_ms, digest=digest(k6()))
    del u8
rng = np.random.default_rng(5)
q, k, v, go = (torch.from_numpy(rng.standard_normal((9, 16, 257, 64)).astype(np.float32))
               .cuda().bfloat16() for _ in range(4))
for name, fn in (("K4", lambda: cs.flash_attention_fwd(q, k, v, is_causal=False, scale=0.125)),
                 ("K5", lambda: cs.flash_attention_bwd(q, k, v, go, is_causal=False,
                                                       scale=0.125))):
    cs.say("ab_k45", kernel=name, shape=[9, 16, 257, 64], device_ms=cs.graph_ms(fn),
           ms=cs.median_ms(fn))
x, ln, attn = cs._block_inputs(rng, 16, 30, 768, torch.bfloat16, "cuda")
g = torch.from_numpy(rng.standard_normal((16, 30, 768)).astype(np.float32)).cuda().bfloat16()
args = (ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"])
for name, counter, fn in (
        ("K1", "k1.tc", lambda: cs.fused_attention_block(x, ln, attn, n_heads=8)),
        ("K3", "k3.tc", lambda: cs.fused_attention_block_bwd(x, g, *args, n_heads=8))):
    before = cs.counted(counter)
    fn()
    cs.say("ab_dh96", kernel=name, shape=[16, 30, 768], heads=8, device_ms=cs.graph_ms(fn),
           ms=cs.median_ms(fn, 11, 3), tc_launches=cs.counted(counter) - before)



rng = np.random.default_rng(6)
mapper = (16, 30, 768, 8, False)
for shape in dict.fromkeys(cs.K1_SHAPES + cs.K3_SHAPES + (mapper,)):
    b, t, d, h, causal = shape
    x, ln, attn = cs._block_inputs(rng, b, t, d, torch.float32, "cuda")
    g = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).cuda()
    args = (ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"], attn["b_out"])

    def k1():
        return cs.fused_attention_block(x, ln, attn, n_heads=h, causal=causal)

    def k3():
        return cs.fused_attention_block_bwd(x, g, *args[:5], n_heads=h, causal=causal)

    def fused_block(*a):
        return cs.fused_attention_block(a[0], {"scale": a[1], "bias": a[2]},
                                        {"w_qkv": a[3], "b_qkv": a[4], "w_out": a[5],
                                         "b_out": a[6]}, n_heads=h, causal=causal)

    def composed(*a):
        return cs.composed_block(*a, n_heads=h, causal=causal)

    if shape in cs.K1_SHAPES + (mapper,):
        launched = cs.kernel_device_ms(k1)
        cs.say("ab_k1_f32", shape=[b, t, d], heads=h, causal=causal, device_ms=cs.graph_ms(k1),
               ms=cs.median_ms(k1), composed_device_ms=cs.graph_ms(lambda: composed(x, *args)),
               launch_device_ms=launched)
        attention_pass("K1", [b, t, d], h, causal, torch.float32, launched)
    if shape in cs.K3_SHAPES + (mapper,):
        cs.say("ab_k3_f32", shape=[b, t, d], heads=h, causal=causal, device_ms=cs.graph_ms(k3),
               ms=cs.median_ms(k3, 11, 3), launch_device_ms=cs.kernel_device_ms(k3),
               block_backward_device_ms=cs.backward_device_ms(fused_block, (x, *args), g),
               composed_backward_device_ms=cs.backward_device_ms(composed, (x, *args), g))
import time
from construction_clip_tpu_torch.apps import predict_zeroshot
from construction_clip_tpu_torch.data.schema import Annotation
from construction_clip_tpu_torch.infer.zeroshot import label_features
with tempfile.TemporaryDirectory() as tmp:
    clip_tok, _ = cs.tokenizers(tmp)
cfg = cs.CLIPConfig.vit_b_32()
params = cs.convert.to_params(cs.convert.init_clip(0, cfg), device="cuda").tree()
labels = list(cs.VIOLATION_TYPES)
feats = label_features(params, cfg, clip_tok.tokenize(labels, cfg.text.context_length),
                       policy=cs.DEFAULT_POLICY)
process = predict_zeroshot.make_process(params, cfg, feats, labels, "violation_type", "cuda",
                                        policy=cs.DEFAULT_POLICY)
staged = np.stack(cs.synthetic_images(np.random.default_rng(18), [(256, 256)] * 8))
anns = [Annotation(id=i, file_name=f"site_{i}.jpg", violation_type=labels[i % 9]) for i in range(8)]
process(anns, staged)
walls = []
for _ in range(5):
    before = cs.counted("k1")
    t0 = time.perf_counter()
    records, _ = process(anns, staged)   # ends in the probabilities' copy to the host
    walls.append((time.perf_counter() - t0) * 1e3)
    k1_launches = cs.counted("k1") - before
per = cs.kernel_device_ms(lambda: process(anns, staged), reps=5)
cs.say("ab_zeroshot_f32", batch=8, wall_ms=sorted(walls)[2], device_ms=sum(per.values()),
       k1_launches=k1_launches, top_kernels=dict(sorted(per.items(), key=lambda kv: -kv[1])[:8]),
       predictions=[r["prediction"] for r in records[:3]])
del params
rng = np.random.default_rng(9)
for b, t, d, h, causal in ((16, 30, 768, 8, False), (36, 77, 512, 8, True), (2, 7, 18, 2, False)):
    x, ln, attn = cs._block_inputs(rng, b, t, d, torch.float32, "cuda")
    g = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).cuda()
    cs.say("ab_bits", kernel="K1", dtype="torch.float32", shape=[b, t, d], digest=digest(
        cs.fused_attention_block(x, ln, attn, n_heads=h, causal=causal)))
    cs.say("ab_bits", kernel="K3", dtype="torch.float32", shape=[b, t, d], digest=digest(
        *cs.fused_attention_block_bwd(x, g, ln["scale"], ln["bias"], attn["w_qkv"],
                                      attn["b_qkv"], attn["w_out"], n_heads=h, causal=causal)))
rng = np.random.default_rng(10)
for shape, dtype in ([(s, torch.float32) for s in cs.FLASH_SHAPES] +
                     [((9, 16, 257, 80, False), torch.bfloat16)]):
    b, h, t, dh, causal = shape
    q, k, v, go = (torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(np.float32))
                   .cuda().to(dtype) for _ in range(4))
    kw = dict(is_causal=causal, scale=dh ** -0.5)
    before = cs.counted("k4.simt") + cs.counted("k5.simt")
    cs.say("ab_bits", kernel="K4", dtype=str(dtype), shape=[b, h, t, dh], causal=causal,
           digest=digest(cs.flash_attention_fwd(q, k, v, **kw)))
    cs.say("ab_bits", kernel="K5", dtype=str(dtype), shape=[b, h, t, dh], causal=causal,
           digest=digest(*cs.flash_attention_bwd(q, k, v, go, **kw)),
           simt_launches=cs.counted("k4.simt") + cs.counted("k5.simt") - before)
torch.backends.cuda.matmul.allow_tf32 = False   # SDPA's fp32 yardstick in fp32
torch.backends.cudnn.allow_tf32 = False
for b, h, t, dh, causal in cs.FLASH_SHAPES:
    q, k, v, go = (torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(np.float32))
                   .cuda() for _ in range(4))
    kw = dict(is_causal=causal, scale=dh ** -0.5)
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)   # the (query, key) pairs needed

    def fwd():
        return cs.flash_attention_fwd(q, k, v, **kw)

    def bwd():
        return cs.flash_attention_bwd(q, k, v, go, **kw)

    def lib(*a):
        return cs.sdpa(*a, **kw)

    cs.say("ab_k45_f32", kernel="K4", shape=[b, h, t, dh], causal=causal,
           device_ms=cs.graph_ms(fwd), ms=cs.median_ms(fwd),
           sdpa_device_ms=cs.graph_ms(lambda: lib(q, k, v)),
           sdpa_kernels=cs.kernel_device_ms(lambda: lib(q, k, v)),
           **cs.bound(cs.nbytes(q, k, v, q), {torch.float32: 2 * pairs * dh * 2}))
    cs.say("ab_k45_f32", kernel="K5", shape=[b, h, t, dh], causal=causal,
           device_ms=cs.graph_ms(bwd), ms=cs.median_ms(bwd, 11, 3),
           launch_device_ms=cs.kernel_device_ms(bwd),
           sdpa_device_ms=cs.backward_device_ms(lib, (q, k, v), go),
           sdpa_kernels=cs.backward_kernels(lib, (q, k, v), go),
           **cs.bound(cs.nbytes(q, k, v, go, q, k, v), {torch.float32: 2 * pairs * dh * 5}))
cfg = cs.CLIPConfig.vit_l_14()
params = cs.convert.to_params(cs.convert.init_clip(2, cfg), device="cuda").tree()
feats = label_features(params, cfg, clip_tok.tokenize(labels, cfg.text.context_length),
                       policy=cs.DEFAULT_POLICY)
process = predict_zeroshot.make_process(params, cfg, feats, labels, "violation_type", "cuda",
                                        policy=cs.DEFAULT_POLICY)
process(anns, staged)
walls = []
for _ in range(5):
    before = (cs.counted("k4"), cs.counted("k4.simt"))
    t0 = time.perf_counter()
    records, _ = process(anns, staged)
    walls.append((time.perf_counter() - t0) * 1e3)
    k4 = (cs.counted("k4") - before[0], cs.counted("k4.simt") - before[1])
per = cs.kernel_device_ms(lambda: process(anns, staged), reps=5)
cs.say("ab_zeroshot_l14_f32", batch=8, wall_ms=sorted(walls)[2], device_ms=sum(per.values()),
       k4_launches=k4[0], k4_simt_launches=k4[1],
       top_kernels=dict(sorted(per.items(), key=lambda kv: -kv[1])[:8]),
       predictions=[r["prediction"] for r in records[:3]])
del params
rng = np.random.default_rng(11)
for dtype, shape in ((torch.float32, (36, 50, 768, 12)), (torch.bfloat16, (8, 50, 640, 8))):
    b, t, d, h = shape
    x, ln, qattn, _ = cs._int8_block_inputs(rng, b, t, d, dtype, "cuda")

    def k7():
        return cs.fused_attention_block_int8(x, ln, qattn, n_heads=h)

    launched = cs.kernel_device_ms(k7)
    cs.say("ab_k7_simt", shape=[b, t, d], heads=h, dtype=str(dtype), device_ms=cs.graph_ms(k7),
           launch_device_ms=launched)
    attention_pass("K7", [b, t, d], h, False, dtype, launched)
x, ln, attn = cs._block_inputs(rng, 8, 50, 640, torch.bfloat16, "cuda")
k1_before = cs.counted("k1.tc")
out = cs.fused_attention_block(x, ln, attn, n_heads=8)
cs.say("ab_bits", kernel="K1", dtype="torch.bfloat16", shape=[8, 50, 640], heads=8,
       digest=digest(out), tc_launches=cs.counted("k1.tc") - k1_before)
attention_pass("K1", [8, 50, 640], 8, False, torch.bfloat16, cs.kernel_device_ms(
    lambda: cs.fused_attention_block(x, ln, attn, n_heads=8)))
x, ln, qattn, _ = cs._int8_block_inputs(rng, 8, 50, 640, torch.bfloat16, "cuda")
k7_before = cs.counted("k7.tc")
out = cs.fused_attention_block_int8(x, ln, qattn, n_heads=8)
cs.say("ab_bits", kernel="K7", dtype="torch.bfloat16", shape=[8, 50, 640], heads=8,
       digest=digest(out), tc_launches=cs.counted("k7.tc") - k7_before)
x, ln, attn = cs._block_inputs(rng, 36, 50, 768, torch.float32, "cuda")
cs.say("ab_bits", kernel="K1", dtype="torch.float32", shape=[36, 50, 768], digest=digest(
    cs.fused_attention_block(x, ln, attn, n_heads=12)))
x, ln, qattn, _ = cs._int8_block_inputs(rng, 36, 50, 768, torch.float32, "cuda")
cs.say("ab_bits", kernel="K7", dtype="torch.float32", shape=[36, 50, 768], digest=digest(
    cs.fused_attention_block_int8(x, ln, qattn, n_heads=12)))
for b, t, d, hidden in ((8, 50, 768, 3072), (36, 50, 768, 3072), (9, 77, 512, 2048)):
    x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj = cs._mlp_inputs(rng, b, t, d, hidden,
                                                               torch.float32)
    mlp_p = {"w_fc": w_fc, "b_fc": b_fc, "w_proj": w_proj, "b_proj": b_proj}
    ln_p = {"scale": ln_s, "bias": ln_b}

    def k9():
        return cs.fused_mlp_residual(x, mlp_p, ln_p)

    def composed():
        return cs.blocks._mlp_residual(x, {"mlp": mlp_p, "ln_2": ln_p}, quick_gelu, 1e-5)

    cs.say("ab_k9_f32", shape=[b, t, d], hidden=hidden, device_ms=cs.graph_ms(k9),
           ms=cs.median_ms(k9), composed_device_ms=cs.graph_ms(composed),
           launch_device_ms=cs.kernel_device_ms(k9), digest=digest(k9()),
           **cs.bound(cs.nbytes(x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, x),
                      {torch.float32: 4 * b * t * d * hidden}))
"""),
    "k10": (("k10",), r"""
cs.phase_build()
cs.phase_k10({})
"""),
}


# the tensor-core attention passes (attention_tc.cuh's, and K4's forward) by
# source, as parts of their SASS function names; where a tree's pass is a
# template on the head width, its instantiation at 64; and the bf16 row pass
# and wgmma GEMMs of K1 and K9 at the tiles [8,50,768] picks (gemm_tc<EPI,
# B_KMAJOR, BM, BN>), in sources that also hold SIMT code
SASS_KERNELS = {"flash_attention.cu": ("tc_fwd", "tc_stats", "tc_dqILb0", "tc_dkv"),
                "attention_block_bwd.cu": ("tc_stats", "tc_dqILb1", "tc_dkv"),
                "attention_block.cu": ("tc_block_fwd", "gemm_tcILi0ELb0ELi64ELi128E",
                                       "gemm_tcILi1ELb0ELi64ELi64E",
                                       "ln_rowsI13__nv_bfloat16E"),
                "attention_block_int8.cu": ("tc_block_fwd",),
                "mlp_residual.cu": ("gemm_tcILi4ELb0ELi64ELi64E", "gemm_tcILi1ELb0ELi64ELi64E",
                                    "ln_rowsI13__nv_bfloat16E")}
SASS_BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from construction_clip_tpu_torch.ops import _build
_build.load_library()
for src in _build.sources():
    print(src.name, _build.library_path(src), _build.find_nvcc())
"""


def sass_functions(cuobjdump: str, lib: str) -> dict:
    """{mangled name: [instruction text]} of a library's SASS, without
    addresses, encodings or symbol names."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            text = re.sub(r"/\*.*?\*/", "", line).strip().rstrip(";").strip()
            funcs[name].append(re.sub(r"_Z\w+", "<sym>", text))
    return funcs


def sass(a: str, b: str) -> None:
    libs = {}
    for root in (a, b):
        run = subprocess.run([sys.executable, "-c", SASS_BUILD, root], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            sys.exit(f"{root}: exit {run.returncode}\n{run.stderr[-12000:]}")
        libs[root] = {line.split()[0]: line.split()[1:] for line in run.stdout.splitlines()}
    for source, parts in SASS_KERNELS.items():
        lib_a, nvcc = libs[a][source]
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        fa = sass_functions(cuobjdump, lib_a)
        fb = sass_functions(cuobjdump, libs[b][source][0])
        for part in parts:
            na, nb = ([n for n in f if part in n and "Li96E" not in n] for f in (fa, fb))
            if len(na) != 1 or len(nb) != 1:
                sys.exit(f"{source} {part}: functions {na} / {nb}")
            ia, ib = fa[na[0]], fb[nb[0]]
            print(json.dumps({"phase": "ab_sass", "source": source, "kernel": part,
                              "instructions": [len(ia), len(ib)], "equal": ia == ib,
                              "differing": sum(x != y for x, y in zip(ia, ib))
                              + abs(len(ia) - len(ib))}), flush=True)


# K4's SIMT forward with parts taken out (csrc/attention_tiles.cuh, the kFwd
# branch of attn_rows_tile): lines replaced in a copy of csrc/, so that the
# variants' times split a call's device time between the two products, the
# exponentials and the rest (staging, softmax, barriers, stores). The outputs
# of variants 1, 2 and 4 are wrong by design; only their times are read.
TILE_VARIANTS = {
    "full": (),
    "no_output_product": (("      out_tile(acc, pan, v_s, j0);", ""),),
    "no_s_product": (("      if (panel_live) panel_product_n(s, q_s, k_s, ks, dh, tx, ty, "
                      "n_keys - j0);", ""),),
    "fast_exp": (("expf(__fsub_rn(s[i][j], m_new))", "__expf(s[i][j] - m_new)"),
                 ("const float corr = expf(__fsub_rn(m[i], m_new));",
                  "const float corr = __expf(m[i] - m_new);")),
    "no_products": (("      out_tile(acc, pan, v_s, j0);", ""),
                    ("      if (panel_live) panel_product_n(s, q_s, k_s, ks, dh, tx, ty, "
                     "n_keys - j0);", "")),
}
TILES_RUN = r"""
import ctypes, json, os, shutil, subprocess, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from construction_clip_tpu_torch.ops import _build
variants = json.loads(sys.argv[2])
cs.phase_device()
src = os.path.join(sys.argv[1], "construction_clip_tpu_torch", "csrc")
header = open(os.path.join(src, "attention_tiles.cuh")).read()
procs = {}
for name, subs in variants.items():
    out = os.path.join(sys.argv[1], "build", "tile_variants", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    text = header
    for old, new in subs:
        if old not in text:
            sys.exit(f"{name}: the line to replace is not in attention_tiles.cuh: {old!r}")
        text = text.replace(old, new)
    open(os.path.join(out, "attention_tiles.cuh"), "w").write(text)
    procs[name] = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                                    os.path.join(out, "lib.so"),
                                    os.path.join(out, "flash_attention.cu")],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
for name, proc in procs.items():
    log = proc.communicate()[0]
    if proc.returncode:
        sys.exit(f"{name}: nvcc failed\n{log[-4000:]}")
for b, h, t, dh, causal in ((9, 16, 257, 64, False), (8, 16, 257, 64, False),
                            (2, 8, 1024, 64, True)):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(np.float32)).cuda()
               for _ in range(3))
    o = torch.empty_like(q)
    times = {}
    for name in variants:
        fn = ctypes.CDLL(os.path.join(sys.argv[1], "build", "tile_variants", name,
                                      "lib.so")).cct_flash_attention_fwd
        fn.argtypes, fn.restype = _build.SIGNATURES["cct_flash_attention_fwd"]

        def run():
            _build.check(fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, t,
                            dh, int(causal), dh ** -0.5, torch.cuda.current_stream().cuda_stream),
                         "flash_attention")

        times[name] = cs.graph_ms(run)
    cs.say("ab_tiles", shape=[b, h, t, dh], causal=causal, device_ms=times)
"""


def tiles(root: str) -> None:
    run = subprocess.run([sys.executable, "-c", TILES_RUN, root, json.dumps(TILE_VARIANTS)],
                         cwd=root, capture_output=True, text=True, timeout=900)
    if run.returncode:
        sys.exit(f"{root}: exit {run.returncode}\n{run.stdout[-4000:]}\n{run.stderr[-12000:]}")
    for line in run.stdout.splitlines():
        if line.startswith("{") and json.loads(line).get("phase") == "ab_tiles":
            print(json.dumps({"checkout": root, **json.loads(line)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


def main() -> None:
    phase = sys.argv[1]
    roots = [os.path.abspath(p) for p in sys.argv[2:4]]
    if phase == "sass":
        sass(*roots)
        return
    if phase == "tiles":
        tiles(roots[0])
        return
    keep, body = RUNS[phase]
    a, b = roots if len(roots) == 2 else (roots[0], None)
    for root in (a, b, b, a) if b else (a,):
        run = subprocess.run([sys.executable, "-c", PRELUDE + body, root], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            sys.exit(f"{root}: exit {run.returncode}\n{run.stdout[-4000:]}\n{run.stderr[-12000:]}")
        for line in run.stdout.splitlines():
            if line.startswith("{") and json.loads(line).get("phase") in keep:
                print(json.dumps({"checkout": root, **json.loads(line)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
