#!/usr/bin/env python3
"""Smoke run of the PyTorch port (construction_clip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (the last line is the JSON verdict):
  1. device: the card's name and power limit; no CUDA device is an error.
  2. build: nvcc builds the port's CUDA kernels from csrc/ (timed).
  3. K1, the fused attention block, against its plain version at the serving
     and training paths' shapes, bf16 (tensor-core route: its counter must
     move) and fp32 (SIMT route), with times; for bf16 also the device time
     (the replay of a CUDA graph of 20 calls), each of its launches' device
     time under torch.profiler, and the device time of the composed block's
     forward (layer_norm, addmm, SDPA, addmm, add: cuBLAS and SDPA).
  4. K2, decode-step attention with beam ancestry, against its plain version
     at 8 images x beam 3 (R=24) and 1 image x beam 3 (R=3), cache lengths 0
     to t_max - 1, bf16 and fp32, bit-equal on a second call; at cache_len
     139 with ancestry in bf16 its device time beside a torch.gather + SDPA
     yardstick's.
  5. the serving path at full width (ViT-B/32, GPT-2 12x768, MLP mapper, random
     weights from a numpy seed, bf16): requests from 4 threads through
     TorchPredictService; launch counts of both kernels in that run, every
     K1 launch on the tensor-core route.
  6. kernel path against plain path at full width in fp32: image features,
     zero-shot classes and greedy tokens.
  7. K3, the fused block's backward, against its plain version at the training
     path's shapes, bf16 (tensor-core route: its counter must move) and fp32
     (SIMT route), with times; for bf16 the device time, each of its launches'
     device time under torch.profiler with the GEMMs' TFLOP/s, and the fused
     block's whole backward against the composed block's (layer_norm,
     Linear, SDPA, Linear: cuBLAS and SDPA) autograd backward, with both
     backwards' kernels at the first shape.
  8. K4 and K5, flash attention forward and backward, against their plain
     versions at the ViT-L/14 image tower's shape, a causal text shape, T=1024
     causal and T=65, bf16 on the tensor-core route and fp32 on the SIMT
     route (each route's launch counter must move); the tensor-core
     instructions (HGMMA/IGMMA/HMMA) and registers of each K1/K3/K4/K5/K7/K9
     kernel in the built libraries (a tensor-core kernel without HGMMA, or
     K7's int8 GEMM without IGMMA, fails the run); the
     wrapper times and, for bf16, the device times (CUDA-graph
     replays) of K4, K5 and scaled_dot_product_attention's forward and
     backward, and of each of K5's three launches (torch.profiler).
  9. ViT-B/32 contrastive training at full width and depth, bf16, B=36 (4
     class-balanced groups of 9): 10 make_train_step steps on one batch; the
     loss must fall; launch counts of K1 and K3, every K1 and K3 launch on
     the tensor-core route; the median step, and a step's device time (its
     kernels under torch.profiler; so in every training phase in one process).
 10. ViT-L/14 contrastive training at full width and depth, bf16, B=9, 3 steps;
     K4 and K5 launch from the image tower, K1 and K3 from the text tower,
     every K1/K3/K4/K5 launch on the tensor-core route; the median step time.
 11. the kernel path against the plain path in fp32: loss and every gradient
     leaf over 2 ViT-B/32 steps from the same params.
 12. K8, the vocab-head GEMV, against its plain version at mT5-small's head
     (D=512, V=250112) at B=1 and B=8, bf16 and int8 + scale, and at a V that
     is not a multiple of its column tile; times, device times and the table
     read's GB/s.
 13. mT5 captioning at full width (ViT-B/32, the MLP mapper with prefix 20,
     mT5-small 8+8 layers, random weights from numpy seeds, bf16) through the
     batch function of the port's apps/predict_t5.py: B=1 and B=8, sampled and
     greedy, bf16 head and int8 head, 32 steps; K8 launches steps + 1 times a
     generate call; a B=16 call launches it zero times. Then decode-step times
     of a 32-step greedy generate at B=1 and B=8 with each head.
 14. the kernel path against the plain path in bf16 for mT5: every step's
     logits over one token stream, and greedy tokens.
 15. K7, the int8 fused attention block, against its plain version at the
     int8 image tower's shapes ([8,50,768] and [1,50,768], H=12), bf16 on the
     tensor-core route (its counter must move) and fp32 on the SIMT route,
     the int8 products on wgmma s8 at these widths; with the route, device
     times and K1's time at the same bf16 shapes; for bf16 also each of its
     launches' device time under torch.profiler and the device time of the
     composed int8 block (models/clip/quant._attn_residual_q off the kernel
     impl: cuBLASLt's int8 GEMM and torch ops); and the int8 GEMM of
     int8_linear with the weight K-contiguous against row-major.
 16. int8 serving at full width (ViT-B/32 and GPT-2 quantized in the port from
     phase 5's numpy seeds) through the port's apps/serve.build_service
     (--int8, beam 3, 100 steps): requests from 4 threads; K7 launches 12
     times per image-tower call, every launch on the tensor-core route, K1
     never after setup, K2 12 times a step.
 17. the int8 kernel path against the int8 plain path: image features,
     zero-shot classes and greedy tokens.
 18. K6, the uint8 normalize, against its plain version into fp32 and bf16
     (bit-equal) at [8,224,224,3], [256,224,224,3] (larger than the L2), a
     tail shape [1,7,5,3] and a view one byte into its storage, with times;
     beside them K6's device time, from the replay of a CUDA graph of 20
     calls, and its share of the bytes bound.
 19. K9, the fused MLP residual, against its plain version at the towers'
     shapes ([8,50,768]->3072 bf16 and fp32, [36,50,768] bf16, [9,77,512]->2048
     bf16), with times, the composed default MLP's time beside them, the
     backward's time, and the device times from CUDA-graph replays; bf16 on
     the tensor-core route (its counter must move), with each launch's device
     time under torch.profiler, fp32 on the SIMT route.
 20. the staged fused-MLP zero-shot path at full width (ViT-B/32, bf16,
     USE_FUSED_MLP on): 224-staged uint8 through preprocess_staged (K6) and
     infer/zeroshot.classify_batch (K1 and K9 in every block of both towers,
     every launch on the tensor-core route),
     and the port's apps/predict_zeroshot.make_process on 256-staged arrays;
     held against the plain path (switch on, plain impl) in bf16 and fp32.
 21. infer/precompute.precompute_corpus at full width over 70 synthetic
     images (one unreadable) through a load_image hook, fused MLP on: the
     archive's keys and shapes.
 22. ViT-B/32 contrastive training with the fused MLP on (bf16, B=36, 5
     steps): the loss falls, K1, K3 and K9 launch, every launch on the
     tensor-core route; its median step time and device time beside
     phase 9's; then phase 11's fp32 gradient parity with the switch on.
 23. K10, the data-parallel feature all-gather, with 4 ranks sharing the card
     (spawned processes, CUDA IPC between them, flags on the device): bit-equal
     to its plain version (gloo through the host) at [9,512] fp32 and bf16,
     [9,768], a chunk that is no multiple of 16 bytes and [4096,1024] bf16;
     the wrapper's time a call in a back-to-back run on all ranks, the
     kernel's alone by CUDA events one rank at a time with every flag
     already at its generation (and rank 0's two launches under
     torch.profiler), the plain version's, the bound; then 50
     back-to-back calls with other rows each in which one rank in turn comes
     20 ms late, bit-equal.
 24. data-parallel ViT-B/32 training at full width and depth, bf16, 4 ranks on
     the card, global B=36 (phase 9's batch, 9 rows a rank), params from
     phase 9's seed on rank 0 broadcast to the others: 5 steps, the loss
     falls; per rank K10 launches twice a step, K1 and K3 launch, every K1
     and K3 launch on the tensor-core route. The ranks
     time-slice one card: the step times are no multi-GPU speed.
 25. the 4-rank step against the one-process step in fp32 on the same params
     and B=36 batch: the loss, the accuracy, every gradient leaf after the
     mean over ranks, and the global eval accuracy.
 26. data-parallel ViT-L/14 training (BASELINE config 5's model) at full width
     and depth, bf16, 2 ranks, global B=18, 2 steps: K4/K5 launch from the
     image tower and K10 from the loss in every rank, every K1/K3/K4/K5
     launch on the tensor-core route.
Any failed check raises, so the script exits nonzero and prints no verdict.
The line before the verdict lists every kernel with its launches on the main
paths, its error and time against its plain version, its bound (the least
time the card could take for the same work: the bytes it must move at 3.35
TB/s or its operations at the card's peak for their type, whichever is
larger), where one PyTorch call computes the same function that call's time,
and its device time (CUDA-graph replay; K10: its two launches under
torch.profiler, phase 23). The script imports nothing of JAX, tokenizers, transformers or PIL.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from construction_clip_tpu_torch import convert  # noqa: E402
from construction_clip_tpu_torch.core.configs import (  # noqa: E402
    CLIPConfig, ClipCapConfig, GPT2Config, T5Config)
from construction_clip_tpu_torch.core.mesh import (  # noqa: E402
    replicate, shard_batch, spawn_ranks)
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves  # noqa: E402
from construction_clip_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY  # noqa: E402
from construction_clip_tpu_torch.data import offline_assets  # noqa: E402
from construction_clip_tpu_torch.data.clip_tokenizer import ClipTokenizer  # noqa: E402
from construction_clip_tpu_torch.data.labels import (  # noqa: E402
    CAPTION_TYPE_PROMPTS, VIOLATION_TYPES, attribute_string)
from construction_clip_tpu_torch.data.preprocess import (  # noqa: E402
    preprocess_batch, preprocess_staged)
from construction_clip_tpu_torch.infer.caption import CaptionPipeline  # noqa: E402
from construction_clip_tpu_torch.infer.decode import greedy_decode  # noqa: E402
from construction_clip_tpu_torch.infer.precompute import make_embed_classify_fn  # noqa: E402
from construction_clip_tpu_torch.models import blocks, gpt2  # noqa: E402
from construction_clip_tpu_torch.models.clip.model import encode_image  # noqa: E402
from construction_clip_tpu_torch.models.clipcap.model import map_prefix  # noqa: E402
from construction_clip_tpu_torch.ops import _build  # noqa: E402
from construction_clip_tpu_torch.ops.attention import use_impl  # noqa: E402
from construction_clip_tpu_torch.ops.attention_block import (  # noqa: E402
    fused_attention_block, fused_attention_block_plain)
from construction_clip_tpu_torch.ops.attention_block import (  # noqa: E402
    fused_attention_block_bwd, fused_attention_block_bwd_plain)
from construction_clip_tpu_torch.ops.collectives import (  # noqa: E402
    PeerBuffers, all_gather, all_gather_plain)
from construction_clip_tpu_torch.ops.attention_block_int8 import (  # noqa: E402
    fused_attention_block_int8, fused_attention_block_int8_plain, gemm_route)
from construction_clip_tpu_torch.ops.decode_attention import (  # noqa: E402
    chunk_count, decode_step_attention, decode_step_attention_plain)
from construction_clip_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from construction_clip_tpu_torch.ops.mlp import (  # noqa: E402
    fused_mlp_residual, fused_mlp_residual_plain)
from construction_clip_tpu_torch.ops.preprocess import (  # noqa: E402
    normalize_u8, normalize_u8_plain)
from construction_clip_tpu_torch.ops.vocab_head import (  # noqa: E402
    vocab_head_logits, vocab_head_logits_plain)
from construction_clip_tpu_torch.serve.app import TorchPredictService  # noqa: E402
from construction_clip_tpu_torch.train import contrastive  # noqa: E402
from construction_clip_tpu_torch.train.state import TrainState, make_adamw  # noqa: E402

K1_SHAPES = ((8, 50, 768, 12, False),   # ViT-B/32 image tower, batch 8
             (9, 77, 512, 8, True),     # text tower, 9 violation-type prompts
             (2, 77, 512, 8, True),     # text tower, 2 caption-type prompts
             (36, 50, 768, 12, False),  # training: ViT-B/32 image tower, 4 groups of 9
             (36, 77, 512, 8, True),    # training: ViT-B/32 text tower
             (9, 77, 768, 12, True))    # training: ViT-L/14 text tower, 1 group of 9
# bf16 keeps 8 significant bits: one rounding step is up to 2^-7 of the value,
# and a different summation order can flip the rounding of qkv, p and the
# output. fp32: the same math with the sums in another order.
K1_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-4, 2e-4)}   # (atol, rtol)
# K2 rounds once, at the output: at most one bf16 step apart; fp32 order only.
K2_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
K2_SHAPES = (dict(layers=12, rows=24, heads=12, t_max=140, dh=64),   # 8 images x beam 3
             dict(layers=12, rows=3, heads=12, t_max=140, dh=64))    # 1 image x beam 3
K2_CACHE_LENS = (0, 39, 90, 139)   # the first step alone ... t_max - 1

K3_SHAPES = ((36, 50, 768, 12, False),   # ViT-B/32 image tower, 4 groups of 9
             (36, 77, 512, 8, True),     # ViT-B/32 text tower
             (9, 77, 768, 12, True))     # ViT-L/14 text tower, 1 group of 9
# gradients, as the largest difference over the plain version's largest
# element: fp32 by summation order; bf16 by single roundings of qkv, dmg, p and
# ds that another order can flip (one bf16 step is 2^-8)
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
FLASH_SHAPES = ((9, 16, 257, 64, False),   # ViT-L/14 image tower, B=9
                (9, 12, 77, 64, True),     # a causal text-tower shape
                (2, 8, 1024, 64, True),    # the longest T the gate admits, causal
                (4, 16, 65, 64, False))    # one key alone in the last 64-key tile
# the forward rounds p to bf16 relative to a running max in K4 and to the
# final max in the plain version: a bf16 step apart at most
FLASH_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-5, 2e-5)}
# fp32 training parity: every gradient leaf by relative norm difference; the
# kernel and plain paths differ by summation order through 12 layers
TRAIN_GRAD_TOL = 1e-3
# K8: exact products (bf16 x times bf16 or int8 table) summed in fp32 in another
# order than the plain version's GEMM, relative to its largest logit
K8_TOL = 1e-5
K8_SHAPES = ((1, 512, 250112), (8, 512, 250112),   # mT5-small's head at B=1 and B=8
             (3, 512, 250001))                      # V not a multiple of the 256-column tile
# mT5 kernel path against plain path in bf16, relative to the largest logit: one
# bf16 step is 2^-8 of a value
T5_LOGIT_TOL = 1e-2

KERNELS = {
    "fused_attention_block": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/attention_block.cu",
        replaces="construction_clip_tpu/ops/pallas_attention_block.py:402"),
    "decode_step_attention": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/decode_attention.cu",
        replaces="construction_clip_tpu/ops/pallas_decode_attention.py:92"),
    "fused_attention_block_bwd": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/attention_block_bwd.cu",
        replaces="construction_clip_tpu/ops/pallas_attention_block.py:341"),
    "flash_attention_fwd": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/flash_attention.cu",
        replaces="construction_clip_tpu/ops/pallas_attention.py:346"),
    "flash_attention_bwd": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/flash_attention.cu",
        replaces="construction_clip_tpu/ops/pallas_attention.py:303"),
    "normalize_u8": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/normalize_u8.cu",
        replaces="construction_clip_tpu/ops/pallas_preprocess.py:50"),
    "fused_attention_block_int8": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/attention_block_int8.cu",
        replaces="construction_clip_tpu/ops/pallas_attention_block_int8.py:94"),
    "vocab_head_logits": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/vocab_head.cu",
        replaces="construction_clip_tpu/ops/pallas_vocab_head.py:77"),
    "fused_mlp_residual": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/mlp_residual.cu",
        replaces="construction_clip_tpu/ops/pallas_mlp.py:55"),
    "all_gather": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/all_gather.cu",
        replaces="construction_clip_tpu/ops/pallas_collectives.py:58"),
}
WRAPPERS = {"fused_attention_block": fused_attention_block,
            "decode_step_attention": decode_step_attention,
            "fused_attention_block_bwd": fused_attention_block_bwd,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "normalize_u8": normalize_u8,
            "fused_attention_block_int8": fused_attention_block_int8,
            "vocab_head_logits": vocab_head_logits,
            "fused_mlp_residual": fused_mlp_residual,
            "all_gather": all_gather}

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# HBM bytes/s and operations/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
# K7 against its plain version, relative to the plain output's largest element:
# sums in another order, and an ulp of an fp32 row can move one int8 value by
# one step (~7e-4 of the largest output); bf16 adds one rounding of qkv and of
# the output (2^-8 each) that such a step can flip
K7_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}
K7_SHAPES = ((8, 50, 768, 12), (1, 50, 768, 12))   # the int8 image tower at B=8 and B=1
# int8 kernel path against int8 plain path, relative to the largest feature: the
# plain path rounds the LN output, the merged heads and the residual to bf16
# where K7 does not (2.0e-2 between the port's two paths at ViT-B/32 on the CPU)
INT8_FEATURE_TOL = 5e-2
# int8 decode, kernel path against plain path, relative to the largest logit:
# the steps run bf16 activations, where K2's fp32 sums in another order can flip
# a bf16 rounding (2^-8 relative); where that element is its row's largest, the
# row's int8 scale changes and many of its int8 values move by a step, through
# 12 layers (1.8e-2 measured on the H100)
INT8_LOGIT_TOL = 5e-2
# K9 against its plain version, relative to the plain output's largest element:
# fp32 by summation order (LN statistics, both GEMMs); bf16 adds single
# roundings of h, the pre-activation, each QuickGELU step and the output that
# another order can flip (one bf16 step is 2^-8)
K9_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}
K9_RUNS = (((8, 50, 768, 3072), torch.bfloat16),   # ViT-B/32 image tower, batch 8
           ((8, 50, 768, 3072), torch.float32),
           ((36, 50, 768, 3072), torch.bfloat16),  # training: 4 groups of 9
           ((9, 77, 512, 2048), torch.bfloat16))   # text tower, 9 violation-type prompts
K6_SHAPE = (8, 224, 224, 3)   # the staged zero-shot path, batch 8
# K6 cases (shape, misaligned): the staged path; a bandwidth shape whose 38.5 MB
# in and 77 MB of bf16 out exceed the 50 MB L2; 105 elements (13 of a thread's
# 16-byte stores of 8 bf16, or 26 of 4 fp32, and a scalar tail of 1); a view one
# byte past an allocation's start (the scalar path)
K6_CASES = ((K6_SHAPE, False), ((256, 224, 224, 3), False), ((1, 7, 5, 3), False),
            (K6_SHAPE, True))
# fused-MLP kernel path against plain path, tower features relative to the
# largest feature: bf16 as the int8 phase's bound; fp32 by summation order
# through 12 layers
FUSED_FEATURE_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
# K10 cases: the ViT-B/32 path's chunk (9 rows a rank, embed 512) in fp32 (the
# features' type under either policy) and bf16; ViT-L/14's embed 768; a chunk of
# 18,540 bytes, no multiple of 16; and a bandwidth shape of 8 MiB a rank
K10_WORLD = 4
K10_CASES = (((9, 512), torch.float32), ((9, 512), torch.bfloat16),
             ((9, 768), torch.float32), ((9, 515), torch.float32),
             ((4096, 1024), torch.bfloat16))
K10_LIBRARY = "not measurable on one card (NCCL refuses two ranks on one device)"
# the delayed-rank case: rank i % world sleeps this long on the host before call i
K10_DELAYED_CALLS, K10_DELAY_S = 50, 0.02
# the 4-rank fp32 step against the one-process step: every gradient leaf within
# DP_GRAD_TOL of that leaf's largest element. The ranks' gradients are four
# partial sums over 9 rows each, added in another order than the 36 rows of the
# one-process backward, and the encoders run at batch 9 against 36
DP_GRAD_TOL = 1e-4
# the ranks' bf16 losses (phases 24, 26) against the one-process run on the same
# params and batch, relative: the first step is the same forward on 9-row against
# 36-row GEMMs; later steps follow AdamW updates from bf16 gradients summed in
# another order, and AdamW's first steps move a weight by about lr whatever the
# size of its gradient, so a rounding that flips a near-zero gradient's sign
# moves that weight by 2 lr
DP_LOSS_TOL = {"first": 1e-3, "later": 2e-2}
# a phase's ranks, from spawn to the last result: CUDA context, the params'
# broadcast through the host, the steps
RANKS_TIMEOUT_S = 300


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, ensure_ascii=False), flush=True)


def median_ms(fn, windows: int = 21, per_window: int = 10) -> float:
    """Median over `windows` CUDA-event windows of `per_window` back-to-back
    calls, per call, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph, its
    replay timed as median_ms times a call, so the host's launch costs (the
    Python wrapper, the ctypes call) drop out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return median_ms(graph.replay, 11, 1) / reps


def compare(got, want, atol: float, rtol: float, what: str) -> dict:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    worst = float((err / bound).max())
    stats = {"max_abs_err": float(err.max()), "max_rel_err": float(err.max() / want.abs().max()),
             "atol": atol, "rtol": rtol}
    if worst > 1.0:
        raise AssertionError(f"{what}: kernel and plain version disagree: {stats}")
    return stats


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: int, ops: dict) -> dict:
    """The least time the card could take: `moved_bytes` over the HBM rate or
    the operations ({dtype: count}) over the peak for their type, the larger."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = sum(count / PEAK_OPS_PER_S[dtype] for dtype, count in ops.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_ops(b, h, t, dh, products: int) -> int:
    """Multiply-adds (2 operations each) of `products` [t, t, dh] products per
    (batch, head)."""
    return 2 * b * h * t * t * dh * products


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    print(smi, flush=True)
    say("device", **info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    say("build", seconds=time.perf_counter() - t0,
        libraries=[p.name for p in _build.build_all()])


def _block_inputs(rng, b, t, d, dtype, dev):
    def arr(*shape, scale=1.0, offset=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    x = arr(b, t, d)
    ln = {"scale": arr(d, scale=0.1, offset=1.0), "bias": arr(d, scale=0.1)}
    attn = {"w_qkv": arr(d, 3 * d, scale=d ** -0.5), "b_qkv": arr(3 * d, scale=0.1),
            "w_out": arr(d, d, scale=d ** -0.5), "b_out": arr(d, scale=0.1)}
    return x, ln, attn


def phase_k1(results: dict) -> None:
    rng = np.random.default_rng(1)
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, d, h, causal in K1_SHAPES:
            x, ln, attn = _block_inputs(rng, b, t, d, dtype, "cuda")
            args = (ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"],
                    attn["b_out"])

            def kernel():
                return fused_attention_block(x, ln, attn, n_heads=h, causal=causal)

            def plain():
                return fused_attention_block_plain(x, *args, n_heads=h, causal=causal)

            def composed():
                return composed_block(x, *args, n_heads=h, causal=causal)

            tc_before = fused_attention_block.tc_launches
            got = kernel()
            torch.cuda.synchronize()
            what = f"K1 {[b, t, d]} h={h} causal={causal} {dtype}"
            on_tc = fused_attention_block.tc_launches != tc_before
            if on_tc != (dtype == torch.bfloat16):
                raise AssertionError(f"{what}: the tensor-core route's counter "
                                     f"{'moved' if on_tc else 'did not move'}")
            stats = compare(got, plain(), *K1_TOL[dtype], what=what)
            stats.update(ms=median_ms(kernel), plain_ms=median_ms(plain),
                         route="tc" if on_tc else "simt")
            if dtype == torch.bfloat16:   # device times, the host's launch costs left out
                stats.update(device_ms=graph_ms(kernel), composed_device_ms=graph_ms(composed),
                             launch_device_ms=kernel_device_ms(kernel))
            say("k1", shape=[b, t, d], heads=h, causal=causal, dtype=str(dtype), **stats)
            if (b, t, d) == (8, 50, 768) and dtype == torch.bfloat16:
                m = b * t
                stats.update(bound(nbytes(x, *args, x), {dtype: 2 * m * d * 4 * d + attention_ops(
                    b, h, t, d // h, 2)}), library_ms=None)   # no single PyTorch call
                results["fused_attention_block"] = stats


def k2_yardstick(q, ck, cv, layer, cache_len, ancestry):
    """The window gathered by torch.gather, then scaled_dot_product_attention:
    several PyTorch calls computing K2's function (used nowhere in the port)."""
    n = cache_len + 1
    k, v = ck[layer][:, :, :n], cv[layer][:, :, :n]
    if ancestry is not None:
        idx = ancestry[:, None, :n, None].long().expand(-1, k.shape[1], -1, k.shape[3])
        k, v = torch.gather(k, 0, idx), torch.gather(v, 0, idx)
    return sdpa(q[:, :, None, :], k, v, is_causal=False, scale=q.shape[-1] ** -0.5)[:, :, 0]


def phase_k2(results: dict) -> None:
    rng = np.random.default_rng(2)
    for s in K2_SHAPES:
        cache_shape = (s["layers"], s["rows"], s["heads"], s["t_max"], s["dh"])
        layer = s["layers"] - 1
        for dtype in (torch.bfloat16, torch.float32):
            def arr(*shape):
                return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
                    device="cuda", dtype=dtype)

            ck, cv = arr(*cache_shape), arr(*cache_shape)
            q = arr(s["rows"], s["heads"], s["dh"])
            anc = torch.from_numpy(rng.integers(0, s["rows"], (s["rows"], s["t_max"]),
                                                dtype=np.int32)).cuda()
            for cache_len in K2_CACHE_LENS:
                for ancestry in (None, anc):
                    def kernel():
                        return decode_step_attention(q, ck, cv, layer, cache_len, ancestry)

                    def plain():
                        return decode_step_attention_plain(q, ck, cv, layer, cache_len,
                                                           ancestry)

                    got = kernel()
                    torch.cuda.synchronize()
                    stats = compare(got, plain(), *K2_TOL[dtype],
                                    what=f"K2 R={s['rows']} cache_len={cache_len} "
                                         f"ancestry={ancestry is not None} {dtype}")
                    if not torch.equal(kernel(), got):
                        raise AssertionError(f"K2 R={s['rows']} cache_len={cache_len}: two "
                                             f"runs differ")
                    stats.update(ms=median_ms(kernel), plain_ms=median_ms(plain),
                                 chunks=chunk_count(s["rows"], s["heads"], cache_len + 1))
                    timed = cache_len == K2_CACHE_LENS[-1] and ancestry is not None and \
                        dtype == torch.bfloat16
                    if timed:   # device times, the host's launch costs left out

                        def yardstick():
                            return k2_yardstick(q, ck, cv, layer, cache_len, ancestry)

                        # each (cache row, position) the ancestry reaches is read once
                        rows_read = len(set(zip(anc[:, :cache_len + 1].flatten().tolist(),
                                                list(range(cache_len + 1)) * s["rows"])))
                        kv_bytes = 2 * rows_read * s["heads"] * s["dh"] * q.element_size()
                        stats.update(bound(
                            nbytes(q, q, anc[:, :cache_len + 1]) + kv_bytes,
                            {dtype: 2 * 2 * s["rows"] * s["heads"] * (cache_len + 1) *
                             s["dh"]}),
                            device_ms=graph_ms(kernel), library_ms=None,   # no single call
                            yardstick_ms=median_ms(yardstick),
                            yardstick_device_ms=graph_ms(yardstick))
                    say("k2", **s, cache_len=cache_len, ancestry=ancestry is not None,
                        dtype=str(dtype), **stats)
                    if timed and s is K2_SHAPES[0]:
                        results["decode_step_attention"] = stats


class CharTokenizer:
    """Character-level stand-in for the BERT-chinese tokenizer, over a vocab.txt:
    [CLS] + one id per non-space character ([UNK] when absent) + [SEP]; decode
    drops the special tokens and joins with spaces, as BERT's decode does."""

    SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

    def __init__(self, vocab_path: str):
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab = f.read().splitlines()
        self.ids = {tok: i for i, tok in enumerate(self.vocab)}

    def encode(self, text: str) -> list[int]:
        unk = self.ids["[UNK]"]
        return ([self.ids["[CLS]"]] + [self.ids.get(c, unk) for c in text if not c.isspace()]
                + [self.ids["[SEP]"]])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        # ids past the vocab (mT5's 250,112 outputs) decode as <id>
        toks = [self.vocab[int(i)] if int(i) < len(self.vocab) else f"<{int(i)}>" for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t not in self.SPECIAL]
        return " ".join(toks)


def tokenizers(tmp: str):
    """The 49,408-token CLIP BPE and the 21,128-entry BERT vocab, written by
    the port's data/offline_assets.py into `tmp`."""
    merges = os.path.join(tmp, "clip_merges.txt.gz")
    offline_assets.write_clip_merges(merges)
    vocab = os.path.join(tmp, "vocab.txt")
    offline_assets.write_bert_vocab(vocab, offline_assets.corpus_characters([]))
    clip_tok = ClipTokenizer(merges)
    if clip_tok.vocab_size != CLIPConfig().text.vocab_size:
        raise AssertionError(f"CLIP tokenizer vocab {clip_tok.vocab_size}")
    return clip_tok, CharTokenizer(vocab)


def synthetic_images(rng, shapes):
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8) for h, w in shapes]


# the kernels with a tensor-core route, each counting its launches there
TC_WRAPPERS = ("fused_attention_block", "fused_attention_block_bwd", "flash_attention_fwd",
               "flash_attention_bwd", "fused_mlp_residual", "fused_attention_block_int8")


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for name in TC_WRAPPERS:
        WRAPPERS[name].tc_launches = 0
    for fn in (flash_attention_fwd, flash_attention_bwd):   # K4/K5's other route
        fn.simt_launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def tc_launches() -> dict:
    return {name: WRAPPERS[name].tc_launches for name in TC_WRAPPERS}


def check_tc_route(what: str, counts: dict, tc: dict, names=TC_WRAPPERS) -> None:
    """In a bf16 run every launch of `names` (kernels with a tensor-core route
    at the port's dh = 64) took that route."""
    if any(tc[n] != counts[n] for n in names):
        raise AssertionError(f"{what}: launches off the tensor-core route: "
                             f"{ {n: tc[n] for n in names} } of { {n: counts[n] for n in names} }")


SERVE_KERNELS = ("fused_attention_block", "decode_step_attention")


def phase_serve(clip_np, cap_np, cfgs, clip_tok, lm_tok, device) -> dict:
    """The serving path in bf16: TorchPredictService over the port's
    CaptionPipeline (beam 3, 100 steps), 10 requests from 4 threads with a 20 ms
    coalescing window."""
    import concurrent.futures as cf

    clip_cfg, gcfg, ccfg = cfgs
    reset_launches()
    pipe = CaptionPipeline(
        clip_params=convert.to_params(clip_np, dtype=torch.bfloat16, device=device),
        clip_cfg=clip_cfg,
        cap_params=convert.to_params(cap_np, dtype=torch.bfloat16, device=device),
        ccfg=ccfg, gcfg=gcfg, clip_tokenizer=clip_tok, lm_tokenizer=lm_tok,
        policy=BF16_POLICY)
    svc = TorchPredictService(pipe, batch_window_ms=20, max_batch=8)
    batch_sizes = []
    caption_batch = svc._caption_batch

    def counted(staged):
        batch_sizes.append(len(staged))
        return caption_batch(staged)

    svc._caption_batch = counted
    rng = np.random.default_rng(5)
    warm = synthetic_images(rng, [(480, 640)])[0]
    svc.predict(warm)  # first request: warm-up
    single = []
    for _ in range(3):
        t0 = time.perf_counter()
        svc.predict(warm)
        single.append(time.perf_counter() - t0)
    shapes = [(480, 640), (768, 1024), (256, 256), (600, 400), (1080, 1920)] * 2
    images = synthetic_images(rng, shapes)
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(4) as pool:
        responses = list(pool.map(svc.predict, images))
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launches().items() if k in SERVE_KERNELS}
    check_tc_route("serving bf16", counts, tc_launches(), ("fused_attention_block",))
    for r in responses:
        if r["caption_type"] not in ("violation", "status") or \
                r["violation_type"] not in VIOLATION_TYPES or not isinstance(r["caption"], str):
            raise AssertionError(f"bad response {r}")
    if max(batch_sizes) < 2:
        raise AssertionError(f"no coalesced batch formed: {batch_sizes}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the serving path never launched: {counts}")
    say("serve", requests=len(images), threads=4, wall_s=wall, req_per_s=len(images) / wall,
        warm_single_request_s=statistics.median(single), batch_sizes=batch_sizes,
        launches=counts, captions=[r["caption"][:24] for r in responses[:3]])
    return counts


def teacher_forced_logits(params, gcfg, embeds, tokens, impl: str):
    """Logits [B, steps, V] of each greedy step, fed `tokens` [B, steps] after
    the prompt `embeds`, on the `impl` path."""
    with use_impl(impl), torch.inference_mode():
        last, cache = gpt2.gpt2_forward(
            params, gcfg, inputs_embeds=embeds,
            cache=gpt2.KVCache.create(gcfg, embeds.shape[0], embeds.shape[1] + tokens.shape[1],
                                      device=embeds.device))
        out = []
        for step in range(tokens.shape[1]):
            out.append(last[:, -1])
            last, cache = gpt2.gpt2_forward(params, gcfg, tokens=tokens[:, step:step + 1],
                                            cache=cache)
    return torch.stack(out, dim=1)


def top2_gaps(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def plain_top2_gaps(params, gcfg, embeds, tokens):
    """Top-2 logit gap of the plain path at each greedy step, teacher-forced
    with the plain path's own tokens: [B, steps]."""
    return top2_gaps(teacher_forced_logits(params, gcfg, embeds, tokens, "plain"))


def phase_parity(clip_np, cap_np, cfgs, clip_tok, lm_tok, device) -> None:
    """Kernel path against plain path in fp32."""
    cfg, gcfg, ccfg = cfgs
    clip_p = as_tree(convert.to_params(clip_np, device=device))
    cap_p = as_tree(convert.to_params(cap_np, device=device))
    ct = clip_tok.tokenize(list(CAPTION_TYPE_PROMPTS), cfg.text.context_length)
    vt = clip_tok.tokenize(list(VIOLATION_TYPES), cfg.text.context_length)
    u8 = np.stack(synthetic_images(np.random.default_rng(6), [(256, 256)] * 8))
    images = preprocess_batch(u8, cfg.vision.image_size, device=device)
    out = {}
    for impl in ("kernel", "plain"):
        reset_launches()
        with use_impl(impl):
            out[impl] = make_embed_classify_fn(clip_p, cfg, ct, vt)(images)
        out[impl + "_launches"] = launches()["fused_attention_block"]
    (emb_k, ct_k, vt_k), (emb_p, ct_p, vt_p) = out["kernel"], out["plain"]
    if tuple(emb_k.shape) != (8, cfg.vision.embed_dim) or not torch.isfinite(emb_k).all():
        raise AssertionError(f"image features {tuple(emb_k.shape)} not finite/shaped")
    if out["kernel_launches"] == 0 or out["plain_launches"] != 0:
        raise AssertionError(f"paths not as asked: {out['kernel_launches']} kernel launches, "
                             f"{out['plain_launches']} on the plain path")
    feat_diff = float((emb_k - emb_p).abs().max())
    if feat_diff > 1e-3 or not torch.equal(ct_k, ct_p) or not torch.equal(vt_k, vt_p):
        raise AssertionError(f"image features differ by {feat_diff} or classes differ")

    attr = np.zeros((8, ccfg.attribute_length), np.int32)
    for i, (c, v) in enumerate(zip(ct_p.tolist(), vt_p.tolist())):
        ids = lm_tok.encode(attribute_string(CAPTION_TYPE_PROMPTS[c], VIOLATION_TYPES[v]))
        ids = ids[:ccfg.attribute_length]
        attr[i, :len(ids)] = ids
    with torch.inference_mode():
        embeds = torch.cat([map_prefix(cap_p["mapper"], ccfg, gcfg, emb_p),
                            gpt2.embed_tokens(cap_p["gpt"], torch.from_numpy(attr).to(device))],
                           dim=1)
    toks = {}
    for impl in ("kernel", "plain"):
        reset_launches()
        with use_impl(impl):
            toks[impl] = greedy_decode(cap_p["gpt"], gcfg, embeds, max_steps=32,
                                       stop_token=102).tokens
        toks[impl + "_launches"] = launches()["decode_step_attention"]
    if toks["kernel_launches"] == 0 or toks["plain_launches"] != 0:
        raise AssertionError("decode paths not as asked")
    gaps = plain_top2_gaps(cap_p["gpt"], gcfg, embeds, toks["plain"])
    mismatches = []
    for row in range(8):
        diff = (toks["kernel"][row] != toks["plain"][row]).nonzero()
        if len(diff):
            step = int(diff[0])
            gap = float(gaps[row, step])
            mismatches.append({"row": row, "step": step, "plain_top2_gap": gap})
            if gap >= 1e-3:
                raise AssertionError(f"greedy tokens differ at row {row} step {step} "
                                     f"with a top-2 gap of {gap}")
    say("parity", image_feature_max_abs_diff=feat_diff, classes_equal=True,
        greedy_steps=32, greedy_rows_equal=8 - len(mismatches), mismatches=mismatches,
        min_plain_top2_gap=float(gaps.min()))


def compare_scaled(got, want, tol: float, what: str) -> dict:
    """Largest difference against `tol` times the plain version's largest
    element (gradients of very different scales)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    stats = {"max_abs_err": err, "max_scaled_err": err / scale, "tol": tol}
    if err > tol * scale:
        raise AssertionError(f"{what}: kernel and plain version disagree: {stats}")
    return stats


def _merge(per: dict) -> dict:
    return {"max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "max_scaled_err": max(v["max_scaled_err"] for v in per.values()),
            "tol": next(iter(per.values()))["tol"]}


def backward_ms(forward, inputs, g) -> float:
    """The backward alone of `forward` on `inputs`: the gradients of one
    recorded forward, taken again and again."""
    leaves = [a.detach().requires_grad_() for a in inputs]
    out = forward(*leaves)
    return median_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 11, 3)


def backward_device_ms(forward, inputs, g, reps: int = 20) -> float:
    """The device time of that backward: `reps` autograd.grad calls captured in
    one CUDA graph (the forward recorded on the capture stream, so that the
    backward runs there), its replay timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [a.detach().requires_grad_() for a in inputs]
        out = forward(*leaves)

        def grad():
            return torch.autograd.grad(out, leaves, g, retain_graph=True)

        for _ in range(3):
            grad()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            grad()
    return median_ms(graph.replay, 11, 1) / reps


def sdpa(q, k, v, *, is_causal, scale):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=is_causal,
                                                            scale=scale)


def composed_block(x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, *, n_heads, causal):
    """The fused block composed of library calls: layer_norm, a Linear, SDPA
    and a Linear plus the residual (cuBLAS and SDPA; several calls, used
    nowhere in the port): the yardstick of the block's backward."""
    b, t, d = x.shape
    h = torch.nn.functional.layer_norm(x, (d,), ln_s, ln_b, eps=1e-5)
    qkv = torch.addmm(b_qkv, h.reshape(-1, d), w_qkv).view(b, t, 3, n_heads, d // n_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = sdpa(q, k, v, is_causal=causal, scale=(d // n_heads) ** -0.5)
    return x + torch.addmm(b_out, o.transpose(1, 2).reshape(-1, d), w_out).view(b, t, d)


def kernel_device_ms(fn, reps: int = 20) -> dict:
    """{kernel: device ms a call} of every kernel `fn` launches, summed under
    torch.profiler over `reps` calls; names without namespaces and arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per: dict = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            found = re.search(r"(\w+(<[^()]*>)?)\(", e.key)
            name = found.group(1) if found else e.key
            per[name] = per.get(name, 0.0) + e.self_device_time_total / reps / 1e3
    if not per:
        raise AssertionError("torch.profiler saw no device time")
    return per


def backward_kernels(forward, inputs, g) -> dict:
    """{kernel: device ms} of the backward of `forward` on `inputs`."""
    leaves = [a.detach().requires_grad_() for a in inputs]
    out = forward(*leaves)
    return kernel_device_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))


# K3's tensor-core GEMMs by epilogue (gemm.cuh's Epilogue: kQkv 0, kRound 2,
# kFloat 3): what each computes, and its multiply-adds in rows x D x D
K3_GEMMS = {"gemm_tc<0": ("qkv = T(h W_qkv + b)", 3), "gemm_tc<2": ("dmg = T(g W_out^T)", 1),
            "gemm_tc<3": ("dh = dqkv W_qkv^T", 3)}


def k3_launches(per: dict, rows: int, d: int) -> dict:
    """K3's launches with their device ms, and each GEMM's TFLOP/s; every
    tensor-core GEMM must be there."""
    out = {}
    for name, ms in per.items():
        out[name] = {"ms": ms}
        gemm = next((v for k, v in K3_GEMMS.items() if name.startswith(k)), None)
        if gemm:
            out[name].update(what=gemm[0], tflop_per_s=2 * rows * d * d * gemm[1] / ms / 1e9)
    if {k for k in K3_GEMMS for n in out if n.startswith(k)} != set(K3_GEMMS):
        raise AssertionError(f"K3's profile lacks a tensor-core GEMM: {sorted(out)}")
    return out


def phase_k3(results: dict) -> None:
    rng = np.random.default_rng(7)
    names = ("dx", "dqkv", "merged", "dln_scale", "dln_bias")
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, d, h, causal in K3_SHAPES:
            x, ln, attn = _block_inputs(rng, b, t, d, dtype, "cuda")
            g = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(
                "cuda", dtype)
            args = (ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"])
            block_args = (x, *args, attn["b_out"])

            def kernel():
                return fused_attention_block_bwd(x, g, *args, n_heads=h, causal=causal)

            def plain():
                return fused_attention_block_bwd_plain(x, g, *args, n_heads=h, causal=causal)

            def fused_block(x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out):
                return fused_attention_block(
                    x, {"scale": ln_s, "bias": ln_b},
                    {"w_qkv": w_qkv, "b_qkv": b_qkv, "w_out": w_out, "b_out": b_out},
                    n_heads=h, causal=causal)

            def composed(*a):
                return composed_block(*a, n_heads=h, causal=causal)

            tc_before = fused_attention_block_bwd.tc_launches
            got = kernel()
            torch.cuda.synchronize()
            what = f"K3 {[b, t, d]} h={h} causal={causal} {dtype}"
            on_tc = fused_attention_block_bwd.tc_launches != tc_before
            if on_tc != (dtype == torch.bfloat16):
                raise AssertionError(f"{what}: the tensor-core route's counter "
                                     f"{'moved' if on_tc else 'did not move'}")
            per = {n: compare_scaled(a, w, GRAD_TOL[dtype], f"{what} {n}")
                   for n, a, w in zip(names, got, plain())}
            stats = _merge(per)
            stats.update(ms=median_ms(kernel, 11, 3), plain_ms=median_ms(plain, 11, 3),
                         route="tc" if on_tc else "simt")
            if dtype == torch.bfloat16:   # device times, the host's launch costs left out
                stats.update(
                    device_ms=graph_ms(kernel),
                    launch_device_ms=k3_launches(kernel_device_ms(kernel), b * t, d),
                    block_backward_ms=backward_ms(fused_block, block_args, g),
                    block_backward_device_ms=backward_device_ms(fused_block, block_args, g),
                    yardstick_backward_ms=backward_ms(composed, block_args, g),
                    yardstick_backward_device_ms=backward_device_ms(composed, block_args, g))
            if (b, t, d) == K3_SHAPES[0][:3] and dtype == torch.bfloat16:
                stats.update(block_backward_kernels=backward_kernels(fused_block, block_args, g),
                             yardstick_backward_kernels=backward_kernels(composed, block_args, g))
            say("k3", shape=[b, t, d], heads=h, causal=causal, dtype=str(dtype),
                scaled_err={n: v["max_scaled_err"] for n, v in per.items()}, **stats)
            if (b, t, d) == K3_SHAPES[0][:3] and dtype == torch.bfloat16:
                m = b * t   # recomputed qkv, dmg, dh GEMMs; six attention products
                stats.update(bound(nbytes(x, g, *args, *got),
                                   {dtype: 2 * m * d * 7 * d + attention_ops(b, h, t, d // h, 6)}),
                             library_ms=None)
                results["fused_attention_block_bwd"] = stats


# the tensor-core routes' kernels by source: K4/K5's (forward; the backward's
# statistics, dq and dk/dv passes), K3's (its GEMMs and the same passes), K1's
# (its GEMMs and its attention pass), K9's (its GEMMs) and K7's (its int8
# GEMMs, IGMMA, and its attention pass)
TC_KERNELS = {"flash_attention.cu": ("tc_fwd", "tc_stats", "tc_dq", "tc_dkv"),
              "attention_block_bwd.cu": ("gemm_tc", "tc_stats", "tc_dq", "tc_dkv"),
              "attention_block.cu": ("gemm_tc", "tc_block_fwd"),
              "mlp_residual.cu": ("gemm_tc",),
              "attention_block_int8.cu": ("gemm_s8", "tc_block_fwd")}
INT_KERNELS = ("gemm_s8",)   # integer wgmma: IGMMA in the SASS, not HGMMA


def tensor_core_counts(source: str) -> dict:
    """{kernel: {"HGMMA": n, "IGMMA": n, "HMMA": n, "registers": n}}: the
    tensor-core instructions (wgmma in floats and integers, mma.sync) of each
    kernel in the built library of
    `source`, from `cuobjdump -sass`, and its registers a thread, from
    `cuobjdump -res-usage` (None where that output does not say)."""
    src = next(p for p in _build.sources() if p.name == source)
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([cuobjdump, flag, str(_build.library_path(src))],
                              capture_output=True, text=True, check=True, timeout=120).stdout

    counts, kernel = {}, None
    for line in dump("-sass").splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            kernel = found.group(1)
            counts[kernel] = {"HGMMA": 0, "IGMMA": 0, "HMMA": 0, "registers": None}
        elif kernel:
            for name in ("HGMMA", "IGMMA", "HMMA"):
                counts[kernel][name] += name in line
    kernel = None
    for line in dump("-res-usage").splitlines():
        found = re.search(r"Function (\S+?):", line)
        if found:
            kernel = found.group(1)
        elif kernel in counts and "REG:" in line:
            counts[kernel]["registers"] = int(re.search(r"REG:(\d+)", line).group(1))
    return counts


def k5_pass_device_ms(bwd) -> dict:
    """Device ms a call of each of K5's three tensor-core launches."""
    launched = kernel_device_ms(bwd)
    per = {name: sum(ms for k, ms in launched.items() if k == name or k.startswith(name + "<"))
           for name in TC_KERNELS["flash_attention.cu"][1:]}
    if min(per.values()) <= 0:
        raise AssertionError(f"torch.profiler saw no device time for a pass of K5: {per}")
    return per


def phase_tensor_cores() -> None:
    """Every kernel of a tensor-core route runs wgmma (HGMMA in its SASS;
    IGMMA for K7's int8 GEMMs)."""
    for source, names in TC_KERNELS.items():
        counts = tensor_core_counts(source)
        say("tensor_core_instructions", source=source, counts=counts)
        for name in names:
            op = "IGMMA" if name in INT_KERNELS else "HGMMA"
            got = [c[op] for k, c in counts.items() if name in k]
            if not got or min(got) <= 0:
                raise AssertionError(f"{source} {name}: a kernel without {op} in the build: "
                                     f"{counts}")


def phase_flash(results: dict) -> None:
    rng = np.random.default_rng(8)
    phase_tensor_cores()
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, t, dh, causal in FLASH_SHAPES:
            q, k, v, g = (torch.from_numpy(rng.standard_normal((b, h, t, dh))
                                           .astype(np.float32)).to("cuda", dtype)
                          for _ in range(4))
            kw = dict(is_causal=causal, scale=dh ** -0.5)
            what = f"{[b, h, t, dh]} causal={causal} {dtype}"

            def fwd():
                return flash_attention_fwd(q, k, v, **kw)

            def fwd_plain():
                return flash_attention_fwd_plain(q, k, v, **kw)

            def bwd():
                return flash_attention_bwd(q, k, v, g, **kw)

            def bwd_plain():
                return flash_attention_bwd_plain(q, k, v, g, **kw)

            route = "tc_launches" if dtype == torch.bfloat16 else "simt_launches"
            before = (getattr(flash_attention_fwd, route), getattr(flash_attention_bwd, route))
            got = fwd()
            torch.cuda.synchronize()
            f_stats = compare(got, fwd_plain(), *FLASH_TOL[dtype], what=f"K4 {what}")
            f_stats.update(ms=median_ms(fwd, 11, 5), plain_ms=median_ms(fwd_plain, 11, 5))
            got = bwd()
            torch.cuda.synchronize()
            if (getattr(flash_attention_fwd, route) == before[0] or
                    getattr(flash_attention_bwd, route) == before[1]):
                raise AssertionError(f"K4/K5 {what}: no launch counted on {route}")
            per = {n: compare_scaled(a, w, GRAD_TOL[dtype], f"K5 {what} {n}")
                   for n, a, w in zip(("dq", "dk", "dv"), got, bwd_plain())}
            b_stats = _merge(per)
            b_stats.update(ms=median_ms(bwd, 11, 3), plain_ms=median_ms(bwd_plain, 11, 3))
            if dtype == torch.bfloat16:   # device times, the host's launch costs left out
                f_stats.update(device_ms=graph_ms(fwd),
                               library_ms=median_ms(lambda: sdpa(q, k, v, **kw), 11, 5),
                               library_device_ms=graph_ms(lambda: sdpa(q, k, v, **kw)))
                b_stats.update(device_ms=graph_ms(bwd), pass_device_ms=k5_pass_device_ms(bwd),
                               library_ms=backward_ms(lambda *a: sdpa(*a, **kw), (q, k, v), g),
                               library_device_ms=backward_device_ms(lambda *a: sdpa(*a, **kw),
                                                                    (q, k, v), g))
            say("k4", shape=[b, h, t, dh], causal=causal, dtype=str(dtype), route=route,
                **f_stats)
            say("k5", shape=[b, h, t, dh], causal=causal, dtype=str(dtype), route=route,
                scaled_err={n: v["max_scaled_err"] for n, v in per.items()}, **b_stats)
            if (b, h, t, dh) == FLASH_SHAPES[0][:4] and dtype == torch.bfloat16:
                f_stats.update(bound(nbytes(q, k, v, q), {dtype: attention_ops(b, h, t, dh, 2)}))
                # the function's products: s, then dp, dv, dq and dk (the
                # Pallas kernel's cost estimate, 10 T^2 dh a head)
                b_stats.update(bound(nbytes(q, k, v, g, *got),
                                     {dtype: attention_ops(b, h, t, dh, 5)}))
                results["flash_attention_fwd"] = f_stats
                results["flash_attention_bwd"] = b_stats


def class_balanced_batch(cfg, clip_tok, groups: int, seed: int, device) -> dict:
    """`groups` groups of one synthetic image per violation type, each paired
    with its type's text, as apps/train_clip.py batches PairGroupDataset."""
    rng = np.random.default_rng(seed)
    texts = list(VIOLATION_TYPES) * groups
    u8 = np.stack(synthetic_images(rng, [(256, 256)] * len(texts)))
    return {"images": preprocess_batch(u8, cfg.vision.image_size, device=device),
            "tokens": torch.from_numpy(clip_tok.tokenize(texts, cfg.text.context_length)
                                       ).to(device)}


def phase_train(name: str, cfg, params_np, batch, steps: int, device) -> dict:
    """`steps` bf16 make_train_step steps on one batch (lr 1e-4, no warmup),
    with the launch counts of that run."""
    params = convert.to_params(params_np, device=device, trainable=True)
    tx = make_adamw(1e-4, warmup_steps=0, total_steps=1000)
    state = TrainState.create(params, tx)
    step = contrastive.make_train_step(cfg, tx, policy=BF16_POLICY, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))   # waits for the step
        times.append(time.perf_counter() - t0)
        say(f"train_{name}_step", step=i + 1, loss=losses[-1],
            accuracy=float(m["accuracy"]), ms=times[-1] * 1e3)
    counts, tc = launches(), tc_launches()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: loss not finite: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the device's share of a step: its kernels' time under torch.profiler over
    # two more steps, against the median step on the host's clock
    step_device_ms = sum(kernel_device_ms(lambda: step(state, batch), reps=2).values())
    out = {"batch": int(batch["tokens"].shape[0]), "steps": steps, "losses": losses,
           "median_step_ms": statistics.median(times) * 1e3, "step_device_ms": step_device_ms,
           "peak_memory_gib": peak, "launches": counts, "tc_launches": tc}
    say(f"train_{name}", **out)
    return out


def _paths(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}"


def phase_train_parity(cfg, params_np, batch, device,
                       need=("fused_attention_block", "fused_attention_block_bwd"),
                       name="train_parity") -> None:
    """2 fp32 steps from the same params on the kernel path and on the plain
    path; the loss and every gradient leaf of both steps compared. A leaf's
    error is ||g_kernel - g_plain|| / (||g_plain|| + 1e-6 ||G||), G all of the
    plain gradient: the key bias has a gradient that is mathematically zero
    (rounding noise on both paths), which the second term keeps from counting
    as a relative error."""
    from construction_clip_tpu_torch.core.params import tree_leaves
    from construction_clip_tpu_torch.train.state import apply_gradients

    runs = {}
    for impl in ("kernel", "plain"):
        params = convert.to_params(params_np, device=device, trainable=True)
        tx = make_adamw(1e-4, warmup_steps=0, total_steps=1000)
        state = TrainState.create(params, tx)
        reset_launches()
        steps = []
        with use_impl(impl):
            for _ in range(2):
                loss, _, grads = contrastive.loss_and_grads(
                    state.params, cfg, batch["images"], batch["tokens"])
                steps.append((float(loss), [g.detach().clone() for g in tree_leaves(grads)]))
                state = apply_gradients(state, grads, tx)
        runs[impl] = steps
        runs[impl + "_launches"] = launches()
    names = list(_paths(as_tree(state.params)))
    k_l, p_l = runs["kernel_launches"], runs["plain_launches"]
    if min(k_l[n] for n in need) == 0 or any(p_l.values()):
        raise AssertionError(f"paths not as asked: kernel {k_l}, plain {p_l}")
    report = []
    for i, ((lk, gk), (lp, gp)) in enumerate(zip(runs["kernel"], runs["plain"])):
        total = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in gp])))
        errs = {n: float(torch.linalg.vector_norm(a - b)
                         / (torch.linalg.vector_norm(b) + 1e-6 * total))
                for n, a, b in zip(names, gk, gp)}
        worst = max(errs, key=errs.get)
        loss_err = abs(lk - lp) / abs(lp)
        report.append({"step": i + 1, "loss_kernel": lk, "loss_plain": lp,
                       "loss_rel_err": loss_err, "worst_leaf": worst,
                       "worst_leaf_err": errs[worst]})
        if loss_err > 1e-5 or errs[worst] > TRAIN_GRAD_TOL:
            raise AssertionError(f"fp32 training parity, step {i + 1}: {report[-1]}")
    say(name, leaves=len(names), tol=TRAIN_GRAD_TOL, steps=report, kernel_launches=k_l)


def _vocab_head_inputs(rng, rows, d, v, int8, device):
    w = rng.standard_normal((d, v), dtype=np.float32) * np.float32(d ** -0.5)
    x = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(
        device, torch.bfloat16)
    if not int8:
        return x, torch.from_numpy(w).to(device, torch.bfloat16), None
    from construction_clip_tpu_torch.ops.quant import quantize_weight

    q, scale = quantize_weight(torch.from_numpy(w).to(device), axis=0)
    return x, q, scale


def phase_k8(results: dict) -> None:
    rng = np.random.default_rng(12)
    for rows, d, v in K8_SHAPES:
        for int8 in (False, True):
            x, table, scale = _vocab_head_inputs(rng, rows, d, v, int8, "cuda")

            def kernel():
                return vocab_head_logits(x, table, scale)

            def plain():
                return vocab_head_logits_plain(x, table, scale)

            got = kernel()
            torch.cuda.synchronize()
            mode = "int8" if int8 else "bf16"
            stats = compare_scaled(got, plain(), K8_TOL, f"K8 B={rows} V={v} {mode}")
            if not torch.equal(got, kernel()):
                raise AssertionError(f"K8 B={rows} V={v} {mode}: two runs differ")
            stats.update(ms=median_ms(kernel), plain_ms=median_ms(plain, 11, 3),
                         device_ms=graph_ms(kernel))
            table_bytes = table.numel() * table.element_size() + (
                scale.numel() * 4 if int8 else 0)
            say("k8", shape=[rows, d, v], table=mode, table_mb=table_bytes / 1e6,
                table_gb_per_s=table_bytes / (stats["ms"] * 1e-3) / 1e9,
                plain_gb_per_s=table_bytes / (stats["plain_ms"] * 1e-3) / 1e9, **stats)
            if (rows, v, int8) == (1, 250112, False):
                stats.update(bound(nbytes(x, table, got), {torch.bfloat16: 2 * rows * d * v}),
                             library_ms=median_ms(
                                 lambda: torch.mm(x, table, out_dtype=torch.float32)))
                results["vocab_head_logits"] = stats
            del x, table, scale


def _t5_caption_params(clip_np, t5_ccfg, tcfg, device):
    """ViT-B/32 and the ClipCap mT5-small stack in bf16 on `device`, with the
    bf16 head and with the int8 head (quantized after the cast)."""
    from construction_clip_tpu_torch.models.t5 import quantize_t5_head

    clip_p = convert.to_params(clip_np, dtype=torch.bfloat16, device=device)
    cap = as_tree(convert.to_params(convert.init_clipcap_t5(3, t5_ccfg, tcfg),
                                    dtype=torch.bfloat16, device=device))
    return clip_p, {"bf16": cap, "int8": dict(cap, t5=quantize_t5_head(cap["t5"]))}


def phase_t5_caption(clip_p, caps, cfgs, clip_tok, lm_tok, device) -> int:
    """The port's predict_t5 batch function at B=1 and B=8, sampled and
    greedy, bf16 and int8 head, 32 steps; then one B=16 call. Returns K8's
    launches over the B <= 8 calls."""
    from construction_clip_tpu_torch.apps.predict_t5 import make_process
    from construction_clip_tpu_torch.data.schema import Annotation

    clip_cfg, ccfg, tcfg = cfgs
    rng = np.random.default_rng(13)
    staged = np.stack(synthetic_images(rng, [(256, 256)] * 16))
    anns = [Annotation(id=i, file_name=f"site_{i}.jpg", caption=f"gt {i}") for i in range(16)]
    total = 0
    runs = [(b, head, greedy) for head in ("bf16", "int8") for b in (1, 8)
            for greedy in (False, True)] + [(16, "bf16", False)]
    for b, head, greedy in runs:
        process = make_process(clip_p, clip_cfg, caps[head], ccfg, tcfg, clip_tok, lm_tok,
                               max_length=32, greedy=greedy, policy=BF16_POLICY, device=device)
        with contextlib.redirect_stdout(io.StringIO()):   # the app prints each caption
            process(anns[:b], staged[:b])   # warm-up: first use of this batch size
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            records, res = process(anns[:b], staged[:b])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launches()
        steps = int(res.lengths.max())
        want = steps + 1 if b <= 8 else 0
        if counts["vocab_head_logits"] != want:
            raise AssertionError(f"T5 B={b} {head}: K8 launched {counts['vocab_head_logits']} "
                                 f"times, not {want} ({steps} steps)")
        if counts["fused_attention_block"] <= 0:
            raise AssertionError(f"T5 B={b}: the image tower did not run K1")
        toks = res.tokens
        if tuple(toks.shape) != (b, 32) or int(toks.min()) < 0 or \
                int(toks.max()) >= tcfg.vocab_size or len(records) != b or \
                not all(isinstance(r["caption"], str) and r["attribute"] for r in records):
            raise AssertionError(f"T5 B={b} {head}: bad output {tuple(toks.shape)} {records[:1]}")
        if b <= 8:
            total += counts["vocab_head_logits"]
        say("t5_caption", batch=b, head=head, greedy=greedy, steps=steps, wall_s=wall,
            tokens_per_s=b * steps / wall, launches=counts,
            captions=[r["caption"][:24] for r in records[:2]])
    return total


def phase_t5_steps(caps, cfgs, device) -> None:
    """Decode-step times: greedy generate, 32 steps that never stop (EOS id
    -1), on prefix-concatenated encoder states of 20 + 8 positions, timed by
    the host clock around a synchronised call; per decode call (steps + 1)."""
    from construction_clip_tpu_torch.infer.decode_t5 import t5_generate

    _, ccfg, tcfg = cfgs
    rng = np.random.default_rng(14)
    for head in ("bf16", "int8"):
        for b in (1, 8):
            hidden = torch.from_numpy(rng.standard_normal(
                (b, ccfg.prefix_length + 8, tcfg.d_model), dtype=np.float32)).to(
                device, torch.bfloat16)

            def run():
                return t5_generate(caps[head]["t5"], tcfg, hidden, max_steps=32, eos_id=-1,
                                   do_sample=False, policy=BF16_POLICY)

            run()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / 33)
            say("t5_step", batch=b, head=head, step_ms=statistics.median(times) * 1e3,
                tokens_per_s=b / statistics.median(times), runs_step_ms=[t * 1e3 for t in times])


def _t5_teacher_forced(params, tcfg, hidden, mask, tokens):
    """Logits [B, steps + 1, V] of the cached decode, fed `tokens` [B, steps]."""
    from construction_clip_tpu_torch.models.t5 import t5_decode, t5_init_cache

    b = hidden.shape[0]
    with torch.inference_mode():
        cache = t5_init_cache(params, tcfg, hidden, tokens.shape[1] + 1, policy=BF16_POLICY)
        feed = torch.cat([torch.zeros((b, 1), dtype=torch.int32, device=hidden.device),
                          tokens], dim=1)
        out = []
        for step in range(feed.shape[1]):
            logits, cache = t5_decode(params, tcfg, feed[:, step:step + 1], hidden,
                                      encoder_mask=mask, cache=cache, policy=BF16_POLICY)
            out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def phase_t5_parity(caps, cfgs, device) -> None:
    """bf16, B=8, both heads: the plain path's greedy tokens fed to both paths
    give logits within T5_LOGIT_TOL of the plain path's largest logit at every
    step; greedy tokens are equal wherever the plain path's top-2 gap exceeds
    that tolerance."""
    from construction_clip_tpu_torch.infer.decode_t5 import t5_generate
    from construction_clip_tpu_torch.models.clipcap.t5_model import encode_with_prefix

    _, ccfg, tcfg = cfgs
    rng = np.random.default_rng(15)
    ids = torch.from_numpy(rng.integers(100, 20000, (8, 8)).astype(np.int32)).to(device)
    ids[4:, 5:] = 0                                        # padded attribute ids
    emb = torch.from_numpy(rng.standard_normal((8, ccfg.clip_dim), dtype=np.float32)).to(device)
    for head in ("bf16", "int8"):
        cap = caps[head]
        with torch.inference_mode():
            hidden, mask = encode_with_prefix(cap, ccfg, tcfg, input_ids=ids,
                                              attention_mask=(ids != 0).int(), clip_embed=emb,
                                              policy=BF16_POLICY)
        out = {}
        for impl in ("kernel", "plain"):
            reset_launches()
            with use_impl(impl):
                out[impl] = t5_generate(cap["t5"], tcfg, hidden, encoder_mask=mask,
                                        max_steps=32, do_sample=False, policy=BF16_POLICY)
            out[impl + "_launches"] = launches()["vocab_head_logits"]
        if out["kernel_launches"] == 0 or out["plain_launches"] != 0:
            raise AssertionError(f"T5 paths not as asked: {out['kernel_launches']} kernel "
                                 f"launches, {out['plain_launches']} on the plain path")
        stream = out["plain"].tokens
        logits = {}
        for impl in ("kernel", "plain"):
            with use_impl(impl):
                logits[impl] = _t5_teacher_forced(cap["t5"], tcfg, hidden, mask, stream)
        stats = compare_scaled(logits["kernel"], logits["plain"], T5_LOGIT_TOL,
                               f"T5 {head} head logits")
        tol_abs = T5_LOGIT_TOL * float(logits["plain"].abs().max())
        top2 = logits["plain"][:, :-1].topk(2, dim=-1).values
        gaps = top2[..., 0] - top2[..., 1]
        mismatches = []
        for row in range(8):
            diff = (out["kernel"].tokens[row] != stream[row]).nonzero()
            if len(diff):
                step = int(diff[0])
                gap = float(gaps[row, step])
                mismatches.append({"row": row, "step": step, "plain_top2_gap": gap})
                if gap >= tol_abs:
                    raise AssertionError(f"T5 {head}: greedy tokens differ at row {row} step "
                                         f"{step} with a top-2 gap of {gap} >= {tol_abs}")
        say("t5_parity", head=head, steps=int(stream.shape[1]) + 1, gap_tol=tol_abs,
            greedy_rows_equal=8 - len(mismatches), mismatches=mismatches,
            min_plain_top2_gap=float(gaps.min()), **stats)


def _int8_block_inputs(rng, b, t, d, dtype, dev):
    """x, LN params and int8 attention params quantized by ops/quant.quantize_tree
    (the layout K7 and the int8 GEMM read), plus the same weights as floats."""
    from construction_clip_tpu_torch.ops.quant import quantize_tree

    x, ln, attn = _block_inputs(rng, b, t, d, torch.float32, dev)
    qattn = quantize_tree(attn, [("w_qkv",), ("w_out",)])
    for key in ("b_qkv", "b_out"):
        qattn[key] = qattn[key].to(dtype)
    return x.to(dtype), {k: v.to(dtype) for k, v in ln.items()}, qattn, \
        {k: v.to(dtype) for k, v in attn.items()}


def composed_int8_block(x, ln, qattn, *, n_heads):
    """The int8 block composed of library calls: models/clip/quant's
    composable math (int8_linear: cuBLASLt's int8 GEMM; layer_norm, softmax,
    einsum) off the kernel impl; K7's yardstick, used nowhere on the kernel
    path."""
    from construction_clip_tpu_torch.models.clip.quant import _attn_residual_q

    with use_impl("plain"):
        return _attn_residual_q(x, ln, qattn, n_heads)


def phase_k7(results: dict) -> None:
    """K7 against its plain version, with K1's time on the same float weights
    in bf16 and the composed int8 block's device time beside it."""
    rng = np.random.default_rng(15)
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, d, h in K7_SHAPES:
            x, ln, qattn, attn = _int8_block_inputs(rng, b, t, d, dtype, "cuda")
            args = (ln["scale"], ln["bias"], qattn["w_qkv"]["q"], qattn["w_qkv"]["s"],
                    qattn["b_qkv"], qattn["w_out"]["q"], qattn["w_out"]["s"], qattn["b_out"])

            def kernel():
                return fused_attention_block_int8(x, ln, qattn, n_heads=h)

            def plain():
                return fused_attention_block_int8_plain(x, *args, n_heads=h)

            tc_before = fused_attention_block_int8.tc_launches
            got = kernel()
            torch.cuda.synchronize()
            what = f"K7 {[b, t, d]} h={h} {dtype}"
            on_tc = fused_attention_block_int8.tc_launches != tc_before
            if on_tc != (dtype == torch.bfloat16):
                raise AssertionError(f"{what}: the tensor-core route's counter "
                                     f"{'moved' if on_tc else 'did not move'}")
            stats = compare_scaled(got, plain(), K7_TOL[dtype], what)
            stats.update(ms=median_ms(kernel), plain_ms=median_ms(plain),
                         device_ms=graph_ms(kernel), route="tc" if on_tc else "simt",
                         gemm=gemm_route(d))
            m = b * t
            ops = {torch.int8: 2 * m * d * 4 * d, dtype: attention_ops(b, h, t, d // h, 2)}
            stats.update(bound(nbytes(x, *args, x), ops), library_ms=None)   # no single call
            if dtype == torch.bfloat16:
                stats.update(k1_ms=median_ms(lambda: fused_attention_block(x, ln, attn,
                                                                           n_heads=h)),
                             launch_device_ms=kernel_device_ms(kernel),
                             composed_device_ms=graph_ms(
                                 lambda: composed_int8_block(x, ln, qattn, n_heads=h)))
            say("k7", shape=[b, t, d], heads=h, dtype=str(dtype), **stats)
            if (b, dtype) == (8, torch.bfloat16):
                results["fused_attention_block_int8"] = stats
    # the int8 GEMM of int8_linear with the weight K-contiguous (ops/quant.gemm_layout,
    # as quantize_tree stores it) against row-major, at decode and encode shapes
    from construction_clip_tpu_torch.ops.quant import gemm_layout, int8_matmul

    for m, k, n in ((24, 3072, 768), (24, 768, 21128), (400, 768, 2304)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).cuda()
        w_k = gemm_layout(w)
        if not torch.equal(int8_matmul(a, w_k), int8_matmul(a, w)):
            raise AssertionError(f"int8_matmul {[m, k, n]}: the two layouts differ")
        say("int8_gemm_layout", shape=[m, k, n],
            k_contiguous_ms=median_ms(lambda: int8_matmul(a, w_k)),
            row_major_ms=median_ms(lambda: int8_matmul(a, w)))


def _tree_bytes(tree) -> int:
    from construction_clip_tpu_torch.core.params import tree_leaves

    return sum(nbytes(t) for t in tree_leaves(tree))


def phase_int8_serve(clip_np, cap_np, clip_tok, lm_tok) -> dict:
    """int8 serving through the port's apps/serve.build_service (--int8,
    DEFAULT_POLICY, beam 3, 100 steps): 10 requests from 4 threads with a 20 ms
    coalescing window. The service quantizes, in the port, the trees of phase
    5's numpy seeds."""
    import concurrent.futures as cf

    from construction_clip_tpu_torch.apps import serve as serve_app

    args = serve_app.parse_args(["--int8", "--batch_window_ms", "20", "--max_batch", "8",
                                 "--device", "cuda"])
    svc = serve_app.build_service(args, clip_tok, lm_tok, torch.device("cuda"))
    # weight bytes by subtree: as served (int8 towers; the mapper stays fp32, as
    # the JAX package leaves it) and as the same trees would be in bf16
    served = {"clip": svc.pipe.clip_params, **as_tree(svc.pipe.cap_params)}
    int8_bytes = {name: _tree_bytes(tree) for name, tree in served.items()}
    bf16_bytes = {name: sum(a.size * 2 for a in _np_leaves(tree)
                            if np.issubdtype(a.dtype, np.floating))
                  for name, tree in (("clip", clip_np), *cap_np.items())}
    batch_sizes = []
    caption_batch = svc._caption_batch

    def counted(staged):
        batch_sizes.append(len(staged))
        return caption_batch(staged)

    svc._caption_batch = counted
    torch.cuda.synchronize()
    reset_launches()   # after setup: the label features ran the text tower (K1)
    rng = np.random.default_rng(5)
    warm = synthetic_images(rng, [(480, 640)])[0]
    svc.predict(warm)
    single = []
    for _ in range(3):
        t0 = time.perf_counter()
        svc.predict(warm)
        single.append(time.perf_counter() - t0)
    shapes = [(480, 640), (768, 1024), (256, 256), (600, 400), (1080, 1920)] * 2
    images = synthetic_images(rng, shapes)
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(4) as pool:
        responses = list(pool.map(svc.predict, images))
    wall = time.perf_counter() - t0
    counts = launches()
    for r in responses:
        if r["caption_type"] not in ("violation", "status") or \
                r["violation_type"] not in VIOLATION_TYPES or not isinstance(r["caption"], str):
            raise AssertionError(f"bad response {r}")
    if max(batch_sizes) < 2:
        raise AssertionError(f"no coalesced batch formed: {batch_sizes}")
    layers = CLIPConfig.vit_b_32().vision.layers
    k7, k2 = counts["fused_attention_block_int8"], counts["decode_step_attention"]
    if k7 != layers * len(batch_sizes) or counts["fused_attention_block"] != 0:
        raise AssertionError(f"image tower not on K7 alone: {counts}, {len(batch_sizes)} calls")
    check_tc_route("int8 serving bf16", counts, tc_launches(), ("fused_attention_block_int8",))
    if k2 <= 0 or k2 % GPT2Config().n_layer:
        raise AssertionError(f"K2 launched {k2} times, not 12 per decode step")
    say("int8_serve", requests=len(images), threads=4, wall_s=wall,
        req_per_s=len(images) / wall, warm_single_request_s=statistics.median(single),
        runs_single_request_s=single, batch_sizes=batch_sizes, image_tower_calls=len(batch_sizes),
        k7_per_image_tower_call=k7 / len(batch_sizes),
        k7_tc_launches=tc_launches()["fused_attention_block_int8"],
        decode_steps=k2 // GPT2Config().n_layer,
        launches=counts, served_tree_bytes=int8_bytes, bf16_tree_bytes=bf16_bytes,
        captions=[r["caption"][:24] for r in responses[:3]])
    return counts


def _np_leaves(tree):
    for value in tree.values():
        yield from (_np_leaves(value) if isinstance(value, dict) else [np.asarray(value)])


def phase_int8_parity(clip_np, cap_np, cfgs, clip_tok, lm_tok, device) -> None:
    """The int8 kernel path (K7 in the image tower, K2 in the decode) against
    the int8 plain path on the same quantized params and images: features
    within INT8_FEATURE_TOL; each class equal, or the plain path's top-2
    similarity gap at most 2 ||delta normalised feature|| (no larger gap can
    flip); from the plain path's prompt, teacher-forced decode logits within
    INT8_LOGIT_TOL, and greedy tokens equal, or parting only where the plain
    top-2 gap is at most twice the logit difference."""
    from construction_clip_tpu_torch.models.clip.quant import quantize_clip

    cfg, gcfg, ccfg = cfgs
    clip_q = quantize_clip(convert.to_params(clip_np, device=device))
    cap = as_tree(convert.to_params(cap_np, device=device))
    cap_q = dict(cap, gpt=gpt2.quantize_gpt2(cap["gpt"]))
    ct = clip_tok.tokenize(list(CAPTION_TYPE_PROMPTS), cfg.text.context_length)
    vt = clip_tok.tokenize(list(VIOLATION_TYPES), cfg.text.context_length)
    u8 = np.stack(synthetic_images(np.random.default_rng(6), [(256, 256)] * 8))
    images = preprocess_batch(u8, cfg.vision.image_size, device=device)
    out = {}
    for impl in ("kernel", "plain"):
        with use_impl(impl):
            fn = make_embed_classify_fn(clip_q, cfg, ct, vt)
            reset_launches()
            out[impl] = fn(images)
        out[impl + "_launches"] = launches()["fused_attention_block_int8"]
    (emb_k, ct_k, vt_k), (emb_p, ct_p, vt_p) = out["kernel"], out["plain"]
    if tuple(emb_k.shape) != (8, cfg.vision.embed_dim) or not torch.isfinite(emb_k).all():
        raise AssertionError(f"image features {tuple(emb_k.shape)} not finite/shaped")
    if out["kernel_launches"] != cfg.vision.layers or out["plain_launches"] != 0:
        raise AssertionError(f"paths not as asked: {out['kernel_launches']} K7 launches, "
                             f"{out['plain_launches']} on the plain path")
    feats = compare_scaled(emb_k, emb_p, INT8_FEATURE_TOL, "int8 image features")
    delta = (torch.nn.functional.normalize(emb_k.float(), dim=-1)
             - torch.nn.functional.normalize(emb_p.float(), dim=-1)).norm(dim=-1)
    class_flips = []
    with torch.inference_mode():
        text = {name: encode_text_feats(clip_q, cfg, toks, device)
                for name, toks in (("caption_type", ct), ("violation_type", vt))}
    for name, got, want in (("caption_type", ct_k, ct_p), ("violation_type", vt_k, vt_p)):
        sims = torch.nn.functional.normalize(emb_p.float(), dim=-1) @ text[name].T
        top2 = sims.topk(2, dim=-1).values
        for row in (got != want).nonzero().flatten().tolist():
            gap = float(top2[row, 0] - top2[row, 1])
            class_flips.append({"which": name, "row": row, "plain_top2_gap": gap})
            if gap > 2 * float(delta[row]):
                raise AssertionError(f"{name} differs at row {row} with a top-2 gap {gap} "
                                     f"> 2 * {float(delta[row])}")

    attr = np.zeros((8, ccfg.attribute_length), np.int32)
    for i, (c, v) in enumerate(zip(ct_p.tolist(), vt_p.tolist())):
        ids = lm_tok.encode(attribute_string(CAPTION_TYPE_PROMPTS[c], VIOLATION_TYPES[v]))
        ids = ids[:ccfg.attribute_length]
        attr[i, :len(ids)] = ids
    with torch.inference_mode():
        embeds = torch.cat([map_prefix(cap_q["mapper"], ccfg, gcfg, emb_p),
                            gpt2.embed_tokens(cap_q["gpt"], torch.from_numpy(attr).to(device))],
                           dim=1)
    toks = {}
    for impl in ("kernel", "plain"):
        reset_launches()
        with use_impl(impl):
            toks[impl] = greedy_decode(cap_q["gpt"], gcfg, embeds, max_steps=32,
                                       stop_token=102).tokens
        toks[impl + "_launches"] = launches()["decode_step_attention"]
    if toks["kernel_launches"] == 0 or toks["plain_launches"] != 0:
        raise AssertionError("int8 decode paths not as asked")
    # the paths part only where a difference of their logits can reorder the
    # top two: teacher-forced along the plain path's tokens, a step where the
    # kernel's tokens first differ must have a plain top-2 gap of at most twice
    # the largest logit difference of that row and step
    stream = toks["plain"]
    lk, lp = (teacher_forced_logits(cap_q["gpt"], gcfg, embeds, stream, impl)
              for impl in ("kernel", "plain"))
    logits = compare_scaled(lk, lp, INT8_LOGIT_TOL, "int8 decode logits")
    logit_diff, gaps = (lk - lp).abs().amax(dim=-1), top2_gaps(lp)
    mismatches = []
    for row in range(8):
        diff = (toks["kernel"][row] != stream[row]).nonzero()
        if len(diff):
            step = int(diff[0])
            gap, bound_ = float(gaps[row, step]), 2 * float(logit_diff[row, step])
            mismatches.append({"row": row, "step": step, "plain_top2_gap": gap,
                               "twice_logit_diff": bound_})
            if gap > bound_:
                raise AssertionError(f"int8 greedy tokens differ at row {row} step {step} "
                                     f"with a top-2 gap of {gap} > {bound_}")
    say("int8_parity", image_feature_max_abs_err=feats["max_abs_err"],
        image_feature_scaled_err=feats["max_scaled_err"], feature_tol=INT8_FEATURE_TOL,
        max_normed_feature_delta=float(delta.max()), classes_equal=not class_flips,
        class_flips=class_flips, greedy_steps=32, greedy_rows_equal=8 - len(mismatches),
        mismatches=mismatches, min_plain_top2_gap=float(gaps.min()),
        logit_max_abs_err=logits["max_abs_err"], logit_scaled_err=logits["max_scaled_err"],
        logit_tol=INT8_LOGIT_TOL)


def encode_text_feats(params, cfg, tokens, device):
    from construction_clip_tpu_torch.models.clip.model import encode_text

    return encode_text(params, cfg, torch.as_tensor(tokens, device=device), normalize=True)

@contextlib.contextmanager
def fused_mlp():
    """USE_FUSED_MLP on (models/blocks.py), restored afterwards."""
    previous = blocks.USE_FUSED_MLP
    blocks.USE_FUSED_MLP = True
    try:
        yield
    finally:
        blocks.USE_FUSED_MLP = previous


def _k6_input(rng, shape, misaligned: bool):
    """uint8 images of `shape` on the card; `misaligned` gives a view that
    starts one byte past an allocation's start (the kernel's scalar path)."""
    u8 = torch.from_numpy((rng.random(shape) * 256).astype(np.uint8)).cuda()
    if not misaligned:
        return u8
    flat = torch.empty(u8.numel() + 1, dtype=torch.uint8, device="cuda")
    flat[1:] = u8.flatten()
    return flat[1:].view(shape)


def phase_k6(results: dict) -> None:
    """K6 against its plain version at every K6_CASES case: the same fp32
    operations, so bit-equal; device time as a share of the bytes bound."""
    from construction_clip_tpu_torch.data.preprocess import CLIP_MEAN, CLIP_STD

    rng = np.random.default_rng(16)
    for shape, misaligned in K6_CASES:
        u8 = _k6_input(rng, shape, misaligned)
        for dtype in (torch.bfloat16, torch.float32):
            kw = dict(mean=CLIP_MEAN, std=CLIP_STD, out_dtype=dtype)

            def kernel():
                return normalize_u8(u8, **kw)

            def plain():
                return normalize_u8_plain(u8, **kw)

            got, want = kernel(), plain()
            err = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"K6 {shape} misaligned={misaligned} {dtype}: not "
                                     f"bit-equal to its plain version, largest difference {err}")
            stats = {"max_abs_err": err, "ms": median_ms(kernel), "plain_ms": median_ms(plain)}
            # three fp32 operations an element: multiply, subtract, multiply
            stats.update(bound(nbytes(u8, got), {torch.float32: 3 * u8.numel()}),
                         library_ms=None)   # no single PyTorch call
            # (the plain version copies its constants in: no graph)
            stats["device_ms"] = device_ms = graph_ms(kernel)
            say("k6", shape=list(shape), misaligned=misaligned, out_dtype=str(dtype),
                bit_equal=True, device_gb_per_s=nbytes(u8, got) / (device_ms * 1e-3) / 1e9,
                share_of_bound=stats["bound_ms"] / device_ms, **stats)
            if (shape, misaligned, dtype) == (K6_SHAPE, False, torch.bfloat16):
                results["normalize_u8"] = stats
            del got, want
        del u8
    torch.cuda.empty_cache()


def _mlp_inputs(rng, b, t, d, hidden, dtype):
    def arr(*shape, scale=1.0, offset=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(device="cuda", dtype=dtype)

    return (arr(b, t, d), arr(d, scale=0.1, offset=1.0), arr(d, scale=0.1),
            arr(d, hidden, scale=d ** -0.5), arr(hidden, scale=0.1),
            arr(hidden, d, scale=hidden ** -0.5), arr(d, scale=0.1))


def phase_k9(results: dict) -> None:
    """K9 against its plain version, with the composed default MLP (the
    port's models/blocks path with USE_FUSED_MLP off: cuBLAS GEMMs in the
    compute dtype and elementwise ops, not one library call) and the
    backward (autograd of the recomputed composable math) timed beside it."""
    from construction_clip_tpu_torch.ops.activations import quick_gelu

    rng = np.random.default_rng(17)
    for (b, t, d, hidden), dtype in K9_RUNS:
        args = _mlp_inputs(rng, b, t, d, hidden, dtype)
        x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj = args
        mlp_p = {"w_fc": w_fc, "b_fc": b_fc, "w_proj": w_proj, "b_proj": b_proj}
        ln_p = {"scale": ln_s, "bias": ln_b}

        def kernel():
            return fused_mlp_residual(x, mlp_p, ln_p)

        def plain():
            return fused_mlp_residual_plain(*args)

        def composed():
            return blocks._mlp_residual(x, {"mlp": mlp_p, "ln_2": ln_p}, quick_gelu, 1e-5)

        tc_before = fused_mlp_residual.tc_launches
        got = kernel()
        torch.cuda.synchronize()
        what = f"K9 {[b, t, d]}->{hidden} {dtype}"
        on_tc = fused_mlp_residual.tc_launches != tc_before
        if on_tc != (dtype == torch.bfloat16):
            raise AssertionError(f"{what}: the tensor-core route's counter "
                                 f"{'moved' if on_tc else 'did not move'}")
        stats = compare_scaled(got, plain(), K9_TOL[dtype], what)
        stats.update(ms=median_ms(kernel), plain_ms=median_ms(plain),
                     route="tc" if on_tc else "simt")
        if dtype == torch.bfloat16:
            stats["launch_device_ms"] = kernel_device_ms(kernel)
        leaves = [a.detach().requires_grad_() for a in args]
        out = fused_mlp_residual(leaves[0], dict(zip(mlp_p, leaves[3:])),
                                 {"scale": leaves[1], "bias": leaves[2]})
        g = torch.randn_like(out)
        bwd_ms = median_ms(
            lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 11, 3)
        m = b * t
        stats.update(bound(nbytes(x, *args[1:], got), {dtype: 4 * m * d * hidden}),
                     library_ms=None)   # no single PyTorch call
        stats["device_ms"] = device_ms = graph_ms(kernel)
        say("k9", shape=[b, t, d], hidden=hidden, dtype=str(dtype),
            composed_default_mlp_ms=median_ms(composed), backward_ms=bwd_ms,
            plain_device_ms=graph_ms(plain),
            composed_device_ms=graph_ms(composed),
            device_tflop_per_s=4 * m * d * hidden / (device_ms * 1e-3) / 1e12, **stats)
        if ((b, t, d), dtype) == ((8, 50, 768), torch.bfloat16):
            results["fused_mlp_residual"] = stats
        del leaves, out


def _class_flips(name, got, want, img_k, img_p, txt_k, txt_p) -> list:
    """Rows whose class differs between the paths. Each must have a plain
    top-2 similarity gap within what the feature differences allow: a
    similarity moves by at most ||d img|| + ||d txt_j|| (unit vectors), so two
    labels swap only if the gap is at most 2 (||d img|| + max_j ||d txt_j||)."""
    d_img = (img_k.float() - img_p.float()).norm(dim=-1)
    d_txt = float((txt_k.float() - txt_p.float()).norm(dim=-1).max())
    top2 = (img_p.float() @ txt_p.float().T).topk(2, dim=-1).values
    flips = []
    for row in (got != want).nonzero().flatten().tolist():
        gap, allowed = float(top2[row, 0] - top2[row, 1]), 2 * (float(d_img[row]) + d_txt)
        flips.append({"which": name, "row": row, "plain_top2_gap": gap, "allowed": allowed})
        if gap > allowed:
            raise AssertionError(f"{name}: class differs at row {row} with a top-2 gap {gap} "
                                 f"> {allowed}")
    return flips


def phase_zeroshot_fused(clip_np, cfg, clip_tok, device, *, batch: int = 8) -> dict:
    """The staged fused-MLP zero-shot path at `cfg`, bf16: 224-staged uint8 ->
    preprocess_staged (K6) -> classify_batch over the violation-type label
    features (K1 and K9 in every block of both towers); then the app's batch
    function on 256-staged arrays. Returns the launch counts of the staged
    path."""
    from construction_clip_tpu_torch.apps import predict_zeroshot
    from construction_clip_tpu_torch.data.schema import Annotation
    from construction_clip_tpu_torch.infer.zeroshot import classify_batch, label_features

    size = cfg.vision.image_size
    toks = clip_tok.tokenize(list(VIOLATION_TYPES), cfg.text.context_length)
    rng = np.random.default_rng(18)
    staged = np.stack(synthetic_images(rng, [(size, size)] * batch))
    params = convert.to_params(clip_np, dtype=torch.bfloat16, device=device).tree()
    with fused_mlp():
        reset_launches()
        t0 = time.perf_counter()
        feats = label_features(params, cfg, toks, policy=BF16_POLICY)
        images = preprocess_staged(staged, out_dtype=torch.bfloat16, device=device)
        probs, pred = classify_batch(params, cfg, images, feats, policy=BF16_POLICY)
        pred = pred.cpu()
        wall = time.perf_counter() - t0
        counts = launches()
        check_tc_route("staged zero-shot bf16", counts, tc_launches(),
                       ("fused_attention_block", "fused_mlp_residual"))
        layers = cfg.vision.layers + cfg.text.layers
        if counts["normalize_u8"] != 1 or counts["fused_attention_block"] != layers or \
                counts["fused_mlp_residual"] != layers:
            raise AssertionError(f"staged zero-shot path: launches {counts}, want K6 once, "
                                 f"K1 and K9 {layers} times")
        if tuple(probs.shape) != (batch, len(toks)) or not torch.isfinite(probs).all() or \
                not torch.allclose(probs.sum(dim=-1), torch.ones(batch, device=probs.device)):
            raise AssertionError(f"probabilities {tuple(probs.shape)} not finite/normalised")
        process = predict_zeroshot.make_process(params, cfg, feats, list(VIOLATION_TYPES),
                                                "violation_type", device, policy=BF16_POLICY)
        staged256 = np.stack(synthetic_images(rng, [(256, 256)] * batch))
        anns = [Annotation(id=i, file_name=f"site_{i}.jpg", violation_type=VIOLATION_TYPES[i % 9])
                for i in range(batch)]
        reset_launches()
        records, app_probs = process(anns, staged256)
        app_counts = launches()
        if len(records) != batch or app_counts["fused_mlp_residual"] != cfg.vision.layers or \
                not all(r["prediction"] in VIOLATION_TYPES for r in records):
            raise AssertionError(f"predict_zeroshot.make_process: {records[:1]}, {app_counts}")

    parity = {}
    for dtype in (torch.bfloat16, torch.float32):
        policy = BF16_POLICY if dtype == torch.bfloat16 else DEFAULT_POLICY
        p = params if dtype == torch.bfloat16 else convert.to_params(
            clip_np, device=device).tree()
        x = preprocess_staged(staged, out_dtype=dtype, device=device)
        out = {}
        with fused_mlp():
            for impl in ("kernel", "plain"):
                reset_launches()
                with use_impl(impl), torch.inference_mode():
                    txt = label_features(p, cfg, toks, policy=policy)
                    img = encode_image(p, cfg, x, policy=policy, normalize=True)
                    out[impl] = (img, txt, classify_batch(p, cfg, x, txt, policy=policy)[1])
                out[impl + "_launches"] = launches()["fused_mlp_residual"]
        if out["kernel_launches"] == 0 or out["plain_launches"] != 0:
            raise AssertionError(f"fused-MLP paths not as asked: {out['kernel_launches']} K9 "
                                 f"launches, {out['plain_launches']} on the plain path")
        (img_k, txt_k, c_k), (img_p, txt_p, c_p) = out["kernel"], out["plain"]
        tol = FUSED_FEATURE_TOL[dtype]
        feats_err = {name: compare_scaled(a, b, tol, f"fused-MLP {name} features {dtype}")
                     for name, a, b in (("image", img_k, img_p), ("text", txt_k, txt_p))}
        flips = _class_flips("violation_type", c_k, c_p, img_k, img_p, txt_k, txt_p)
        parity[str(dtype)] = {"tol": tol, "class_flips": flips,
                              **{f"{n}_scaled_err": v["max_scaled_err"]
                                 for n, v in feats_err.items()}}
    say("zeroshot_fused", batch=batch, wall_s=wall, launches=counts,
        predictions=pred.tolist(), app_launches=app_counts,
        app_predictions=[r["prediction"] for r in records[:3]], parity=parity)
    return counts


def phase_precompute(clip_np, cfg, clip_tok, device, *, n_images: int = 70) -> None:
    """precompute_corpus at `cfg` in bf16 with the fused MLP on, over
    `n_images` synthetic images served by a load_image hook (one name that it
    cannot read is skipped), 32 a batch; the archive written and read back."""
    from construction_clip_tpu_torch.data.schema import Annotation
    from construction_clip_tpu_torch.infer.precompute import load_archive, precompute_corpus

    rng = np.random.default_rng(19)
    shapes = [(480, 640), (256, 256), (600, 400), (224, 300)]
    files = {f"site_{i}.jpg": synthetic_images(rng, [shapes[i % 4]])[0]
             for i in range(n_images)}
    anns = [Annotation(id=i, file_name=f"site_{i}.jpg", caption=f"說明{i}" if i % 2 else "",
                       violation_list=f"缺失{i}") for i in range(n_images)]
    anns.insert(5, Annotation(id=-1, file_name="missing.jpg"))

    def load_image(path):
        name = os.path.basename(path)
        if name not in files:
            raise FileNotFoundError(path)
        return files[name]

    params = convert.to_params(clip_np, dtype=torch.bfloat16, device=device).tree()
    with fused_mlp(), tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()) as skipped:
        out_path = os.path.join(tmp, "embedding.npz")
        reset_launches()
        t0 = time.perf_counter()
        out = precompute_corpus(params, cfg, anns, clip_tok, image_root="corpus",
                                batch_size=32, load_image=load_image, policy=BF16_POLICY,
                                out_path=out_path)
        wall = time.perf_counter() - t0
        counts = launches()
        saved = load_archive(out_path)
    emb = out["embeddings"]
    if sorted(saved) != ["attributes", "captions", "embeddings"] or \
            emb.shape != (n_images, cfg.vision.embed_dim) or emb.dtype != np.float32 or \
            not np.isfinite(emb).all() or not np.array_equal(saved["embeddings"], emb) or \
            len(out["attributes"]) != n_images or len(out["captions"]) != n_images:
        raise AssertionError(f"archive: keys {sorted(saved)}, embeddings {emb.shape}")
    if "skip missing.jpg" not in skipped.getvalue():
        raise AssertionError("the unreadable image was not skipped")
    if list(out["captions"][:3]) != ["缺失0", "說明1", "缺失2"]:
        raise AssertionError(f"captions {list(out['captions'][:3])}")
    if counts["fused_attention_block"] <= 0 or counts["fused_mlp_residual"] <= 0:
        raise AssertionError(f"precompute: a kernel never launched: {counts}")
    say("precompute", images=n_images, batch_size=32, wall_s=wall,
        images_per_s=n_images / wall, embeddings=list(emb.shape), launches=counts,
        attributes=list(out["attributes"][:3]))


def _k10_rows(shape, rank, dtype, device):
    gen = torch.Generator().manual_seed(rank)
    return torch.randn(shape, generator=gen).to(device, dtype)


def _k10_call_rows(shape, rank, call, device):
    """Rank `rank`'s rows at call `call`: integers, exact in fp32, that differ
    from every other rank's and call's (a stale slot would show)."""
    n = shape[0] * shape[1]
    first = n * (rank + K10_WORLD * call)
    return torch.arange(first, first + n, device=device, dtype=torch.float32).view(shape)


def k10_delayed(dp, peers, calls: int, shape=(9, 512)) -> bool:
    """`calls` back-to-back calls in which rank `i % world` sleeps
    K10_DELAY_S on the host before call i, so that the others' gathers wait
    on the device; True if every call's output is the concatenation of that
    call's rows."""
    outs = []
    for i in range(calls):
        if i % dp.world == dp.rank:
            time.sleep(K10_DELAY_S)
        outs.append(all_gather(_k10_call_rows(shape, dp.rank, i, dp.device), dp, peers))
    torch.cuda.synchronize()
    return all(torch.equal(out, torch.cat([_k10_call_rows(shape, r, i, dp.device)
                                           for r in range(dp.world)]))
               for i, out in enumerate(outs))


def k10_rank(dp, cases, reps):
    """One rank of phase 23: each case against the plain version, then its
    times; the kernel alone is timed by one rank at a time while the others
    wait at a barrier (the ranks' contexts time-slice the card), with every
    flag already at the generation it is called with, so its waits pass at
    once; then the delayed-rank case."""
    lib = _build.load_library()
    peers = PeerBuffers(dp, max(h * w * torch.empty((), dtype=t).element_size()
                                for (h, w), t in cases))
    out = []
    for (shape, dtype), n in zip(cases, reps):
        x = _k10_rows(shape, dp.rank, dtype, dp.device)
        got = all_gather(x, dp, peers)
        want = all_gather_plain(x, dp)
        torch.cuda.synchronize()
        case = {"shape": list(shape), "dtype": str(dtype), "bit_equal": torch.equal(got, want),
                "max_abs_err": float((got.float() - want.float()).abs().max())}
        for name, fn, calls in (("ms", lambda: all_gather(x, dp, peers), n),
                                ("plain_ms", lambda: all_gather_plain(x, dp), max(5, n // 10))):
            dp.barrier()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            case[name] = (time.perf_counter() - t0) / calls * 1e3
        dp.barrier()   # every rank's flag is at the last call's generation
        g, stream = peers.calls, torch.cuda.current_stream().cuda_stream
        slot, chunk_bytes = (g % 2) * peers.capacity, x.numel() * x.element_size()

        def kernel():   # the C entries alone, as the wrapper calls them
            _build.check(lib.cct_all_gather_put(peers.bases.data_ptr(), slot, peers.pad_offset,
                                                x.data_ptr(), chunk_bytes, dp.world, dp.rank,
                                                g, stream), "all_gather")
            _build.check(lib.cct_all_gather_gather(
                peers.bases.data_ptr(), peers.host_bases, slot, peers.pad_offset, x.data_ptr(),
                got.data_ptr(), chunk_bytes, dp.world, dp.rank, g, stream), "all_gather")

        for r in range(dp.world):
            dp.barrier()
            if r == dp.rank:
                case["kernel_ms"] = median_ms(kernel, 11, 20)
                if r == 0:   # torch.profiler in one rank: in several, it may see no device time
                    case["launch_device_ms"] = kernel_device_ms(kernel)
        dp.barrier()
        out.append(case)
    delayed = k10_delayed(dp, peers, K10_DELAYED_CALLS)
    peers.close()
    return out, delayed


def phase_k10(results: dict) -> None:
    """K10 with K10_WORLD ranks on the card, against its plain version, then
    the delayed-rank case."""
    reps = [200 if h * w < 1 << 20 else 50 for (h, w), _ in K10_CASES]
    per_rank = spawn_ranks(k10_rank, K10_WORLD, (K10_CASES, reps), device="cuda:0",
                           timeout=RANKS_TIMEOUT_S)
    if not all(delayed for _, delayed in per_rank):
        raise AssertionError(f"K10 with a delayed rank: outputs differ from the rows of their "
                             f"calls: {[delayed for _, delayed in per_rank]}")
    for i, (shape, dtype) in enumerate(K10_CASES):
        cases = [rank[i] for rank, _ in per_rank]
        if not all(c["bit_equal"] for c in cases):
            raise AssertionError(f"K10 {shape} {dtype}: not bit-equal to its plain version: "
                                 f"{[c['max_abs_err'] for c in cases]}")
        chunk_bytes = shape[0] * shape[1] * torch.empty((), dtype=dtype).element_size()
        # a rank reads every rank's chunk once and writes it once
        stats = {"max_abs_err": max(c["max_abs_err"] for c in cases),
                 "ms": statistics.median(c["ms"] for c in cases),
                 "plain_ms": statistics.median(c["plain_ms"] for c in cases),
                 **bound(2 * K10_WORLD * chunk_bytes, {}), "library_ms": None}
        kernel_ms = [c["kernel_ms"] for c in cases]
        # the put and the gather on rank 0's device (torch.profiler; not the front
        # end's waits)
        stats["device_ms"] = sum(cases[0]["launch_device_ms"].values())
        say("k10", world=K10_WORLD, shape=list(shape), dtype=str(dtype), bit_equal=True,
            launch_device_ms_rank0=cases[0]["launch_device_ms"],
            chunk_bytes=chunk_bytes, kernel_ms_by_rank=kernel_ms,
            kernel_gb_per_s=2 * K10_WORLD * chunk_bytes / (statistics.median(kernel_ms) * 1e-3)
            / 1e9, ms_by_rank=[c["ms"] for c in cases],
            plain="gloo all_gather through the host", library=K10_LIBRARY, **stats)
        if i == 0:
            results["all_gather"] = stats
    say("k10_delayed", world=K10_WORLD, calls=K10_DELAYED_CALLS, delay_s=K10_DELAY_S,
        shape=[9, 512], bit_equal=True)


def _replicated_params(dp, cfg, seed):
    """Rank 0 draws the params from `seed`; the others take them by broadcast."""
    tree = convert.init_clip(seed if dp.rank == 0 else convert.SHAPES, cfg)
    return replicate(dp, convert.to_params(tree, device=dp.device, trainable=True))


def _rank_batch(dp, batch):
    return shard_batch(dp, {k: torch.from_numpy(v).to(dp.device) for k, v in batch.items()})


def dp_train_rank(dp, cfg, seed, batch, steps):
    """One rank of phases 24 and 26: bf16 steps on this rank's rows."""
    start = time.perf_counter()
    params = _replicated_params(dp, cfg, seed)
    local = _rank_batch(dp, batch)
    tx = make_adamw(1e-4, warmup_steps=0, total_steps=1000)
    state = TrainState.create(params, tx)
    step = contrastive.make_train_step(cfg, tx, policy=BF16_POLICY, device=dp.device, dp=dp)
    on_card = dp.device.type == "cuda"   # (the CPU runs a rehearsal of the phase)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dp.barrier()
    losses, accs, times = [], [], []
    reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, local)
        losses.append(float(m["loss"]))   # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
        accs.append(float(m["accuracy"]))
    return {"losses": losses, "accuracies": accs, "step_ms": times, "launches": launches(),
            "tc_launches": tc_launches(),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None,
            "local_batch": int(local["tokens"].shape[0]),
            "setup_s": time.perf_counter() - start - sum(times) / 1e3}


def _host_batch(batch) -> dict:
    return {k: v.cpu().numpy() for k, v in batch.items()}


def _ranks_device(device) -> str:
    """Every rank on the one card (or, for a rehearsal, on the CPU)."""
    return "cuda:0" if torch.device(device).type == "cuda" else "cpu"


def phase_dp_train(name: str, cfg, seed: int, batch, world: int, steps: int,
                   need: tuple, one_process_losses: list, device="cuda",
                   must_fall: bool = True) -> dict:
    """`world` ranks train `steps` bf16 steps on the card (phases 24, 26): the
    losses are finite, the same on every rank, within DP_LOSS_TOL of
    `one_process_losses` (the one-process run on the same params and batch),
    and fall with `must_fall`; every kernel of `need` launches in every rank,
    and K10 twice a step."""
    t0 = time.perf_counter()
    per_rank = spawn_ranks(dp_train_rank, world, (cfg, seed, _host_batch(batch), steps),
                           device=_ranks_device(device), timeout=RANKS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    losses = per_rank[0]["losses"]
    rel_errs = [abs(a - b) / abs(b) for a, b in zip(losses, one_process_losses)]
    tols = [DP_LOSS_TOL["first"]] + [DP_LOSS_TOL["later"]] * (steps - 1)
    if not all(np.isfinite(losses)) or len(one_process_losses) != steps or \
            any(e > t for e, t in zip(rel_errs, tols)) or \
            (must_fall and not losses[-1] < losses[0]):
        raise AssertionError(f"{name}: losses {losses} against the one-process "
                             f"{one_process_losses}: relative errors {rel_errs}, tols {tols}")
    for r, out in enumerate(per_rank):
        if out["losses"] != losses:
            raise AssertionError(f"{name}: rank {r}'s losses {out['losses']} != {losses}")
        if out["launches"]["all_gather"] != 2 * steps or \
                min(out["launches"][n] for n in need) <= 0:
            raise AssertionError(f"{name}: rank {r}'s launches {out['launches']}")
        check_tc_route(f"{name} rank {r}", out["launches"], out["tc_launches"],
                       [n for n in TC_WRAPPERS if n in need])
    counts = {n: sum(out["launches"][n] for out in per_rank) for n in WRAPPERS}
    say(name, world=world, global_batch=int(batch["tokens"].shape[0]),
        local_batch=per_rank[0]["local_batch"], steps=steps, losses=losses,
        one_process_losses=one_process_losses, loss_rel_errs=rel_errs, loss_tols=tols,
        accuracies=per_rank[0]["accuracies"],
        wall_s=wall, setup_s_by_rank=[o["setup_s"] for o in per_rank],
        median_step_ms_by_rank=[statistics.median(o["step_ms"]) for o in per_rank],
        step_ms_rank0=per_rank[0]["step_ms"],
        peak_memory_gib_by_rank=[o["peak_memory_gib"] for o in per_rank],
        launches_per_rank=per_rank[0]["launches"], launches_all_ranks=counts,
        tc_launches_per_rank=per_rank[0]["tc_launches"],
        note="ranks time-slice one card: no multi-GPU speed")
    return counts


def dp_parity_rank(dp, cfg, seed, batch):
    """One rank of phase 25: the fp32 loss, accuracy and mean gradients on
    this rank's rows, and the global eval accuracy."""
    t0 = time.perf_counter()
    params = _replicated_params(dp, cfg, seed)
    local = _rank_batch(dp, batch)
    t1 = time.perf_counter()
    reset_launches()
    loss, acc, grads = contrastive.loss_and_grads(params, cfg, local["images"], local["tokens"],
                                                  dp=dp)
    eval_acc = contrastive.make_eval_step(cfg, dp=dp)(params, local)
    leaves = tree_leaves(grads)
    out = {"loss": float(loss), "accuracy": float(acc), "eval_accuracy": float(eval_acc),
           "launches": launches(), "sums": [float(g.double().sum()) for g in leaves],
           "setup_s": t1 - t0, "step_and_eval_s": time.perf_counter() - t1}
    if dp.rank == 0:
        out["grads"] = [g.cpu().numpy() for g in leaves]
    return out


def phase_dp_parity(cfg, seed: int, batch, world: int, device="cuda") -> None:
    """Phase 25: the `world`-rank fp32 step against the one-process step. The
    accuracies are held to 1e-6: the ranks' mean of four fractions of 9 rounds
    otherwise than one fraction of 36."""
    params = convert.to_params(convert.init_clip(seed, cfg), device=device, trainable=True)
    loss, acc, grads = contrastive.loss_and_grads(params, cfg, batch["images"], batch["tokens"])
    eval_acc = float(contrastive.make_eval_step(cfg)(params, batch))
    want = [g.detach() for g in tree_leaves(grads)]
    names = list(_paths(as_tree(params)))
    loss, acc = float(loss), float(acc)
    del params, grads
    t0 = time.perf_counter()
    per_rank = spawn_ranks(dp_parity_rank, world, (cfg, seed, _host_batch(batch)),
                           device=_ranks_device(device), timeout=RANKS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    errs = {}
    for name, got, ref in zip(names, per_rank[0]["grads"], want):
        errs[name] = float((torch.from_numpy(got).to(ref.device) - ref).abs().max()
                           / ref.abs().max())
    worst = max(errs, key=errs.get)
    report = {"loss_one_process": loss, "loss_ranks": per_rank[0]["loss"],
              "loss_rel_err": abs(per_rank[0]["loss"] - loss) / abs(loss),
              "accuracy": [acc, per_rank[0]["accuracy"]],
              "eval_accuracy": [eval_acc, per_rank[0]["eval_accuracy"]],
              "worst_leaf": worst, "worst_leaf_err": errs[worst], "tol": DP_GRAD_TOL}
    same = all(o["sums"] == per_rank[0]["sums"] and o["loss"] == per_rank[0]["loss"]
               for o in per_rank)
    if report["loss_rel_err"] > 1e-5 or abs(per_rank[0]["accuracy"] - acc) > 1e-6 or \
            abs(per_rank[0]["eval_accuracy"] - eval_acc) > 1e-6 or errs[worst] > DP_GRAD_TOL or \
            not same:
        raise AssertionError(f"data-parallel fp32 parity: {report}, ranks agree: {same}")
    if any(o["launches"]["all_gather"] != 4 for o in per_rank):   # 2 in the loss, 2 in eval
        raise AssertionError(f"K10 launches {[o['launches'] for o in per_rank]}")
    say("dp_parity", world=world, global_batch=int(batch["tokens"].shape[0]),
        leaves=len(names), ranks_agree=same, wall_s=wall,
        setup_s_by_rank=[o["setup_s"] for o in per_rank],
        step_and_eval_s_by_rank=[o["step_and_eval_s"] for o in per_rank], **report)


def main() -> None:
    info = phase_device()
    phase_build()
    results: dict = {}
    phase_k1(results)
    phase_k2(results)
    phase_k3(results)
    phase_flash(results)
    with tempfile.TemporaryDirectory() as tmp:
        clip_tok, lm_tok = tokenizers(tmp)
    cfgs = (CLIPConfig.vit_b_32(), GPT2Config(), ClipCapConfig())   # full width
    clip_np = convert.init_clip(0, cfgs[0])
    cap_np = convert.init_clipcap(1, cfgs[2], cfgs[1])
    counts = phase_serve(clip_np, cap_np, cfgs, clip_tok, lm_tok, "cuda")
    phase_parity(clip_np, cap_np, cfgs, clip_tok, lm_tok, "cuda")

    batch = class_balanced_batch(cfgs[0], clip_tok, 4, 9, "cuda")
    out = vit_b_32_default = phase_train("vit_b_32", cfgs[0], clip_np, batch, 10, "cuda")
    if not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"ViT-B/32 loss did not fall: {out['losses']}")
    for name in ("fused_attention_block", "fused_attention_block_bwd"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched in ViT-B/32 training")
    check_tc_route("ViT-B/32 bf16", out["launches"], out["tc_launches"],
                   ("fused_attention_block", "fused_attention_block_bwd"))
    say("train_vit_b_32_tensor_cores", median_step_ms=out["median_step_ms"],
        tc_launches=out["tc_launches"], batch=out["batch"])
    counts["fused_attention_block_bwd"] = out["launches"]["fused_attention_block_bwd"]

    cfg_l = CLIPConfig.vit_l_14()
    batch = class_balanced_batch(cfg_l, clip_tok, 1, 10, "cuda")
    out = phase_train("vit_l_14", cfg_l, convert.init_clip(2, cfg_l), batch, 3, "cuda")
    train_kernels = ("fused_attention_block", "fused_attention_block_bwd",
                     "flash_attention_fwd", "flash_attention_bwd")
    if min(out["launches"][n] for n in train_kernels) <= 0:
        raise AssertionError(f"a kernel of ViT-L/14 training never launched: "
                             f"{out['launches']}")
    check_tc_route("ViT-L/14 bf16", out["launches"], out["tc_launches"])
    say("train_vit_l_14_tensor_cores", tc_launches=out["tc_launches"],
        median_step_ms=out["median_step_ms"], batch=out["batch"])
    counts.update({n: out["launches"][n] for n in ("flash_attention_fwd", "flash_attention_bwd")})

    batch = class_balanced_batch(cfgs[0], clip_tok, 2, 11, "cuda")
    phase_train_parity(cfgs[0], clip_np, batch, "cuda")

    phase_k8(results)
    t5_cfgs = (cfgs[0], ClipCapConfig(attribute_length=0), T5Config())   # full width
    clip_p, caps = _t5_caption_params(clip_np, t5_cfgs[1], t5_cfgs[2], "cuda")
    counts["vocab_head_logits"] = phase_t5_caption(clip_p, caps, t5_cfgs, clip_tok, lm_tok,
                                                   "cuda")
    phase_t5_steps(caps, t5_cfgs, "cuda")
    phase_t5_parity(caps, t5_cfgs, "cuda")
    del clip_p, caps

    phase_k7(results)
    int8_counts = phase_int8_serve(clip_np, cap_np, clip_tok, lm_tok)
    counts["fused_attention_block_int8"] = int8_counts["fused_attention_block_int8"]
    phase_int8_parity(clip_np, cap_np, cfgs, clip_tok, lm_tok, "cuda")

    phase_k6(results)
    phase_k9(results)
    zs_counts = phase_zeroshot_fused(clip_np, cfgs[0], clip_tok, "cuda")
    counts.update({n: zs_counts[n] for n in ("normalize_u8", "fused_mlp_residual")})
    phase_precompute(clip_np, cfgs[0], clip_tok, "cuda")
    batch = class_balanced_batch(cfgs[0], clip_tok, 4, 9, "cuda")
    with fused_mlp():
        out = phase_train("vit_b_32_fused_mlp", cfgs[0], clip_np, batch, 5, "cuda")
    if not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"ViT-B/32 fused-MLP loss did not fall: {out['losses']}")
    for name in ("fused_attention_block", "fused_attention_block_bwd", "fused_mlp_residual"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched in fused-MLP ViT-B/32 training")
    check_tc_route("fused-MLP ViT-B/32 bf16", out["launches"], out["tc_launches"],
                   ("fused_attention_block", "fused_attention_block_bwd", "fused_mlp_residual"))
    say("train_fused_mlp_vs_default", fused_median_step_ms=out["median_step_ms"],
        default_median_step_ms=vit_b_32_default["median_step_ms"],
        fused_step_device_ms=out["step_device_ms"],
        default_step_device_ms=vit_b_32_default["step_device_ms"], batch=out["batch"])
    batch = class_balanced_batch(cfgs[0], clip_tok, 2, 11, "cuda")
    with fused_mlp():
        phase_train_parity(cfgs[0], clip_np, batch, "cuda",
                           need=("fused_attention_block", "fused_attention_block_bwd",
                                 "fused_mlp_residual"), name="train_parity_fused_mlp")

    phase_k10(results)
    batch = class_balanced_batch(cfgs[0], clip_tok, 4, 9, "cuda")   # phase 9's
    dp_counts = phase_dp_train("dp_train_vit_b_32", cfgs[0], 0, batch, K10_WORLD, 5,
                               need=("fused_attention_block", "fused_attention_block_bwd"),
                               one_process_losses=vit_b_32_default["losses"][:5])
    counts["all_gather"] = dp_counts["all_gather"]
    batch = class_balanced_batch(cfgs[0], clip_tok, 4, 11, "cuda")
    phase_dp_parity(cfgs[0], 0, batch, K10_WORLD)
    batch = class_balanced_batch(cfg_l, clip_tok, 2, 10, "cuda")
    del clip_np, cap_np
    # the same 2 steps in one process: ViT-L/14's loss may rise at this lr, so the
    # ranks are held to this run and not to a falling loss
    one_process = phase_train("vit_l_14_b18", cfg_l, convert.init_clip(2, cfg_l), batch, 2,
                              "cuda")
    torch.cuda.empty_cache()
    phase_dp_train("dp_train_vit_l_14", cfg_l, 2, batch, 2, 2,
                   need=("flash_attention_fwd", "flash_attention_bwd",
                         "fused_attention_block", "fused_attention_block_bwd"),
                   one_process_losses=one_process["losses"], must_fall=False)
    kernels = [{"name": name, **KERNELS[name], "launches": counts[name],
                **{key: results[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                       "bound_ms", "bound_by", "library_ms")},
                "device_ms": results[name]["device_ms"]}
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
