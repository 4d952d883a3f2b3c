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
     at 8 images x beam 3 (R=24), 1 image x beam 3 (R=3) and predict's 16
     images x beam 3 (R=48) and 16 greedy (R=16), cache lengths 0 to t_max - 1, bf16 and fp32, bit-equal on a second call; at cache_len
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
 27. ClipCap caption training at full width (GPT-2 21128x12x768, MLP mapper,
     prefix 20, attribute 20), bf16: train/caption.make_caption_train_step on
     data/loader.TorchArrayLoader batches of a synthetic archive (prefix
     [N,512], captions of 10-40 ids, attributes padded to 20), 10 steps of B=16
     in each mode, only-prefix (the frozen GPT-2 cast once) and full
     fine-tune; the first batch's loss after the steps must be below its loss
     before them; the median step, a step's device time (its kernels under
     torch.profiler), the peak memory above what was allocated before the
     first step (the params and AdamW moments, and earlier phases' tensors,
     are below that line); none of K1-K10 may launch (ClipCap
     training runs no hand kernel, as the JAX step runs no Pallas kernel).
     The full fine-tune's params are saved with save_params_npz for phase 29.
 28. one full fine-tune caption step in fp32 at full width, B=4, on the card
     against the CPU on the same params and batch, for each of six batches
     (CAPTION_PARITY_SEEDS): the loss and every gradient leaf (the tied wte
     on its own line); then the first batch's step on the card again with
     TF32 GEMMs, a control that must read above the bound.
 29. the port's apps/predict.make_process at full width on phase 27's npz
     (load_params_npz), bf16, beam 3, 100 steps: 32 synthetic images of mixed
     sizes staged by host_shape_unify, in batches of 16; the records carry the
     JAX app's keys and valid classes; K1 and K2 launch, every K1 launch on
     the tensor-core route; s per batch and images/s. Then the same images
     in fp32, greedy, on the kernel and the plain path: the classes equal,
     and greedy captions equal or, where not, parted at a step whose plain
     top-2 logit gap is below 1e-3 (as phase 6).
 30. mT5 caption training at full width (mT5-small 250112x8+8x512, untied
     head, MLP mapper with prefix 20 and clip 512), bf16:
     train/t5.make_t5_caption_train_step on data/loader.TorchArrayLoader
     batches of a synthetic archive (prefix [N,512], captions of 8-32 ids
     drawn Zipf-like from a 30,000-id BPE range, padded to 32), 10 steps of
     B=40 (the JAX app's --bs) in each mode, only-prefix (the frozen T5 cast
     once) and full fine-tune; the first batch's loss after the steps must be
     below its loss before them; the median step, a step's device time, the
     peak memory above the pre-step line; none of K1-K10 may launch (the JAX
     step runs no Pallas kernel). The full fine-tune's params are saved with
     save_params_npz for phase 32.
 31. one full fine-tune mT5 caption step in fp32 at full width, B=4, on the
     card against the CPU on the same params and batch: the loss and every
     gradient leaf (t5/shared, which takes the scatter-added gradients of
     the encoder's and the decoder's inputs, and t5/lm_head on their own
     lines); then the card's step again with TF32 GEMMs, a control that must
     read above the bound.
 32. the port's apps/predict_t5.make_process at full width on phase 30's npz
     (load_params_npz), bf16, greedy, 32 steps, 16 synthetic images in
     batches of 8: the records carry the JAX app's keys; K8 launches steps +
     1 times a batch and K1 launches; s per batch and tokens/s.
 33. K1 and K3 at head width 96 ([16,30,768], 8 heads: GPT-2's transformer
     mapper in predict, clip_length 10 + prefix 20 rows), bf16 and fp32, on
     the SIMT route (the tensor-core route takes dh 64), against their plain
     versions at phases 3 and 7's tolerances; times, device times (CUDA-graph
     replays), bounds, and the composed library block's forward and backward
     device times beside them.
 34. phase 27 with the transformer mapper (8 blocks, clip_length 10, 8 heads
     of 96, ReLU; GPT-2 base, prefix 20, attribute 20, B=16, 10 steps in each
     mode on phase 27's archive): K1 and K3 launch 8 times a step, on the
     SIMT route; the first batch's loss falls in each mode; then
     phase 28's fp32 card-against-CPU steps (CAPTION_GRAD_TOL, its TF32
     control) with this mapper, the CPU runs on the card's ReLU masks, the
     signs the CPU gives otherwise counted and its own-mask reading beside.
 35. phase 29 with --mapping_type transformer on phase 34's npz: K1 launches
     12 times (image tower, tensor cores) and 8 times (mapper, SIMT) a batch;
     the fp32 greedy captions on the kernel path against the plain path.
 36. explainability at full width (ViT-B/32, GPT-2 base, phase 27's npz),
     fp32: apps/predict.make_explain on 4 staged 256x256 images captioned
     greedily (the JET overlay, per-character scores, the decoder attention
     rows, each a distribution); s an image; no kernel launched inside
     infer/explain.interpret (the probe path is the composed attention);
     R_image and R_text on the card against the CPU's on the same inputs
     (EXPLAIN_TOL), and the TF32 control above it.
 37. the train_clip_caption app (its loop is train_clip.fit) at ViT-B/32,
     bf16, --batch_size 8, the 49,408-token BPE: one epoch of 10 steps over
     (image, violation_list) pairs, the images through TorchImageTextLoader's
     load_image hook (no PIL), then its eval and checkpoints: K1 and K3
     launch 24 times a step (K1 also 24 an eval batch), all on the tensor
     cores; the first batch's loss falls; the median step and its device
     time.
 38. mT5 caption training with the transformer mapper (width 512, 8 heads of
     64), full fine-tune, bf16, 3 steps of B=40: K1 and K3 launch 8 times a
     step, all on the tensor cores; then one predict_t5 batch of 8 on the
     trained params: K1 12 + 8 times on the tensor cores, K8 steps + 1.
 39. the Faster R-CNN detector (models/detection.fasterrcnn_infer) at serving
     width: ResNet-50-FPN, 800-px images, 7 classes, bf16, weights from a
     numpy seed as a torchvision state dict through from_torchvision_state_dict
     (detector_state_dict): B=1 and B=8, median of 7 calls' CUDA-event and
     host times, peak memory, the NMS iteration counts, each stage's device
     time (backbone + FPN, RPN and its NMS, ROI heads, ROIAlign, class NMS),
     the kernels' device time under torch.profiler; fp32 with TF32 off
     against the port on the CPU for one image (DETECT_BOX_ATOL,
     DETECT_SCORE_ATOL, detection by detection); bf16 against fp32 (the share
     of the top 20 matched at IoU >= 0.5 and the same label); TorchDetector's
     letterbox staging and map back: detections, every box inside its image.
 40. phase 5 with the detector: ThresholdWrapper(TorchDetector) (800-px
     letterbox, 7 classes, bf16) in TorchPredictService, 10 requests from 4
     threads, a 20 ms window, max_batch 8: the detector's batch coalesces, K1
     (tensor cores) and K2 launch in that run, every response has the six
     keys; req/s, the warm single request, each drained batch's caption and
     detection seconds beside phase 5's and beside a control without the
     detector run in turns with it; then requests at threshold 0: names
     of DETECTOR_CLASSES, boxes inside the image (the 0.8 threshold leaves
     the random weights' lists empty).
 41. apps/eval_detection.evaluate (evaluate_image per image) on 6 synthetic
     images through a load_image hook (one missing), the app's defaults (8
     classes, 512 px, fp32), the ground truth from each image's own top
     detections plus a band object: the metrics JSON, AP50 above 0.
 42. Faster R-CNN training (train/detection.make_detection_train_step) at
     serving width: 800 px, 7 classes, bf16 compute on the fp32 master tree
     of phase 39's weights made trainable, AdamW with the global-norm clip:
     10 steps of the default loss at B=4 on 3-5 synthetic boxes an image (the
     first batch's loss must fall), then 4 tv_faithful steps at B=2, post-NMS
     512 (finite); the median step, its device time, peak memory, the NMS
     iterations; no hand kernel launches (no Pallas call on this path).
 43. one detection train step in fp32 at 256 px, B=2, on the card (TF32 off)
     against the CPU from the same tree, for both losses (the RPN samples
     drawn on the CPU and passed to both; the CPU on the card's ReLU masks):
     the loss and every gradient leaf within phase 28's bound; the TF32 run
     beside it as the control.
 44. the show-attend-tell trainer at the reference widths (embed 300,
     attention 256, decoder 512, the fp32 ResNet-50 grid 49 x 2048 at 224):
     train_attention's loader (a load_image hook), encoder and
     make_lstm_train_step, B=32, captions of a synthetic Chinese corpus cut
     to 32 ids, dropout 0.3, 10 steps: the first batch's loss falls; the
     median step and its device time; no hand kernel launches.
 45. eval_attention's per-image function (greedy, max_len 20) on phase 44's
     params for 4 images, and generate_caption on the 4 at once, card against
     CPU with TF32 off, eos a token that stops one caption (at step 2 or
     later where one does) while another runs to max_len: the captions not
     all equal, the same words, tokens and lengths, alphas within 1e-5;
     seconds an image.
 46. (none: the native JPEG loader's phase needs libjpeg's header and
     library, which the card's machine lacks; tests/test_torch_native_loader.py
     holds the loader on the CPU.)
 47. rematerialisation (models/blocks.apply_stack(remat=...)): ViT-L/14
     contrastive training at full width and depth, bf16, B=36 (4 class-balanced
     groups of 9), 3 make_train_step steps from the same params on one batch for
     remat False, True and each of the 8 named policies: the median step, the
     launches of K1, K3, K4 and K5, the peak memory of steps 2-3 (step 1 also
     allocates AdamW's moments), and, for one more forward and backward
     without the optimizer, the memory the graph keeps for the backward and
     that pass's peak; the device time of a step under torch.profiler for
     False, True and save_preact. Before the steps, one loss_and_grads from
     the same params: every policy's gradients are bit-equal to no remat's
     (no remat's own second call is first shown bit-equal to its first: the
     kernels are deterministic), so a recompute that read stale statistics
     or lost a term fails here before AdamW's first step, which normalises a
     gradient to about lr times its sign, could hide it. The first step's
     loss equals no remat's; full remat's step
     peak, pass peak and kept memory are below no remat's, and each policy's
     kept memory lies strictly between, its pass peak between and its step
     peak not above no remat's;
     with True K4 launches twice as often (the image tower re-runs its
     forward) and K1 as often (JAX remats the image tower only, and the text
     tower holds ViT-L/14's K1 launches). Then ViT-B/32 one step each way at
     B=36: K1 launches 12 times more with True (the image tower's 12 blocks
     re-run). K1 and K4 repeat their bits on a second call (the checkpoint
     recomputes them in the backward). Then one fp32 step with remat True and
     save_preact at a small config (image tower on the flash route, text
     tower on K1's) on the card with TF32 off against the CPU: the loss and
     every gradient leaf within phase 28's bound.
Each of phases 42-47 prints its wall seconds. `--only NAME[,NAME]` (the
names of SUBSETS) runs the device line and those phases alone, without the
verdict, for a quicker look; the gate is the run without arguments.
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
    CLIPConfig, ClipCapConfig, GPT2Config, T5Config, TextConfig, VisionConfig)
from construction_clip_tpu_torch.core.mesh import (  # noqa: E402
    replicate, shard_batch, spawn_ranks)
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map  # noqa: E402
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
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text  # noqa: E402
from construction_clip_tpu_torch.parallel.infonce import local_infonce  # noqa: E402
from construction_clip_tpu_torch.models.clipcap.model import map_prefix  # noqa: E402
from construction_clip_tpu_torch.ops import _build  # noqa: E402
from construction_clip_tpu_torch.ops.attention import use_impl  # noqa: E402
from construction_clip_tpu_torch.ops.attention_block import (  # noqa: E402
    fused_attention_block, fused_attention_block_fwd, fused_attention_block_plain)
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
             (16, 50, 768, 12, False),  # predict's image tower, --batch_size 16
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
             dict(layers=12, rows=3, heads=12, t_max=140, dh=64),    # 1 image x beam 3
             dict(layers=12, rows=48, heads=12, t_max=140, dh=64),   # predict: 16 x beam 3
             dict(layers=12, rows=16, heads=12, t_max=140, dh=64))   # predict: 16, greedy
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
RESPONSE_KEYS = ("boxes", "labels", "scores", "caption_type", "violation_type", "caption")


def phase_serve(clip_np, cap_np, cfgs, clip_tok, lm_tok, device, *, detector=None,
                name: str = "serve") -> dict:
    """The serving path in bf16: TorchPredictService over the port's
    CaptionPipeline (beam 3, 100 steps), 10 requests from 4 threads with a 20 ms
    coalescing window. With `detector` (phase 40) each drained batch is also
    detected in one call, which must coalesce too. Returns the launches of
    the caption kernels in the run (counts reset just before the service is
    built, read just after the requests), the req/s and the warm single
    request's latency."""
    import concurrent.futures as cf

    clip_cfg, gcfg, ccfg = cfgs
    reset_launches()
    pipe = CaptionPipeline(
        clip_params=convert.to_params(clip_np, dtype=torch.bfloat16, device=device),
        clip_cfg=clip_cfg,
        cap_params=convert.to_params(cap_np, dtype=torch.bfloat16, device=device),
        ccfg=ccfg, gcfg=gcfg, clip_tokenizer=clip_tok, lm_tokenizer=lm_tok,
        policy=BF16_POLICY)
    svc = TorchPredictService(pipe, detector=detector, batch_window_ms=20, max_batch=8)
    batch_sizes, det_batch_sizes = [], []
    caption_batch, detect_batch = svc._caption_batch, svc._detect_batch

    caption_s, detect_s = [], []

    def counted(staged):
        batch_sizes.append(len(staged))
        t0 = time.perf_counter()
        out = caption_batch(staged)   # strings: the device has finished
        caption_s.append(time.perf_counter() - t0)
        return out

    def counted_detect(staged, sizes):
        det_batch_sizes.append(len(staged))
        t0 = time.perf_counter()
        out = detect_batch(staged, sizes)   # host lists: the device has finished
        detect_s.append(time.perf_counter() - t0)
        return out

    svc._caption_batch, svc._detect_batch = counted, counted_detect
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
    check_tc_route(f"{name} bf16", counts, tc_launches(), ("fused_attention_block",))
    for r in responses:
        if r["caption_type"] not in ("violation", "status") or \
                r["violation_type"] not in VIOLATION_TYPES or not isinstance(r["caption"], str):
            raise AssertionError(f"bad response {r}")
        if sorted(r) != sorted(RESPONSE_KEYS) or \
                not len(r["boxes"]) == len(r["labels"]) == len(r["scores"]):
            raise AssertionError(f"bad response keys or detection lists {r}")
    if max(batch_sizes) < 2:
        raise AssertionError(f"no coalesced batch formed: {batch_sizes}")
    if detector is not None and max(det_batch_sizes) < 2:
        raise AssertionError(f"no coalesced detector batch formed: {det_batch_sizes}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the serving path never launched: {counts}")
    out = {"launches": counts, "req_per_s": len(images) / wall,
           "warm_single_request_s": statistics.median(single), "service": svc,
           "images": images}
    say(name, requests=len(images), threads=4, wall_s=wall, req_per_s=out["req_per_s"],
        warm_single_request_s=out["warm_single_request_s"],
        runs_single_request_s=single, batch_sizes=batch_sizes,
        caption_batch_s=caption_s, detector_batch_sizes=det_batch_sizes,
        detect_batch_s=detect_s, launches=counts,
        detections_per_response=[len(r["boxes"]) for r in responses],
        captions=[r["caption"][:24] for r in responses[:3]])
    return out


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
    """The leaves' paths of nested dicts and lists, in tree_leaves' order."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        if isinstance(value, (dict, list)):
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

# ---- ClipCap: caption training, and the predict app ----------------------------------

CAPTION_BATCH, CAPTION_STEPS = 16, 10
# the full fine-tune's fp32 gradients on the card against the CPU's, each leaf's
# largest difference over its largest element plus 1e-6 of the largest element
# of any leaf (the key bias's gradient is rounding noise on both sides). Sums in
# another order through 12 layers and a 21,128-way softmax; the mapper's w1
# gradient sums 15,360 products of either sign (w2's backward) before its 4-row
# outer product, so the order alone moved it by 1.9e-6 and 6.4e-5 of its
# largest element in two sound runs whose CPUs summed in other orders. The
# same step with the card's GEMMs in TF32 (10-bit mantissa), which the phase
# runs as its control, read 1.2e-3 on w1 on an H100. The bound sits between,
# about 4.7x above the larger sound reading and 4x below the control. Phase
# 34's transformer mapper steps through ReLU, whose derivative jumps at 0: on
# an H100, one pre-activation that the CPU put on the other side of 0 moved
# mapper/blocks/mlp/w_fc by 6.0e-4 of its largest element against the CPU run
# on its own masks, and by 2.1e-6 with the card's masks replayed. So the CPU
# run takes the card's ReLU masks (relu_masks), and the phase reports the
# flips and the own-mask reading beside the held one.
CAPTION_GRAD_TOL = 3e-4
CAPTION_PARITY_SEEDS = (28, 29, 30, 31, 32, 33)   # the batches of phases 28 and 34
PREDICT_KEYS = ["id", "file_name", "ground_truth_caption", "ground_truth_attribute",
                "caption", "attribute", "caption_type", "violation_type", "decode_suspect"]


def caption_archive(rng, n: int, ccfg, gcfg) -> dict:
    """A tokenised prefix archive as apps/train_clipcap.py trains on: prefix
    [n, clip_dim] fp32 embeddings, captions of 10-40 ids ([CLS] ... [SEP], the
    characters drawn Zipf-like from 2,000 of the vocabulary, as a caption
    corpus's are) zero-padded to 40, attributes of 4-6 ids padded to 20."""
    chars = rng.choice(np.arange(104, gcfg.vocab_size), size=2000, replace=False)
    weights = 1.0 / np.arange(1, 2001)
    weights /= weights.sum()

    def rows(lengths, width):
        out = np.zeros((n, width), np.int32)
        for i, length in enumerate(lengths):
            out[i, :length] = [101, *rng.choice(chars, size=length - 2, p=weights), 102]
        return out

    return {"prefix": rng.standard_normal((n, ccfg.clip_dim)).astype(np.float32),
            "tokens": rows(rng.integers(10, 41, n), 40),
            "attribute": rows(rng.integers(4, 7, n), ccfg.attribute_length)}


def caption_batch_loss(state, frozen, ccfg, gcfg, batch) -> float:
    """The bf16 caption loss of `batch` at the state's params."""
    from construction_clip_tpu_torch.models.clipcap.model import caption_loss, clipcap_forward

    params = as_tree(state.params)
    params = {"mapper": params, "gpt": frozen} if ccfg.only_prefix else params
    with torch.inference_mode():
        logits = clipcap_forward(params, ccfg, gcfg, tokens=batch["tokens"],
                                 clip_embed=batch["prefix"], attribute_tokens=batch["attribute"],
                                 policy=BF16_POLICY)
        return float(caption_loss(logits, batch["tokens"], ccfg))


def mapper_launches(ccfg, gcfg, steps: int) -> dict:
    """The K1 and K3 launches of `steps` caption training steps: one of each a
    transformer-mapper block (its blocks take the fused block), none for the
    MLP mapper (GPT-2's training attention is plain torch); and those on the
    tensor-core route, which the mapper's head width picks."""
    from construction_clip_tpu_torch.models.clipcap.model import MAPPER_HEADS
    from construction_clip_tpu_torch.ops.attention_block import route

    n = ccfg.mapper_layers * steps if ccfg.mapper == "transformer" else 0
    tc = n if route(torch.bfloat16, gcfg.n_embd // MAPPER_HEADS) == "tc" else 0
    want = {name: 0 for name in WRAPPERS}
    want.update(fused_attention_block=n, fused_attention_block_bwd=n)
    return {"launches": want, "tc": {"fused_attention_block": tc,
                                     "fused_attention_block_bwd": tc}}


def tower_launches(clip_cfg, dtype) -> dict:
    """K1's launches in one image-tower call (a block each) and those on the
    tensor-core route, which the tower's head width and `dtype` pick."""
    from construction_clip_tpu_torch.ops.attention_block import route

    v = clip_cfg.vision
    n = v.layers
    return {"launches": n, "tc": n if route(dtype, v.width // v.heads) == "tc" else 0}


def phase_clipcap_train(cfgs, out_npz: str, device="cuda", name: str = "clipcap_train") -> dict:
    """Phases 27 and 34: make_caption_train_step in bf16 on TorchArrayLoader
    batches of a synthetic archive, CAPTION_STEPS steps of CAPTION_BATCH rows
    in each mode; the full fine-tune's params are saved to `out_npz`. The
    launches must be mapper_launches' (none with the MLP mapper); the first
    batch's loss must fall in both modes."""
    import dataclasses

    from construction_clip_tpu_torch.data.loader import TorchArrayLoader
    from construction_clip_tpu_torch.train.caption import make_caption_train_step
    from construction_clip_tpu_torch.train.checkpoint import save_params_npz

    _, gcfg, ccfg = cfgs
    arrays = caption_archive(np.random.default_rng(27), CAPTION_BATCH * CAPTION_STEPS, ccfg,
                             gcfg)
    out = {}
    for mode in ("only_prefix", "full"):
        mcfg = dataclasses.replace(ccfg, only_prefix=mode == "only_prefix")
        tree = convert.init_clipcap(4, mcfg, gcfg)
        if mcfg.only_prefix:   # the frozen GPT-2 cast to bf16 once, before the steps
            params = convert.to_params(tree["mapper"], device=device, trainable=True)
            frozen = BF16_POLICY.cast_to_compute(convert.to_params(tree["gpt"],
                                                                   device=device).tree())
        else:
            params, frozen = convert.to_params(tree, device=device, trainable=True), None
        del tree
        tx = make_adamw(1e-4, warmup_steps=1, total_steps=100)
        state = TrainState.create(params, tx)
        step = make_caption_train_step(mcfg, gcfg, tx, policy=BF16_POLICY, device=device)
        loader = TorchArrayLoader(arrays, batch_size=CAPTION_BATCH, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated()   # params, moments, earlier phases' tensors
        reset_launches()
        losses, times = [], []
        t0 = time.perf_counter()
        for batch in loader:
            if not losses:
                first = batch
            state, m = step(state, frozen, batch)
            losses.append(float(m["loss"]))   # waits for the step
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        counts, tc = launches(), tc_launches()
        peak = (torch.cuda.max_memory_allocated() - at_start) / 2 ** 30
        # the loss falls: the first batch's, before the steps and after them
        first_after = caption_batch_loss(state, frozen, mcfg, gcfg, first)
        if len(losses) != CAPTION_STEPS or not all(np.isfinite(losses)) or \
                not first_after < losses[0]:
            raise AssertionError(f"caption training {mode}: losses {losses}, the first "
                                 f"batch's after the steps {first_after}")
        want = mapper_launches(mcfg, gcfg, CAPTION_STEPS)
        tc = {k: tc[k] for k in want["tc"]}
        if counts != want["launches"] or tc != want["tc"]:
            raise AssertionError(f"caption training {mode}: launches {counts}, on the "
                                 f"tensor cores {tc}; want {want}")
        per_kernel = kernel_device_ms(lambda: step(state, frozen, batch), reps=2)
        step_device_ms = sum(per_kernel.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        out[mode] = {"batch": CAPTION_BATCH, "steps": CAPTION_STEPS, "losses": losses,
                     "first_batch_loss_after": first_after,
                     "median_step_ms": statistics.median(times) * 1e3,
                     "step_device_ms": step_device_ms, "kernels_by_device_ms": top,
                     "peak_memory_above_start_gib": peak,
                     "trainable_params": sum(p.numel() for p in tree_leaves(as_tree(params))),
                     "launches": {k: v for k, v in counts.items() if v}, "tc_launches": tc}
        say(f"{name}_{mode}", **out[mode])
        if mode == "full":
            save_params_npz(out_npz, state.params)
        del params, frozen, state, step
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def relu_masks(record: list, replay=None):
    """torch.relu (the transformer mapper's activation) with each call's
    (x > 0) appended to `record`; with `replay`, a list of such masks, each
    call computes x times the next of them instead, so that a run takes
    another run's activation pattern."""
    relu = torch.relu
    masks = iter(replay) if replay is not None else None

    def recorded(x):
        record.append((x > 0).cpu())
        return relu(x) if masks is None else x * next(masks).to(x.device, x.dtype)

    torch.relu = recorded
    try:
        yield
    finally:
        torch.relu = relu


def phase_clipcap_parity(cfgs, device="cuda", name: str = "clipcap_parity") -> None:
    """Phases 28 and 34: one full fine-tune step's fp32 loss and gradients at
    full width, B=4, on the card against the CPU on the same params, for each
    batch of CAPTION_PARITY_SEEDS. ReLU's derivative steps at 0, so a
    pre-activation within rounding of 0 may fall on the other side on the
    CPU, and the gradient rows it gates move by their whole size (the
    transformer mapper of phase 34; the MLP mapper's tanh has no step): the
    CPU run takes the card run's ReLU masks, and the pre-activations whose
    sign the CPU's own forward gives otherwise are counted, with the reading
    against the CPU run on its own masks beside. The first batch's step with
    the card's GEMMs in TF32 is the control."""
    import dataclasses

    from construction_clip_tpu_torch.train.caption import loss_and_grads

    _, gcfg, ccfg = cfgs
    ccfg = dataclasses.replace(ccfg, only_prefix=False)
    tree = convert.init_clipcap(5, ccfg, gcfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    names = None

    def run(dev, batch, record, replay=None, allow_tf32=False):
        nonlocal names
        params = convert.to_params(tree, device=dev, trainable=True)
        names = list(_paths(as_tree(params)))
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        try:
            t0 = time.perf_counter()
            with relu_masks(record, replay):
                loss, grads = loss_and_grads(
                    params, None, ccfg, gcfg,
                    {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            return float(loss), [g.cpu() for g in tree_leaves(grads)], time.perf_counter() - t0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    def errors(a, b):
        floor = 1e-6 * max(float(g.abs().max()) for g in b[1])
        return {n: float((x - y).abs().max()) / (float(y.abs().max()) + floor)
                for n, x, y in zip(names, a[1], b[1])}

    per_batch, control = [], None
    for seed in CAPTION_PARITY_SEEDS:
        batch = caption_archive(np.random.default_rng(seed), 4, ccfg, gcfg)
        card_masks, cpu_masks = [], []
        card = run(device, batch, card_masks)
        cpu = run("cpu", batch, cpu_masks, replay=card_masks)
        # no ReLU: the CPU's own masks are the card's
        own = run("cpu", batch, []) if card_masks else cpu
        errs, own_errs = errors(card, cpu), errors(card, own)
        worst, own_worst = max(errs, key=errs.get), max(own_errs, key=own_errs.get)
        per_batch.append({
            "seed": seed, "loss_card": card[0], "loss_cpu": cpu[0],
            "loss_rel_err": abs(card[0] - cpu[0]) / cpu[0], "worst_leaf": worst,
            "worst_leaf_err": errs[worst], "wte_err": errs["gpt/wte"],
            "relu_elements": sum(m.numel() for m in card_masks),
            "relu_signs_the_cpu_gives_otherwise": sum(
                int((a != b).sum()) for a, b in zip(card_masks, cpu_masks)),
            "worst_leaf_with_the_cpus_own_masks": own_worst,
            "worst_leaf_err_with_the_cpus_own_masks": own_errs[own_worst],
            "errors_by_leaf": {n: errs[n] for n in sorted(errs, key=errs.get)[-4:]},
            "card_s": card[2], "cpu_s": cpu[2]})
        if control is None:
            tf32_run = run(device, batch, [], allow_tf32=True)
            control = errors(tf32_run, cpu)
            control_loss_err = abs(tf32_run[0] - cpu[0]) / cpu[0]
    control_worst = max(control, key=control.get)
    report = {"batch": 4, "leaves": len(names), "tol": CAPTION_GRAD_TOL,
              "worst_leaf_err": max(r["worst_leaf_err"] for r in per_batch),
              "loss_rel_err": max(r["loss_rel_err"] for r in per_batch),
              "relu_signs_the_cpu_gives_otherwise": sum(
                  r["relu_signs_the_cpu_gives_otherwise"] for r in per_batch),
              "tf32_worst_leaf": control_worst, "tf32_worst_leaf_err": control[control_worst],
              "tf32_loss_rel_err": control_loss_err, "batches": per_batch}
    say(name, **report)
    if report["loss_rel_err"] > 1e-5 or report["worst_leaf_err"] > CAPTION_GRAD_TOL:
        raise AssertionError(f"caption step, card against CPU: {report}")
    if control[control_worst] <= CAPTION_GRAD_TOL:
        raise AssertionError(f"caption step: the TF32 control is within the bound: {report}")


def _record_checks(records, n: int) -> None:
    if len(records) != n:
        raise AssertionError(f"predict: {len(records)} records for {n} images")
    for r in records:
        if list(r) != PREDICT_KEYS or r["caption_type"] not in ("violation", "status") or \
                r["violation_type"] not in VIOLATION_TYPES or not isinstance(r["caption"], str):
            raise AssertionError(f"predict: bad record {r}")


def _predict_gaps(pipe: CaptionPipeline, staged, rows) -> list:
    """Phase 6's check for greedy captions that differ between the kernel and
    the plain path of an fp32 pipeline: at each such row's first differing
    token, the plain path's top-2 logit gap."""
    gpt = as_tree(pipe.cap_params)["gpt"]
    with torch.inference_mode():
        images = preprocess_batch(staged, pipe.clip_cfg.vision.image_size, device=pipe.device)
        emb, attrs = pipe.classify_and_embed(images)
        embeds = pipe.prompt_embeds(emb, pipe.attribute_tokens(attrs))
        toks = {}
        for impl in ("kernel", "plain"):
            with use_impl(impl):
                toks[impl] = greedy_decode(gpt, pipe.gcfg, embeds, max_steps=pipe.max_steps,
                                           stop_token=pipe.stop_token).tokens
    gaps = plain_top2_gaps(gpt, pipe.gcfg, embeds, toks["plain"])
    out = []
    for row in rows:
        diff = (toks["kernel"][row] != toks["plain"][row]).nonzero()
        step = int(diff[0]) if len(diff) else None
        out.append({"row": row, "step": step,
                    "plain_top2_gap": None if step is None else float(gaps[row, step])})
    return out


def phase_predict(clip_np, cap_npz: str, cfgs, clip_tok, lm_tok, device="cuda",
                  n_images: int = 32, batch: int = 16, name: str = "predict") -> dict:
    """Phases 29 and 35: the port's apps/predict.make_process at full width on
    the caption params of `cap_npz` (phase 27's or 34's full fine-tune),
    bf16, beam 3, 100 steps, `n_images` synthetic images of mixed sizes
    staged by host_shape_unify in batches of `batch`; then the same images in
    fp32, greedy, on the kernel and the plain path. K1 launches once an
    image-tower block and once a transformer-mapper block a batch."""
    from construction_clip_tpu_torch.apps.predict import make_process
    from construction_clip_tpu_torch.data.pipeline import host_shape_unify
    from construction_clip_tpu_torch.data.schema import Annotation
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    clip_cfg, gcfg, ccfg = cfgs
    cap_tree = load_params_npz(cap_npz, convert.init_clipcap(convert.SHAPES, ccfg, gcfg))
    rng = np.random.default_rng(29)
    shapes = [(480, 640), (768, 1024), (256, 256), (600, 400), (1080, 1920), (300, 500)]
    images = synthetic_images(rng, [shapes[i % len(shapes)] for i in range(n_images)])
    staged = np.stack([host_shape_unify(im, 256) for im in images])
    anns = [Annotation(id=i, file_name=f"site_{i}.jpg", caption=f"gt {i}",
                       caption_type="violation", violation_type=VIOLATION_TYPES[i % 9])
            for i in range(n_images)]
    batches = [(anns[i:i + batch], staged[i:i + batch]) for i in range(0, n_images, batch)]

    def run(process):
        with contextlib.redirect_stdout(io.StringIO()):   # the app prints each record
            return [r for b_anns, b_staged in batches for r in process(b_anns, b_staged)]

    process = make_process(convert.to_params(clip_np, dtype=torch.bfloat16, device=device),
                           clip_cfg,
                           convert.to_params(cap_tree, dtype=torch.bfloat16, device=device),
                           ccfg, gcfg, clip_tok, lm_tok, use_beam=True, policy=BF16_POLICY,
                           device=device)
    with contextlib.redirect_stdout(io.StringIO()):
        process(*batches[0])   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    records = run(process)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launches().items() if k in SERVE_KERNELS}
    tc_k1 = tc_launches()["fused_attention_block"]
    _record_checks(records, n_images)
    mapper = mapper_launches(ccfg, gcfg, len(batches))
    tower = tower_launches(clip_cfg, torch.bfloat16)
    want_k1 = tower["launches"] * len(batches) + mapper["launches"]["fused_attention_block"]
    want_tc = tower["tc"] * len(batches) + mapper["tc"]["fused_attention_block"]
    if (counts["fused_attention_block"], tc_k1) != (want_k1, want_tc) or \
            counts["decode_step_attention"] <= 0:
        raise AssertionError(f"{name}: launches {counts}, K1 on the tensor cores {tc_k1}; "
                             f"want K1 {want_k1}, {want_tc} of them on the tensor cores")
    del process

    fp32 = {}
    clip_p, cap_p = (convert.to_params(clip_np, device=device),
                     convert.to_params(cap_tree, device=device))
    for impl in ("kernel", "plain"):
        proc = make_process(clip_p, clip_cfg, cap_p, ccfg, gcfg, clip_tok, lm_tok,
                            use_beam=False, policy=DEFAULT_POLICY, device=device)
        reset_launches()
        with use_impl(impl):
            fp32[impl] = run(proc)
        fp32[impl + "_launches"] = {k: v for k, v in launches().items() if k in SERVE_KERNELS}
    if min(fp32["kernel_launches"].values()) <= 0 or any(fp32["plain_launches"].values()):
        raise AssertionError(f"fp32 paths not as asked: kernel {fp32['kernel_launches']}, "
                             f"plain {fp32['plain_launches']}")
    _record_checks(fp32["kernel"], n_images)
    for key in ("caption_type", "violation_type"):
        if [r[key] for r in fp32["kernel"]] != [r[key] for r in fp32["plain"]]:
            raise AssertionError(f"predict fp32: {key} differs between kernel and plain")
    differ = [i for i, (a, b) in enumerate(zip(fp32["kernel"], fp32["plain"]))
              if a["caption"] != b["caption"]]
    mismatches = []
    pipe = CaptionPipeline(clip_params=clip_p, clip_cfg=clip_cfg, cap_params=cap_p, ccfg=ccfg,
                           gcfg=gcfg, clip_tokenizer=clip_tok, lm_tokenizer=lm_tok)
    for start in range(0, n_images, batch):
        rows = [i - start for i in differ if start <= i < start + batch]
        if rows:
            for m in _predict_gaps(pipe, staged[start:start + batch], rows):
                mismatches.append(dict(m, row=m["row"] + start))
    for m in mismatches:
        if m["plain_top2_gap"] is None or m["plain_top2_gap"] >= 1e-3:
            raise AssertionError(f"predict fp32: greedy captions differ: {m}")
    out = {"images": n_images, "batch": batch, "batches": len(batches), "wall_s": wall,
           "s_per_batch": wall / len(batches), "images_per_s": n_images / wall,
           "launches": counts, "tc_launches": tc_k1,
           "decode_suspect": sum(r["decode_suspect"] for r in records),
           "fp32_classes_equal": True, "fp32_greedy_captions_equal": n_images - len(mismatches),
           "fp32_mismatches": mismatches, "fp32_kernel_launches": fp32["kernel_launches"],
           "k1_launches_a_batch": counts["fused_attention_block"] / len(batches),
           "k1_simt_launches": counts["fused_attention_block"] - tc_k1,
           "captions": [r["caption"][:24] for r in records[:2]]}
    say(name, **out)
    return out


# ---- mT5 caption training, and the predict_t5 app on what it trained -------------------

T5_CAPTION_BATCH, T5_CAPTION_STEPS, T5_MAX_LENGTH = 40, 10, 32   # the JAX app's --bs, --max_length
BPE_VOCAB = 30000   # train_tokenizer's default --vocab_size: the ids a caption holds
# the full fine-tune's fp32 gradients on the card against the CPU's, each leaf's
# largest difference over its largest element plus 1e-6 of the largest element
# of any leaf, as CAPTION_GRAD_TOL. Sums in another order through 8+8 layers
# and a 250,112-way softmax, and the scatter-add of both stacks' input
# gradients into `shared`: a sound run on an H100 read 5.0e-6 at worst
# (decoder/ln_cross), 1.9e-6 on shared, 6.0e-7 on lm_head; the same step with
# the card's GEMMs in TF32, the phase's control, read 2.9e-3 (encoder/attn/k)
# and 9.8e-4 on shared. The bound sits 60x above the sound reading (room for
# another CPU's summation order, which moved phase 28's by 30x) and ~10x
# below the control.
T5_CAPTION_GRAD_TOL = 3e-4
PREDICT_T5_KEYS = ["id", "file_name", "attribute", "caption", "ground_truth_caption"]


def t5_caption_archive(rng, n: int, ccfg) -> dict:
    """The arrays apps/train_clipcap_t5.py trains on: prefix [n, clip_dim] fp32
    embeddings, captions of 8-32 ids drawn Zipf-like from the ids of a
    30,000-entry BPE vocabulary (above its 5 specials), zero-padded to 32,
    and their attention mask."""
    ids = rng.permutation(np.arange(5, BPE_VOCAB))
    weights = 1.0 / np.arange(1, len(ids) + 1)
    weights /= weights.sum()
    tokens = np.zeros((n, T5_MAX_LENGTH), np.int32)
    for i, length in enumerate(rng.integers(8, T5_MAX_LENGTH + 1, n)):
        tokens[i, :length] = rng.choice(ids, size=length, p=weights)
    return {"input_ids": tokens, "attention_mask": (tokens != 0).astype(np.int32),
            "prefix": rng.standard_normal((n, ccfg.clip_dim)).astype(np.float32)}


def t5_caption_batch_loss(state, frozen, ccfg, tcfg, batch) -> float:
    """The bf16 caption loss of `batch` at the state's params."""
    from construction_clip_tpu_torch.models.clipcap.t5_model import (
        clipcap_t5_forward, t5_caption_loss)

    params = as_tree(state.params)
    params = {"mapper": params, "t5": frozen} if ccfg.only_prefix else params
    with torch.inference_mode():
        logits = clipcap_t5_forward(params, ccfg, tcfg, input_ids=batch["input_ids"],
                                    attention_mask=batch["attention_mask"],
                                    clip_embed=batch["prefix"], policy=BF16_POLICY)
        return float(t5_caption_loss(logits, batch["input_ids"], ccfg))


def phase_t5_caption_train(cfgs, tree, out_npz: str, device="cuda") -> dict:
    """Phase 30: make_t5_caption_train_step in bf16 on TorchArrayLoader batches
    of a synthetic archive, T5_CAPTION_STEPS steps of T5_CAPTION_BATCH rows in
    each mode, from the numpy tree `tree`; the full fine-tune's params are
    saved to `out_npz`."""
    import dataclasses

    from construction_clip_tpu_torch.data.loader import TorchArrayLoader
    from construction_clip_tpu_torch.train.checkpoint import save_params_npz
    from construction_clip_tpu_torch.train.t5 import make_t5_caption_train_step

    _, ccfg, tcfg = cfgs
    arrays = t5_caption_archive(np.random.default_rng(30),
                                T5_CAPTION_BATCH * T5_CAPTION_STEPS, ccfg)
    out = {}
    for mode in ("only_prefix", "full"):
        mcfg = dataclasses.replace(ccfg, only_prefix=mode == "only_prefix")
        if mcfg.only_prefix:   # the frozen T5 cast to bf16 once, before the steps
            params = convert.to_params(tree["mapper"], device=device, trainable=True)
            frozen = BF16_POLICY.cast_to_compute(convert.to_params(tree["t5"],
                                                                   device=device).tree())
        else:
            params, frozen = convert.to_params(tree, device=device, trainable=True), None
        tx = make_adamw(1e-4, warmup_steps=1, total_steps=100)
        state = TrainState.create(params, tx)
        step = make_t5_caption_train_step(mcfg, tcfg, tx, policy=BF16_POLICY, device=device)
        loader = TorchArrayLoader(arrays, batch_size=T5_CAPTION_BATCH, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated()   # params, moments, earlier phases' tensors
        reset_launches()
        losses, times = [], []
        t0 = time.perf_counter()
        for batch in loader:
            if not losses:
                first = batch
            state, m = step(state, frozen, batch)
            losses.append(float(m["loss"]))   # waits for the step
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        counts = launches()
        peak = (torch.cuda.max_memory_allocated() - at_start) / 2 ** 30
        first_after = t5_caption_batch_loss(state, frozen, mcfg, tcfg, first)
        if len(losses) != T5_CAPTION_STEPS or not all(np.isfinite(losses)) or \
                not first_after < losses[0]:
            raise AssertionError(f"mT5 caption training {mode}: losses {losses}, the first "
                                 f"batch's after the steps {first_after}")
        if any(counts.values()):
            raise AssertionError(f"mT5 caption training {mode} launched a kernel: {counts}")
        per_kernel = kernel_device_ms(lambda: step(state, frozen, batch), reps=2)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        out[mode] = {"batch": T5_CAPTION_BATCH, "steps": T5_CAPTION_STEPS, "losses": losses,
                     "first_batch_loss_after": first_after,
                     "median_step_ms": statistics.median(times) * 1e3,
                     "step_device_ms": sum(per_kernel.values()), "kernels_by_device_ms": top,
                     "peak_memory_above_start_gib": peak,
                     "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "trainable_params": sum(p.numel() for p in tree_leaves(as_tree(params))),
                     "launches": counts}
        say(f"t5_caption_train_{mode}", **out[mode])
        if mode == "full":
            save_params_npz(out_npz, state.params)
        del params, frozen, state, step
        torch.cuda.empty_cache()
    return out


def phase_t5_caption_parity(cfgs, tree, device="cuda") -> None:
    """Phase 31: one full fine-tune step's fp32 loss and gradients at full
    width, B=4, on the card against the CPU on the same params and batch;
    then the card's step with TF32 GEMMs, the control that must read above
    the bound."""
    import dataclasses

    from construction_clip_tpu_torch.train.t5 import loss_and_grads

    _, ccfg, tcfg = cfgs
    ccfg = dataclasses.replace(ccfg, only_prefix=False)
    batch = t5_caption_archive(np.random.default_rng(31), 4, ccfg)
    runs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for run, dev in (("card", device), ("cpu", "cpu"), ("card_tf32", device)):
        params = convert.to_params(tree, device=dev, trainable=True)
        names = list(_paths(as_tree(params)))
        torch.backends.cuda.matmul.allow_tf32 = run == "card_tf32"
        try:
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(
                params, None, ccfg, tcfg,
                {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            runs[run] = (float(loss), [g.cpu() for g in tree_leaves(grads)],
                         time.perf_counter() - t0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del params, grads
        torch.cuda.empty_cache()
    l_cpu, g_cpu, s_cpu = runs["cpu"]
    floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu)

    def errors(run):
        return {n: float((a - b).abs().max()) / (float(b.abs().max()) + floor)
                for n, a, b in zip(names, runs[run][1], g_cpu)}

    errs, control = errors("card"), errors("card_tf32")
    worst, control_worst = max(errs, key=errs.get), max(control, key=control.get)
    l_card, s_card = runs["card"][0], runs["card"][2]
    report = {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel_err": abs(l_card - l_cpu) / l_cpu,
              "leaves": len(names), "worst_leaf": worst, "worst_leaf_err": errs[worst],
              "shared_err": errs["t5/shared"], "lm_head_err": errs["t5/lm_head"],
              "tol": T5_CAPTION_GRAD_TOL,
              "tf32_worst_leaf": control_worst, "tf32_worst_leaf_err": control[control_worst],
              "tf32_shared_err": control["t5/shared"], "tf32_lm_head_err": control["t5/lm_head"],
              "tf32_loss_rel_err": abs(runs["card_tf32"][0] - l_cpu) / l_cpu,
              "errors_by_leaf": {n: errs[n] for n in sorted(errs, key=errs.get)[-6:]},
              "card_s": s_card, "cpu_s": s_cpu}
    say("t5_caption_parity", batch=4, **report)
    if report["loss_rel_err"] > 1e-5 or errs[worst] > T5_CAPTION_GRAD_TOL:
        raise AssertionError(f"mT5 caption step, card against CPU: {report}")
    if control[control_worst] <= T5_CAPTION_GRAD_TOL:
        raise AssertionError(f"mT5 caption step: the TF32 control is within the bound: {report}")


def phase_predict_t5(clip_np, t5_npz: str, cfgs, clip_tok, lm_tok, device="cuda",
                     n_images: int = 16, batch: int = 8) -> dict:
    """Phase 32: the port's apps/predict_t5.make_process at full width on the
    caption params of `t5_npz` (phase 30's full fine-tune), bf16, greedy, 32
    steps, `n_images` synthetic images staged by host_shape_unify in batches
    of `batch` (K8's rows)."""
    from construction_clip_tpu_torch.apps.predict_t5 import make_process
    from construction_clip_tpu_torch.data.pipeline import host_shape_unify
    from construction_clip_tpu_torch.data.schema import Annotation
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    clip_cfg, ccfg, tcfg = cfgs
    cap_tree = load_params_npz(t5_npz, convert.init_clipcap_t5(convert.SHAPES, ccfg, tcfg))
    rng = np.random.default_rng(32)
    shapes = [(480, 640), (256, 256), (600, 400), (1080, 1920)]
    images = synthetic_images(rng, [shapes[i % len(shapes)] for i in range(n_images)])
    staged = np.stack([host_shape_unify(im, 256) for im in images])
    anns = [Annotation(id=i, file_name=f"site_{i}.jpg", caption=f"gt {i}")
            for i in range(n_images)]
    batches = [(anns[i:i + batch], staged[i:i + batch]) for i in range(0, n_images, batch)]
    process = make_process(convert.to_params(clip_np, dtype=torch.bfloat16, device=device),
                           clip_cfg,
                           convert.to_params(cap_tree, dtype=torch.bfloat16, device=device),
                           ccfg, tcfg, clip_tok, lm_tok, max_length=T5_MAX_LENGTH, greedy=True,
                           policy=BF16_POLICY, device=device)
    with contextlib.redirect_stdout(io.StringIO()):   # the app prints each caption
        process(*batches[0])   # warm-up
        torch.cuda.synchronize()
        records, k8, k1, tokens = [], [], 0, 0
        t0 = time.perf_counter()
        for b_anns, b_staged in batches:
            reset_launches()
            recs, res = process(b_anns, b_staged)
            counts = launches()
            steps = int(res.lengths.max())
            if counts["vocab_head_logits"] != steps + 1:
                raise AssertionError(f"predict_t5: K8 launched {counts['vocab_head_logits']} "
                                     f"times for {steps} steps, not steps + 1")
            k8.append(counts["vocab_head_logits"])
            k1 += counts["fused_attention_block"]
            tokens += int(res.lengths.sum())
            records += recs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if len(records) != n_images or any(list(r) != PREDICT_T5_KEYS or not r["attribute"] or
                                       not isinstance(r["caption"], str) for r in records):
        raise AssertionError(f"predict_t5: bad records {records[:2]}")
    if k1 <= 0:
        raise AssertionError("predict_t5: the image tower did not run K1")
    out = {"images": n_images, "batch": batch, "batches": len(batches), "wall_s": wall,
           "s_per_batch": wall / len(batches), "tokens_per_s": tokens / wall,
           "k8_launches_by_batch": k8, "k1_launches": k1,
           "captions": [r["caption"][:24] for r in records[:2]]}
    say("predict_t5", **out)
    return out


# ---- K1/K3 at dh 96, the transformer mappers, explainability, train_clip_caption -----------

# GPT-2's transformer mapper in predict: batch 16, clip_length 10 + prefix 20 rows,
# width 768 in 8 heads of 96 (the SIMT route: the tensor-core route takes dh 64)
DH96_SHAPE = (16, 30, 768, 8)
# the transformer mappers of phases 34, 35 (GPT-2) and 38 (mT5): 8 blocks over
# clip_length 10 rows, the clip length predict and predict_t5 build
MAPPER_CCFG = ClipCapConfig(mapper="transformer", mapper_layers=8, clip_length=10)
# R_image and R_text of the fp32 relevance on the card against the CPU's on the same
# inputs, as their largest difference over the CPU's largest |R|, as
# CAPTION_GRAD_TOL holds a gradient: R is one block's clamp(grad x probs) (start
# layer -1), each a product of a 12-block forward and a short backward whose fp32
# sums run in another order on the card. The same run with the card's GEMMs in
# TF32 (10-bit mantissas, 2^-11 a product) is the control and must read above.
EXPLAIN_TOL = 3e-4
EXPLAIN_IMAGES = 4
CLIP_CAPTION_BATCH, CLIP_CAPTION_STEPS = 8, 10   # the JAX app's --batch_size, a device


def phase_dh96(results: dict) -> None:
    """Phase 33: K1 and K3 at DH96_SHAPE, bf16 and fp32, against their plain
    versions, on the SIMT route; times, device times (CUDA-graph replays),
    the bound and the composed library block's device time (its forward
    beside K1, its autograd backward beside K3)."""
    from construction_clip_tpu_torch.ops.attention_block import route, supported

    b, t, d, h = DH96_SHAPE
    rng = np.random.default_rng(33)
    names = ("dx", "dqkv", "merged", "dln_scale", "dln_bias")
    for dtype in (torch.bfloat16, torch.float32):
        x, ln, attn = _block_inputs(rng, b, t, d, dtype, "cuda")
        g = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to("cuda", dtype)
        args = (ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"],
                attn["b_out"])
        what = f"{[b, t, d]} h={h} {dtype}"
        if not supported(x, h) or route(dtype, d // h) != "simt":
            raise AssertionError(f"dh 96 {what}: not on K1/K3's SIMT route")

        def fwd():
            return fused_attention_block(x, ln, attn, n_heads=h)

        def bwd():
            return fused_attention_block_bwd(x, g, *args[:5], n_heads=h)

        def fused_block(*a):
            return fused_attention_block(a[0], {"scale": a[1], "bias": a[2]},
                                         {"w_qkv": a[3], "b_qkv": a[4], "w_out": a[5],
                                          "b_out": a[6]}, n_heads=h)

        def composed(*a):
            return composed_block(*a, n_heads=h, causal=False)

        reset_launches()
        got_f, got_b = fwd(), bwd()
        torch.cuda.synchronize()
        counts, tc = launches(), tc_launches()
        if (counts["fused_attention_block"], counts["fused_attention_block_bwd"]) != (1, 1) or \
                tc["fused_attention_block"] or tc["fused_attention_block_bwd"]:
            raise AssertionError(f"dh 96 {what}: launches {counts}, tensor-core {tc}")
        m = b * t
        k1 = compare(got_f, fused_attention_block_plain(x, *args, n_heads=h),
                     *K1_TOL[dtype], what=f"K1 {what}")
        k1.update(route="simt", ms=median_ms(fwd), device_ms=graph_ms(fwd),
                  plain_ms=median_ms(lambda: fused_attention_block_plain(x, *args, n_heads=h)),
                  composed_device_ms=graph_ms(lambda: composed(x, *args)),
                  **bound(nbytes(x, *args, x),
                          {dtype: 2 * m * d * 4 * d + attention_ops(b, h, t, d // h, 2)}))
        say("k1_dh96", shape=[b, t, d], heads=h, dtype=str(dtype), **k1)
        per = {n: compare_scaled(a, w, GRAD_TOL[dtype], f"K3 {what} {n}") for n, a, w in
               zip(names, got_b, fused_attention_block_bwd_plain(x, g, *args[:5], n_heads=h))}
        k3 = _merge(per)
        k3.update(route="simt", ms=median_ms(bwd, 11, 3), device_ms=graph_ms(bwd),
                  plain_ms=median_ms(lambda: fused_attention_block_bwd_plain(
                      x, g, *args[:5], n_heads=h), 11, 3),
                  block_backward_device_ms=backward_device_ms(fused_block, (x, *args), g),
                  composed_backward_device_ms=backward_device_ms(composed, (x, *args), g),
                  **bound(nbytes(x, g, *args[:5], *got_b),
                          {dtype: 2 * m * d * 7 * d + attention_ops(b, h, t, d // h, 6)}))
        say("k3_dh96", shape=[b, t, d], heads=h, dtype=str(dtype),
            scaled_err={n: v["max_scaled_err"] for n, v in per.items()}, **k3)
        results[str(dtype)] = {"k1": k1, "k3": k3}


def phase_explain(clip_np, cap_npz: str, cfgs, clip_tok, lm_tok, device="cuda") -> dict:
    """Phase 36: apps/predict.make_explain at full width (ViT-B/32, GPT-2 base,
    phase 27's npz), fp32, on EXPLAIN_IMAGES staged 256x256 images captioned
    greedily: seconds an image; no kernel launched inside interpret; each
    decoder attention row a distribution; R_image and R_text on the card
    against the CPU's on the same inputs, with the TF32 control."""
    from construction_clip_tpu_torch.apps.predict import make_explain, make_process
    from construction_clip_tpu_torch.data.schema import Annotation
    from construction_clip_tpu_torch.infer.explain import interpret
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    clip_cfg, gcfg, ccfg = cfgs
    cap_tree = load_params_npz(cap_npz, convert.init_clipcap(convert.SHAPES, ccfg, gcfg))
    staged = np.stack(synthetic_images(np.random.default_rng(36),
                                       [(256, 256)] * EXPLAIN_IMAGES))
    anns = [Annotation(id=i, file_name=f"site_{i}.jpg") for i in range(EXPLAIN_IMAGES)]
    clip_p = convert.to_params(clip_np, device=device)
    cap_p = as_tree(convert.to_params(cap_tree, device=device))
    process = make_process(clip_p, clip_cfg, cap_p, ccfg, gcfg, clip_tok, lm_tok,
                           use_beam=False, policy=DEFAULT_POLICY, device=device)
    with contextlib.redirect_stdout(io.StringIO()):
        records = process(anns, staged)
    explain = make_explain(process.pipe, clip_p, cap_p["gpt"], device=device)
    explain(staged[:1], records[:1])   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    items = explain(staged, records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    explain_counts = {k: v for k, v in launches().items() if v}
    for rec, item in zip(records, items):
        if item["overlay"].shape != staged.shape[1:] or item["overlay"].dtype != np.uint8 or \
                not item["char_scores"]:
            raise AssertionError(f"explain: bad overlay or text scores for {rec['caption']!r}")
        rows = item["attention"]
        if rows is None or not np.allclose(rows.sum(-1), 1.0, atol=1e-5) or \
                rows.shape[0] != len(item["labels"]):
            raise AssertionError(f"explain: attention rows are not distributions: {rows}")

    images = preprocess_batch(staged, clip_cfg.vision.image_size, device=device)
    tokens = clip_tok.tokenize([r["caption"] or r["attribute"] for r in records],
                               clip_cfg.text.context_length)
    reset_launches()
    runs = {"card": interpret(clip_p, clip_cfg, images, tokens)}
    torch.cuda.synchronize()
    inside = launches()
    if any(inside.values()):
        raise AssertionError(f"interpret launched a kernel: {inside}")
    cpu_p = convert.to_params(clip_np)
    t0 = time.perf_counter()
    runs["cpu"] = interpret(cpu_p, clip_cfg, images.cpu(), tokens)
    cpu_s = time.perf_counter() - t0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        runs["card_tf32"] = interpret(clip_p, clip_cfg, images, tokens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def errors(run):
        return {name: float((got.cpu() - want).abs().max() / want.abs().max())
                for name, got, want in zip(("R_text", "R_image"), runs[run], runs["cpu"])}

    errs, control = errors("card"), errors("card_tf32")
    out = {"images": EXPLAIN_IMAGES, "wall_s": wall, "s_per_image": wall / EXPLAIN_IMAGES,
           "launches_in_explain": explain_counts, "launches_in_interpret": 0,
           "errors": errs, "tol": EXPLAIN_TOL, "tf32_errors": control, "cpu_interpret_s": cpu_s,
           "attention_rows": [list(i["attention"].shape) for i in items],
           "captions": [r["caption"][:24] for r in records[:2]]}
    say("explain", **out)
    if max(errs.values()) > EXPLAIN_TOL:
        raise AssertionError(f"explain: R on the card against the CPU: {out}")
    if max(control.values()) <= EXPLAIN_TOL:
        raise AssertionError(f"explain: the TF32 control is within the bound: {out}")
    return out


def phase_clip_caption(cfg, clip_tok, device="cuda") -> dict:
    """Phase 37: the train_clip_caption app's own loop (train_clip.fit) at
    ViT-B/32, bf16, --batch_size CLIP_CAPTION_BATCH, with the 49,408-token
    BPE: one epoch of CLIP_CAPTION_STEPS steps over (image, violation_list)
    pairs of CaptionPairDataset, the images through TorchImageTextLoader's
    load_image hook (synthetic arrays, no PIL), then the epoch's eval and
    checkpoints. K1 and K3 launch once a tower block a step (K1 also in
    each eval batch), all on the tensor cores; the first batch's loss after
    the epoch is below its loss at the first step; the median step and its
    device time are read from the app's steps."""
    from unittest import mock

    from construction_clip_tpu_torch.apps import train_clip_caption
    from construction_clip_tpu_torch.data import pipeline

    rng = np.random.default_rng(37)
    n_train = CLIP_CAPTION_BATCH * CLIP_CAPTION_STEPS
    n = n_train * 5 // 4   # train_ratio 0.8: n_train pairs to train, the rest to eval
    arrays = dict(zip([f"site_{i}.jpg" for i in range(n)],
                      synthetic_images(rng, [(300, 400)] * n)))
    anns = [{"id": i, "caption_type": "violation", "violation_type": VIOLATION_TYPES[i % 9],
             "violation_list": f"{VIOLATION_TYPES[i % 9]}缺失{i}", "caption": "",
             "file_name": f"site_{i}.jpg", "objects": ""} for i in range(n)]

    def load_image(path):
        return arrays[os.path.basename(path)]

    seen = {"losses": [], "times": []}
    make_train_step = contrastive.make_train_step

    def timed_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def timed(state, batch):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            seen["losses"].append(float(m["loss"]))   # waits for the step
            seen["times"].append(time.perf_counter() - t0)
            seen.setdefault("first", batch)
            seen.update(step=step, state=state, batch=batch)
            return state, m
        return timed

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "all.json")
        with open(corpus, "w", encoding="utf-8") as f:
            json.dump({"type": "captions", "annotations": anns}, f, ensure_ascii=False)
        merges = os.path.join(tmp, "clip_merges.txt.gz")
        offline_assets.write_clip_merges(merges)
        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(pipeline, "default_load_image", load_image), \
                mock.patch.object(contrastive, "make_train_step", timed_train_step), \
                contextlib.redirect_stdout(io.StringIO()):
            train_clip_caption.main(
                ["--json_path", corpus, "--image_path", tmp, "--arch", "vit_b_32",
                 "--precision", "bf16", "--batch_size", str(CLIP_CAPTION_BATCH),
                 "--clip_bpe", merges, "--epochs", "1", "--save_every", "1",
                 "--lr", "1e-4", "--warmup_steps", "0", "--output_dir", os.path.join(tmp, "m"),
                 "--log_dir", os.path.join(tmp, "log"), "--device", device])
        wall = time.perf_counter() - t0
        counts, tc = launches(), tc_launches()
        npz = os.path.exists(os.path.join(tmp, "m", "clip_cap_latest.npz"))
        with open(os.path.join(tmp, "log", "clip_cap.jsonl"), encoding="utf-8") as f:
            logged = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    step, state = seen["step"], seen["state"]
    first_after = float(step(state, seen["first"])[1]["loss"])
    blocks_a_pass = cfg.vision.layers + cfg.text.layers
    eval_batches = (n - n_train) // CLIP_CAPTION_BATCH   # the loader drops a last part
    want = {name: 0 for name in WRAPPERS}
    want.update(fused_attention_block=blocks_a_pass * (CLIP_CAPTION_STEPS + eval_batches),
                fused_attention_block_bwd=blocks_a_pass * CLIP_CAPTION_STEPS)
    need = ("fused_attention_block", "fused_attention_block_bwd")
    out = {"batch": CLIP_CAPTION_BATCH, "steps": len(seen["losses"]),
           "losses": seen["losses"], "first_batch_loss_after": first_after,
           "median_step_ms": statistics.median(seen["times"]) * 1e3,
           "step_device_ms": sum(kernel_device_ms(lambda: step(state, seen["batch"]),
                                                  reps=2).values()),
           "wall_s": wall, "logged_losses": logged, "npz": npz,
           "launches": {k: v for k, v in counts.items() if v},
           "tc_launches": {k: tc[k] for k in need}}
    say("clip_caption", **out)
    if len(seen["losses"]) != CLIP_CAPTION_STEPS or not np.isfinite(seen["losses"]).all() \
            or not npz or not logged:
        raise AssertionError(f"train_clip_caption app: {out}")
    if counts != want:
        raise AssertionError(f"train_clip_caption: launches {counts}; want {want}")
    check_tc_route("train_clip_caption bf16", counts, tc, need)
    if not first_after < seen["losses"][0]:
        raise AssertionError(f"train_clip_caption: the first batch's loss did not fall: {out}")
    return out


def phase_t5_mapper(clip_np, cfgs, clip_tok, lm_tok, device="cuda", steps: int = 3) -> dict:
    """Phase 38: train/t5.make_t5_caption_train_step with the transformer
    mapper (MAPPER_CCFG at mT5's width 512, 8 heads of 64), full fine-tune,
    bf16, `steps` steps of T5_CAPTION_BATCH rows: K1 and K3 once a mapper
    block a step, all on the tensor cores; then one predict_t5 batch of 8 on
    the trained params: K1 12 + 8 times on the tensor cores, K8 steps + 1."""
    import dataclasses

    from construction_clip_tpu_torch.apps.predict_t5 import make_process
    from construction_clip_tpu_torch.data.loader import TorchArrayLoader
    from construction_clip_tpu_torch.data.schema import Annotation
    from construction_clip_tpu_torch.models.clipcap.t5_model import mapper_shape
    from construction_clip_tpu_torch.train.t5 import make_t5_caption_train_step

    clip_cfg, ccfg, tcfg = cfgs
    mcfg = dataclasses.replace(MAPPER_CCFG, attribute_length=0, only_prefix=False)
    params = convert.to_params(convert.init_clipcap_t5(38, mcfg, tcfg), device=device,
                               trainable=True)
    tx = make_adamw(1e-4, warmup_steps=1, total_steps=100)
    state = TrainState.create(params, tx)
    step = make_t5_caption_train_step(mcfg, tcfg, tx, policy=BF16_POLICY, device=device)
    loader = TorchArrayLoader(t5_caption_archive(np.random.default_rng(38),
                                                 T5_CAPTION_BATCH * steps, mcfg),
                              batch_size=T5_CAPTION_BATCH, device=device)
    reset_launches()
    losses, times = [], []
    for batch in loader:
        t0 = time.perf_counter()
        state, m = step(state, None, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    counts, tc = launches(), tc_launches()
    want = mapper_launches(mcfg, mapper_shape(tcfg), steps)
    if counts != want["launches"] or {k: tc[k] for k in want["tc"]} != want["tc"] or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"mT5 mapper training: losses {losses}, launches {counts}, "
                             f"tensor-core {tc}; want {want}")
    cap = BF16_POLICY.cast_to_compute(tree_map(lambda v: v.detach(), as_tree(state.params)))
    del state, step, params
    process = make_process(convert.to_params(clip_np, dtype=torch.bfloat16, device=device),
                           clip_cfg, cap, mcfg, tcfg, clip_tok, lm_tok,
                           max_length=T5_MAX_LENGTH, greedy=True, policy=BF16_POLICY,
                           device=device)
    staged = np.stack(synthetic_images(np.random.default_rng(39), [(256, 256)] * 8))
    anns = [Annotation(id=i, file_name=f"site_{i}.jpg", caption=f"gt {i}") for i in range(8)]
    with contextlib.redirect_stdout(io.StringIO()):
        reset_launches()
        t0 = time.perf_counter()
        records, res = process(anns, staged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    p_counts, p_tc = launches(), tc_launches()
    tower = tower_launches(clip_cfg, torch.bfloat16)
    mapper = mapper_launches(mcfg, mapper_shape(tcfg), 1)
    k1 = (tower["launches"] + mapper["launches"]["fused_attention_block"],
          tower["tc"] + mapper["tc"]["fused_attention_block"])
    if (p_counts["fused_attention_block"], p_tc["fused_attention_block"]) != k1 or \
            p_counts["vocab_head_logits"] != int(res.lengths.max()) + 1 or len(records) != 8:
        raise AssertionError(f"predict_t5 with the transformer mapper: launches {p_counts}, "
                             f"tensor-core {p_tc}")
    out = {"batch": T5_CAPTION_BATCH, "steps": steps, "losses": losses,
           "median_step_ms": statistics.median(times) * 1e3,
           "launches": {k: v for k, v in counts.items() if v},
           "tc_launches": {k: tc[k] for k in want["tc"]},
           "predict_t5_s": wall, "predict_t5_launches": {k: v for k, v in p_counts.items() if v},
           "captions": [r["caption"][:24] for r in records[:2]]}
    say("t5_mapper", **out)
    return out


# ---- the Faster R-CNN detector and detection serving (phases 39-41) --------------------

DETECTOR_SIZE = 800        # the serving letterbox (apps/serve.py --detector_image_size)
DETECTOR_CLASSES_N = 7     # the reference head (application.py:14)
# fp32 on the card (TF32 off) against the CPU, one 800-px image, detection by
# detection: the same label, each box coordinate within 0.05 px and the score
# within 1e-4 (sums in another order through 53 convolutions and the box head,
# on a well-conditioned net; 1e-4 px between the port and JAX at 128 px on the
# CPU, tests/test_torch_detection.py)
DETECT_BOX_ATOL = 0.05
DETECT_SCORE_ATOL = 1e-4


def detector_state_dict(seed: int, num_classes: int) -> dict:
    """A torchvision fasterrcnn_resnet50_fpn state dict (numpy, the names of
    the reference's model_final.pth) with random weights from a numpy seed:
    convolutions N(0, 0.03), BatchNorm with running statistics near (0, 1),
    linears N(0, 0.01), zero biases (tests/test_detection.py's synthetic
    dict). convert.init_fasterrcnn's tree (He-normal convolutions, identity
    BatchNorm, the JAX package's init) grows the maps to ~1e4 through the 16
    residual blocks; its box head then throws every box out of the image, so
    at 800 px it detects nothing."""
    from construction_clip_tpu_torch.models.resnet import STAGES, WIDTHS

    gen = np.random.default_rng(seed)
    sd = {}

    def normal(shape, std):
        return (gen.standard_normal(shape) * std).astype(np.float32)

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = 1 + normal(c, 0.05)
        sd[f"{prefix}.bias"] = normal(c, 0.05)
        sd[f"{prefix}.running_mean"] = normal(c, 0.05)
        sd[f"{prefix}.running_var"] = (1 + gen.random(c) * 0.1).astype(np.float32)

    def conv(name, o, i, k, bias=False):
        sd[f"{name}.weight"] = normal((o, i, k, k), 0.03)
        if bias:
            sd[f"{name}.bias"] = np.zeros(o, np.float32)

    def lin(name, o, i):
        sd[f"{name}.weight"] = normal((o, i), 0.01)
        sd[f"{name}.bias"] = np.zeros(o, np.float32)

    conv("backbone.body.conv1", 64, 3, 7)
    bn("backbone.body.bn1", 64)
    c_in = 64
    for s, (n, w) in enumerate(zip(STAGES, WIDTHS)):
        for b in range(n):
            pre = f"backbone.body.layer{s + 1}.{b}"
            conv(f"{pre}.conv1", w, c_in, 1)
            bn(f"{pre}.bn1", w)
            conv(f"{pre}.conv2", w, w, 3)
            bn(f"{pre}.bn2", w)
            conv(f"{pre}.conv3", w * 4, w, 1)
            bn(f"{pre}.bn3", w * 4)
            if c_in != w * 4:
                conv(f"{pre}.downsample.0", w * 4, c_in, 1)
                bn(f"{pre}.downsample.1", w * 4)
            c_in = w * 4
    for i, w in enumerate(WIDTHS):
        conv(f"backbone.fpn.inner_blocks.{i}.0", 256, w * 4, 1, bias=True)
        conv(f"backbone.fpn.layer_blocks.{i}.0", 256, 256, 3, bias=True)
    conv("rpn.head.conv.0.0", 256, 256, 3, bias=True)
    conv("rpn.head.cls_logits", 3, 256, 1, bias=True)
    conv("rpn.head.bbox_pred", 12, 256, 1, bias=True)
    lin("roi_heads.box_head.fc6", 1024, 256 * 49)
    lin("roi_heads.box_head.fc7", 1024, 1024)
    lin("roi_heads.box_predictor.cls_score", num_classes, 1024)
    lin("roi_heads.box_predictor.bbox_pred", num_classes * 4, 1024)
    return sd


def detector_tree(seed: int = 39, num_classes: int = DETECTOR_CLASSES_N) -> dict:
    from construction_clip_tpu_torch.models.detection import from_torchvision_state_dict

    return from_torchvision_state_dict(detector_state_dict(seed, num_classes),
                                       num_classes=num_classes)


def _event_ms(fn):
    """(fn(), its CUDA-event time in ms: device timeline from before the call's
    first launch to after its last, gaps for the host included)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _detections(det, row: int = 0):
    return tuple(t[row].float().cpu().numpy() for t in (det.boxes, det.labels, det.scores))


def _matched(want, got, *, box_atol=None, score_atol=None, iou=None) -> int:
    """How many of `want`'s live detections a distinct live detection of `got`
    matches: the same label and either every coordinate within box_atol and
    the score within score_atol, or IoU >= iou."""
    from construction_clip_tpu_torch.models.detection import box_iou

    (wb, wl, ws), (gb, gl, gs) = want, got
    used, hits = set(), 0
    for b, l, s in zip(wb, wl, ws):
        if s <= 0:
            continue
        cand = [j for j in range(len(gs)) if gs[j] > 0 and gl[j] == l and j not in used]
        if iou is None:
            cand = [j for j in cand if abs(gs[j] - s) <= score_atol
                    and np.abs(gb[j] - b).max() <= box_atol]
            pick = cand[0] if cand else None
        else:
            ious = box_iou(torch.from_numpy(b[None]), torch.from_numpy(gb[cand]))[0] \
                if cand else torch.zeros(0)
            pick = cand[int(ious.argmax())] if cand and float(ious.max()) >= iou else None
        if pick is not None:
            used.add(pick)
            hits += 1
    return hits


def _stage_ms(params, images, cd) -> dict:
    """Device time of the detector's stages at one batch, each alone by CUDA
    events (so each pays its own launch latency): backbone + FPN, the RPN
    (head convs, top-k, decode, its NMS), the ROI heads (ROIAlign, box head,
    class NMS, top-k) and ROIAlign within them, and the whole call."""
    from construction_clip_tpu_torch.models import detection as det

    p = det.cast_params(params, cd)
    x = ((images.to(cd) - torch.tensor(det.IMAGE_MEAN, dtype=cd, device=images.device))
         / torch.tensor(det.IMAGE_STD, dtype=cd, device=images.device)).permute(0, 3, 1, 2)
    nms_ms, nms_mask = [], det.nms_mask

    def timed_nms(*args, **kwargs):
        out, ms = _event_ms(lambda: nms_mask(*args, **kwargs))
        nms_ms.append(ms)
        return out

    det.nms_mask = timed_nms   # the RPN's NMS, then the class NMS, each timed alone
    try:
        with torch.inference_mode():
            (props, keep), _ = _event_ms(lambda: det.rpn_propose(
                p, det.fpn_forward(p["fpn"], det.resnet_pyramid(p["backbone"], x)),
                image_size=DETECTOR_SIZE, pre_nms_topk=1000, post_nms_topk=300))
            feats = det.fpn_forward(p["fpn"], det.resnet_pyramid(p["backbone"], x))
            det.roi_heads(p, feats, props, keep, image_size=DETECTOR_SIZE,
                          detections_per_img=100, num_classes=DETECTOR_CLASSES_N,
                          box_nms_thresh=0.5, score_thresh=0.05, compute_dtype=cd)
            torch.cuda.synchronize()
    finally:
        det.nms_mask = nms_mask
    with torch.inference_mode():
        feats, t_backbone = _event_ms(
            lambda: det.fpn_forward(p["fpn"], det.resnet_pyramid(p["backbone"], x)))
        (props, keep), t_rpn = _event_ms(lambda: det.rpn_propose(
            p, feats, image_size=DETECTOR_SIZE, pre_nms_topk=1000, post_nms_topk=300))
        _, t_heads = _event_ms(lambda: det.roi_heads(
            p, feats, props, keep, image_size=DETECTOR_SIZE, detections_per_img=100,
            num_classes=DETECTOR_CLASSES_N, box_nms_thresh=0.5, score_thresh=0.05,
            compute_dtype=cd))
        pw = (props[..., 2] - props[..., 0]).clamp(min=1e-6)
        ph = (props[..., 3] - props[..., 1]).clamp(min=1e-6)
        lvl = torch.floor(4 + torch.log2(torch.sqrt(pw * ph) / 224 + 1e-6)).clamp(2, 5).long() - 2
        _, t_roi = _event_ms(lambda: det.roi_align_multilevel(feats[:4], props, lvl,
                                                              strides=(4, 8, 16, 32)))
        _, t_all = _event_ms(lambda: det.fasterrcnn_infer(
            params, images, image_size=DETECTOR_SIZE, num_classes=DETECTOR_CLASSES_N,
            compute_dtype=cd))
    return {"backbone_fpn_ms": t_backbone, "rpn_ms": t_rpn, "rpn_nms_ms": nms_ms[0],
            "roi_heads_ms": t_heads, "roi_align_ms": t_roi, "class_nms_ms": nms_ms[1],
            "whole_ms": t_all}


def phase_detector(device="cuda") -> dict:
    """Phase 39: the detector alone at serving width (ResNet-50-FPN, 800 px,
    7 classes) through models/detection.fasterrcnn_infer: bf16 at B=1 and
    B=8 (median of 7 calls, CUDA-event and host times, peak memory, the NMS
    iteration counts, the stages' device times and the largest kernels under
    torch.profiler); fp32 with TF32 off against the port on the CPU for one
    image; bf16 against fp32; TorchDetector's mapped-back boxes inside their
    images. The tree comes from a numpy seed through the torchvision
    converter (detector_state_dict)."""
    from construction_clip_tpu_torch.models import detection as det
    from construction_clip_tpu_torch.serve.detector import TorchDetector

    tree = detector_tree()
    params = {cd: convert.to_detector_params(tree, dtype=cd, device=device)
              for cd in (torch.bfloat16, torch.float32)}
    gen = np.random.default_rng(39)
    images = torch.from_numpy(gen.random((8, DETECTOR_SIZE, DETECTOR_SIZE, 3))
                              .astype(np.float32)).to(device)
    kw = dict(image_size=DETECTOR_SIZE, num_classes=DETECTOR_CLASSES_N)
    timings = {}
    for bsz in (1, 8):
        x = images[:bsz]
        with torch.inference_mode():
            for _ in range(2):
                det.fasterrcnn_infer(params[torch.bfloat16], x, compute_dtype=torch.bfloat16, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            events, host, stats = [], [], {}
            for _ in range(7):
                t0 = time.perf_counter()
                out, ms = _event_ms(lambda: det.fasterrcnn_infer(
                    params[torch.bfloat16], x, compute_dtype=torch.bfloat16,
                    stats=stats, **kw))
                host.append((time.perf_counter() - t0) * 1e3)
                events.append(ms)
        live = int((out.scores > 0).sum())
        if live == 0:
            raise AssertionError(f"B={bsz}: no live detection")
        its = stats["nms_iterations"]
        timings[bsz] = {"event_ms": statistics.median(events), "host_ms": statistics.median(host),
                        "images_per_s": bsz * 1e3 / statistics.median(host),
                        "peak_mib_above_start": (torch.cuda.max_memory_allocated() - base) / 2**20,
                        "rpn_nms_iterations": sorted(set(its[0::2])),
                        "box_nms_iterations": sorted(set(its[1::2])), "live": live}
    timings["stages_b8"] = _stage_ms(params[torch.bfloat16], images, torch.bfloat16)
    timings["stages_b1"] = _stage_ms(params[torch.bfloat16], images[:1], torch.bfloat16)
    with torch.inference_mode():
        timings["kernel_ms_b1"] = sum(kernel_device_ms(lambda: det.fasterrcnn_infer(
            params[torch.bfloat16], images[:1], compute_dtype=torch.bfloat16, **kw),
            reps=3).values())
        per = kernel_device_ms(lambda: det.fasterrcnn_infer(
            params[torch.bfloat16], images, compute_dtype=torch.bfloat16, **kw), reps=3)
    timings["kernel_ms_b8"] = sum(per.values())
    timings["top_kernels_b8"] = dict(sorted(per.items(), key=lambda kv: -kv[1])[:12])

    # fp32 on the card, TF32 off, against the CPU on the same image
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            card = _detections(det.fasterrcnn_infer(params[torch.float32], images[:1], **kw))
            bf16 = _detections(det.fasterrcnn_infer(params[torch.bfloat16], images[:1],
                                                    compute_dtype=torch.bfloat16, **kw))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    with torch.inference_mode():
        cpu = _detections(det.fasterrcnn_infer(convert.to_detector_params(tree),
                                               images[:1].cpu(), **kw))
    # detections within the score tolerance of the last slot's may sit on
    # either side of the top-100 cut
    sure = cpu[2] > cpu[2][cpu[2] > 0].min() + DETECT_SCORE_ATOL
    need = tuple(a[sure] for a in cpu)
    hits = _matched(need, card, box_atol=DETECT_BOX_ATOL, score_atol=DETECT_SCORE_ATOL)
    both = (cpu[2] > 0) & (card[2] > 0)
    parity = {"cpu_live": int((cpu[2] > 0).sum()), "card_live": int((card[2] > 0).sum()),
              "compared": int(sure.sum()), "matched": hits,
              "slotwise_labels_equal": float((cpu[1][both] == card[1][both]).mean()),
              "slotwise_max_box_diff_px": float(np.abs(cpu[0][both] - card[0][both]).max()),
              "slotwise_max_score_diff": float(np.abs(cpu[2] - card[2]).max()),
              "box_atol_px": DETECT_BOX_ATOL, "score_atol": DETECT_SCORE_ATOL}
    if hits != int(sure.sum()) or parity["cpu_live"] == 0:
        raise AssertionError(f"fp32 card against CPU: {parity}")
    top20 = tuple(a[:20] for a in card)   # scores descend
    share = _matched(top20, bf16, iou=0.5) / int((top20[2] > 0).sum())

    # TorchDetector: letterbox staging, one batch, boxes mapped back to each image
    td = TorchDetector(tree, num_classes=DETECTOR_CLASSES_N, image_size=DETECTOR_SIZE,
                       device=device)
    shapes = [(480, 640), (768, 1024), (256, 256), (600, 400), (1080, 1920)]
    originals = synthetic_images(np.random.default_rng(40), shapes)
    mapped = td.detect_batch(np.stack([td.stage(im) for im in originals]), shapes)
    for (h, w), d in zip(shapes, mapped):
        b = np.asarray(d["boxes"]).reshape(-1, 4)
        if not len(b) or (b < 0).any() or (b[:, [0, 2]] > w).any() or (b[:, [1, 3]] > h).any():
            raise AssertionError(f"mapped-back boxes of a {h}x{w} image: {b[:4]}")
    say("detector", batch_1=timings[1], batch_8=timings[8], stages_b8=timings["stages_b8"],
        stages_b1=timings["stages_b1"], kernel_ms_b1=timings["kernel_ms_b1"],
        kernel_ms_b8=timings["kernel_ms_b8"],
        top_kernels_b8=timings["top_kernels_b8"], fp32_card_vs_cpu=parity,
        bf16_top20_matched_share=share, compute_dtype=str(td.compute_dtype),
        mapped_back_detections=[len(d["boxes"]) for d in mapped])
    return {"tree": tree, "timings": timings}


def phase_detector_serve(clip_np, cap_np, cfgs, clip_tok, lm_tok, tree, serve5: dict) -> None:
    """Phase 40: phase 5's requests through TorchPredictService with
    ThresholdWrapper(TorchDetector(...)) (800-px letterbox, 7 classes, bf16),
    a 20 ms window and max_batch 8: the detector's batch coalesces, K1 (tensor
    cores) and K2 launch in the run, every response has the six keys. The
    same service without the detector runs as the control in turns (control,
    detector, detector, control), since the host-bound caption half's speed
    drifts over a long process; req/s and the warm single request beside
    the control's and phase 5's. Then a few requests at threshold 0: names
    of DETECTOR_CLASSES, boxes inside each image."""
    from construction_clip_tpu_torch.data.labels import DETECTOR_CLASSES
    from construction_clip_tpu_torch.serve.detector import ThresholdWrapper, TorchDetector

    wrapper = ThresholdWrapper(TorchDetector(tree, num_classes=DETECTOR_CLASSES_N,
                                             image_size=DETECTOR_SIZE, device="cuda"))
    runs = {"detector": [], "control": []}
    for arm in ("control", "detector", "detector", "control"):
        runs[arm].append(phase_serve(clip_np, cap_np, cfgs, clip_tok, lm_tok, "cuda",
                                     detector=wrapper if arm == "detector" else None,
                                     name=f"serve_{arm}"))
    out = runs["detector"][0]
    svc = out["service"]
    wrapper.threshold = 0.0
    names = set()
    for im in out["images"][:5]:
        r = svc.predict(im)
        h, w = im.shape[:2]
        b = np.asarray(r["boxes"]).reshape(-1, 4)
        if not len(b) or (b < 0).any() or (b[:, [0, 2]] > w).any() or (b[:, [1, 3]] > h).any():
            raise AssertionError(f"threshold 0: boxes of a {h}x{w} image: {b[:4]}")
        names |= set(r["labels"])
    if not names or not names <= set(DETECTOR_CLASSES[1:DETECTOR_CLASSES_N]):
        raise AssertionError(f"threshold 0: labels {names}")
    say("serve_detector_vs_serve",
        req_per_s=[r["req_per_s"] for r in runs["detector"]],
        warm_single_request_s=[r["warm_single_request_s"] for r in runs["detector"]],
        control_req_per_s=[r["req_per_s"] for r in runs["control"]],
        control_warm_single_request_s=[r["warm_single_request_s"] for r in runs["control"]],
        phase5_req_per_s=serve5["req_per_s"],
        phase5_warm_single_request_s=serve5["warm_single_request_s"],
        launches=[r["launches"] for r in runs["detector"]], threshold_0_labels=sorted(names))


def phase_eval_detection(device="cuda") -> dict:
    """Phase 41: apps/eval_detection.evaluate (its per-image function,
    evaluate_image, on each) over 6 synthetic images read through a
    load_image hook (one file missing), the app's defaults: 8 classes,
    512-px letterbox, fp32. The ground truth holds each image's own top 3
    detections, a box of another class and, on one wide image, an object in
    a long side's band: AP50 above 0, one band object excluded."""
    from construction_clip_tpu_torch.apps import eval_detection
    from construction_clip_tpu_torch.serve.detector import TorchDetector

    td = TorchDetector(detector_tree(41, 8), num_classes=8, image_size=512,
                       compute_dtype=torch.float32, device=device)
    shapes = [(480, 640), (768, 1024), (256, 256), (600, 400), (1080, 1920), (300, 500)]
    images = {f"{i}.jpg": im for i, im in
              enumerate(synthetic_images(np.random.default_rng(41), shapes))}
    anns = []
    for name, im in images.items():
        raw = td.detect(im)
        anns.append({"file_name": name,
                     "boxes": [list(map(float, b)) for b in raw["boxes"][:3]] + [[5, 5, 60, 60]],
                     "labels": [int(v) for v in raw["labels"][:3]] + [3]})
    anns[0]["boxes"].append([2.0, 20.0, 60.0, 400.0])   # left band of the 640-wide image
    anns[0]["labels"].append(2)
    anns.append({"file_name": "missing.jpg", "boxes": [], "labels": []})

    def load_image(path):
        name = os.path.basename(path)
        if name not in images:
            raise FileNotFoundError(path)
        return images[name]

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        metrics = eval_detection.evaluate(td, anns, "site", load_image, num_classes=8)
    seconds = time.perf_counter() - t0
    if metrics["evaluated_images"] != len(images) or metrics["skipped_images"] != 1 or \
            metrics["gt_boxes_outside_crop"] < 1 or not metrics["AP50"] > 0:
        raise AssertionError(f"eval_detection metrics {metrics}")
    print(json.dumps(metrics), flush=True)
    say("eval_detection", seconds=seconds, s_per_image=seconds / len(images), mAP=metrics["mAP"],
        AP50=metrics["AP50"], AP75=metrics["AP75"])
    return metrics


# ---- detection training and the show-attend-tell captioner (phases 42-45) ---------------

DETECT_TRAIN_BATCH = 4
DETECT_TV_BATCH = 2
DETECT_PARITY_SIZE = 256
DETECT_GT_MAX = 5          # ground truth padded to 5 rows, 3-5 live
# phase 43's bound on each gradient leaf, |card - CPU| over the CPU leaf's largest
# element: phase 28's (CAPTION_GRAD_TOL), fp32 with TF32 off
DETECT_GRAD_TOL = CAPTION_GRAD_TOL
LSTM_WIDTHS = dict(embed_size=300, attention_dim=256, decoder_dim=512)   # the JAX app's
LSTM_BATCH, LSTM_MAX_LEN, LSTM_STEPS = 32, 32, 10
LSTM_EVAL_IMAGES, LSTM_EVAL_MAX_LEN = 4, 20
LSTM_ALPHA_TOL = 1e-5


def detection_batch(gen, n: int, size: int):
    """n synthetic images [n, size, size, 3] in [0, 1] with 3-5 ground-truth
    boxes each (sides 6-50% of the image, labels 1..6), padded to
    DETECT_GT_MAX rows of label 0."""
    images = gen.random((n, size, size, 3), dtype=np.float32)
    boxes = np.zeros((n, DETECT_GT_MAX, 4), np.float32)
    labels = np.zeros((n, DETECT_GT_MAX), np.int64)
    for i in range(n):
        for j in range(int(gen.integers(3, DETECT_GT_MAX + 1))):
            w, h = gen.uniform(0.06, 0.5, 2) * size
            x, y = gen.uniform(0, size - w), gen.uniform(0, size - h)
            boxes[i, j] = [x, y, x + w, y + h]
            labels[i, j] = int(gen.integers(1, DETECTOR_CLASSES_N))
    return images, boxes, labels


def _on_device(images, boxes, labels, device):
    from construction_clip_tpu_torch.train.detection import DetectionBatch

    return DetectionBatch(*(torch.from_numpy(a).to(device) for a in (images, boxes, labels)))


def phase_detection_train(device="cuda") -> dict:
    """Phase 42: train/detection.make_detection_train_step at serving width
    (ResNet-50-FPN, 800 px, 7 classes, bf16 compute on the fp32 master tree
    of detector_tree(39) made trainable; AdamW lr 1e-4 with the global-norm
    clip at 1): 10 steps of the default loss at B=4, each step's sample from
    its own seed; the first batch's loss at seed 0 after them must be below
    step 1's. Then 4 tv_faithful steps at B=2, post-NMS 512: finite. The
    median step on the host's clock, a step's device time (its kernels
    under torch.profiler), the peak memory above what was allocated before
    the first step (the params, the moments and earlier phases' tensors lie
    below that line), the launches of K1-K10 (none: the JAX step runs no Pallas kernel) and
    the tv steps' NMS iterations."""
    from construction_clip_tpu_torch.train import detection as dt

    tree = detector_tree()
    gen = np.random.default_rng(42)
    kw = dict(image_size=DETECTOR_SIZE, num_classes=DETECTOR_CLASSES_N,
              compute_dtype=torch.bfloat16)
    out = {}
    for name, bsz, steps in (("default", DETECT_TRAIN_BATCH, 10),
                             ("tv_faithful", DETECT_TV_BATCH, 4)):
        params = convert.to_detector_params(tree, device=device, trainable=True)
        tx = make_adamw(1e-4, warmup_steps=0, total_steps=1000, grad_clip=1.0)
        state = TrainState.create(params, tx)
        stats: dict = {}
        step = dt.make_detection_train_step(tx, tv_faithful=name == "tv_faithful",
                                            stats=stats, **kw)
        batch = _on_device(*detection_batch(gen, bsz, DETECTOR_SIZE), device)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        reset_launches()
        for i in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch, i)
            losses.append(float(m["loss"]))   # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
        counts = launches()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        if not np.isfinite(losses).all():
            raise AssertionError(f"detection {name}: loss not finite: {losses}")
        if any(counts.values()):
            raise AssertionError(f"detection {name}: a hand kernel launched: {counts}")
        res = {"batch": bsz, "image_size": DETECTOR_SIZE, "losses": losses,
               "median_step_ms": statistics.median(times[1:]), "first_step_ms": times[0],
               "peak_gib_above_start": peak, "allocated_at_start_gib": base / 2 ** 30,
               "launches": counts}
        if name == "default":
            with torch.no_grad():
                after = float(dt.detection_loss(state.params, batch, 0, **kw))
            res["step1_batch_loss_after"] = after
            if not after < losses[0]:
                raise AssertionError(f"detection loss did not fall: {losses[0]} -> {after}")
            res["anchors_per_image"] = sum(3 * (-(-DETECTOR_SIZE // s)) ** 2
                                           for s in (4, 8, 16, 32, 64))
        else:
            its = stats["nms_iterations"]
            res["nms_iterations"] = {"min": min(its), "max": max(its),
                                     "median": statistics.median(its), "calls": len(its)}
        res["step_device_ms"] = sum(kernel_device_ms(
            lambda: step(state, batch, 0), reps=2).values())
        say(f"detection_train_{name}", **res)
        out[name] = res
        del params, state, step, batch
        torch.cuda.empty_cache()
    return out


def phase_detection_train_parity(device="cuda") -> dict:
    """Phase 43: one train step's fp32 loss and gradients at 256 px, B=2, on
    the card (TF32 off in cuBLAS and cuDNN) against the port on the CPU, from
    the same tree, for the default loss (its RPN samples drawn on the CPU
    and passed to both) and for tv_faithful. ReLU's derivative steps at 0:
    the CPU run takes the card run's ReLU masks (relu_masks), the signs its
    own forward gives otherwise counted. Each leaf's largest difference over
    the CPU leaf's largest element must be within DETECT_GRAD_TOL; the same
    steps with TF32 on, beside them, are the control."""
    from construction_clip_tpu_torch.train import detection as dt

    tree = detector_tree()
    gen = np.random.default_rng(43)
    arrays = detection_batch(gen, 2, DETECT_PARITY_SIZE)
    kw = dict(image_size=DETECT_PARITY_SIZE, num_classes=DETECTOR_CLASSES_N)
    names = list(_paths(tree))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    def cpu_sampler(labels, seed, image):
        return tuple(t.to(labels.device) for t in dt.rpn_sampler(labels.cpu(), seed, image))

    def run(dev, loss_name, record, replay=None, tf32=False):
        params = convert.to_detector_params(tree, device=dev, trainable=True)
        batch = _on_device(*arrays, dev)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            t0 = time.perf_counter()
            with relu_masks(record, replay):
                if loss_name == "default":
                    loss = dt.detection_loss(params, batch, 0, sampler=cpu_sampler, **kw)
                else:
                    loss = sum(dt.tv_detection_losses(
                        params, batch.images, batch.gt_boxes, batch.gt_labels,
                        pre_nms_topk=1024, post_nms_topk=512, **kw).values()).mean()
                grads = torch.autograd.grad(loss, tree_leaves(params))
            return float(loss.detach()), [g.cpu() for g in grads], time.perf_counter() - t0
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def errors(a, b):
        return {n: float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                for n, x, y in zip(names, a[1], b[1])}

    report = {}
    for loss_name in ("default", "tv_faithful"):
        card_masks, cpu_masks = [], []
        card = run(device, loss_name, card_masks)
        cpu = run("cpu", loss_name, cpu_masks, replay=card_masks)
        tf32 = run(device, loss_name, [], tf32=True)
        errs, control = errors(card, cpu), errors(tf32, cpu)
        worst, control_worst = max(errs, key=errs.get), max(control, key=control.get)
        res = {"loss_card": card[0], "loss_cpu": cpu[0],
               "loss_rel_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
               "worst_leaf": worst, "worst_leaf_err": errs[worst], "tol": DETECT_GRAD_TOL,
               "errors_by_leaf": {n: errs[n] for n in sorted(errs, key=errs.get)[-4:]},
               "relu_elements": sum(m.numel() for m in card_masks),
               "relu_signs_the_cpu_gives_otherwise": sum(
                   int((a != b).sum()) for a, b in zip(card_masks, cpu_masks)),
               "tf32_worst_leaf": control_worst, "tf32_worst_leaf_err": control[control_worst],
               "tf32_loss_rel_err": abs(tf32[0] - cpu[0]) / abs(cpu[0]),
               "card_s": card[2], "cpu_s": cpu[2]}
        say(f"detection_train_parity_{loss_name}", batch=2, image_size=DETECT_PARITY_SIZE,
            leaves=len(names), **res)
        if res["loss_rel_err"] > 1e-5 or res["worst_leaf_err"] > DETECT_GRAD_TOL:
            raise AssertionError(f"detection step {loss_name}, card against CPU: {res}")
        report[loss_name] = res
    return report


def lstm_corpus(gen, n: int, *, chars: int = 3000, lo: int = 8, hi: int = 30):
    """n synthetic Chinese captions: lengths lo..hi characters drawn
    Zipf-like (weight 1/rank) from `chars` CJK characters, spaces between
    words of 2-4 characters."""
    pool = [chr(0x4E00 + i) for i in gen.permutation(20000)[:chars]]
    p = 1.0 / np.arange(1, chars + 1)
    p /= p.sum()
    caps = []
    for _ in range(n):
        text = "".join(pool[i] for i in gen.choice(chars, size=int(gen.integers(lo, hi + 1)),
                                                   p=p))
        cuts = np.cumsum(gen.integers(2, 5, size=len(text)))
        caps.append(" ".join(text[a:b] for a, b in zip(np.r_[0, cuts], cuts) if a < len(text)))
    return caps


def phase_lstm_train(device="cuda") -> dict:
    """Phase 44: train_attention's step at the reference widths (embed 300,
    attention 256, decoder 512, encoder 2048), B=32, captions cut to 32 ids,
    dropout 0.3, Adam lr 3e-4: the app's building blocks (its vocabulary,
    TorchImageTextLoader with a load_image hook over 320 synthetic images,
    the fp32 ResNet-50 encode at 224, make_lstm_train_step) for one epoch of
    10 steps; the first batch's loss (dropout off) after them must be below
    its loss before. The median step and its device time (encode and step,
    their kernels under torch.profiler), peak memory; no hand kernel
    launches. Returns what phase 45 reads."""
    import types

    from construction_clip_tpu_torch.apps import train_attention as app
    from construction_clip_tpu_torch.data.loader import TorchImageTextLoader
    from construction_clip_tpu_torch.data.vocabulary import Vocabulary
    from construction_clip_tpu_torch.models.lstm_captioner import (caption_lm_loss,
                                                                   captioner_forward)
    from construction_clip_tpu_torch.train.lstm import make_lstm_train_step
    from construction_clip_tpu_torch.train.state import adam

    gen = np.random.default_rng(44)
    n = LSTM_BATCH * LSTM_STEPS
    texts = lstm_corpus(gen, n)
    vocab = Vocabulary(5)
    vocab.build_vocabulary(texts)
    # a colour tint each, so that the images differ beyond their noise and the
    # captioner's greedy captions differ from image to image (phase 45)
    images = {f"{i}.jpg": (im * (0.25 + 0.75 * gen.random(3))).astype(np.uint8)
              for i, im in enumerate(synthetic_images(
                  gen, [(256, 256)] * (n // 4) + [(300, 400)] * (n - n // 4)))}
    files = sorted(images, key=lambda f: int(f.split(".")[0]))

    class Dataset:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return files[i], texts[i]

    def tokenize(batch_texts):
        return np.asarray([vocab.encode_caption(t, LSTM_MAX_LEN) for t in batch_texts],
                          dtype=np.int32)

    loader = TorchImageTextLoader(Dataset(), tokenize, batch_size=LSTM_BATCH, device=device,
                                  load_image=lambda path: images[os.path.basename(path)])
    args = types.SimpleNamespace(**LSTM_WIDTHS)
    enc_params = app.load_encoder(None, device)
    encode = app.make_encoder(enc_params)
    tx = adam(3e-4)
    state = TrainState.create(app.init_captioner(args, len(vocab), device), tx)
    step = make_lstm_train_step(tx, dropout_rate=app.DROPOUT)
    first = None

    def first_loss():
        with torch.no_grad():
            logits, _ = captioner_forward(state.params.tree(), first["features"],
                                          first["tokens"].long())
            return float(caption_lm_loss(logits, first["tokens"]))

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times, encode_ms = [], [], []
    for batch in loader:
        t0 = time.perf_counter()
        feats = encode(batch["images"])
        torch.cuda.synchronize()
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:   # its step's time, which includes this, is left out below
            first = {"features": feats, "tokens": batch["tokens"]}
            before = first_loss()
        state, m = step(state, {"features": feats, "tokens": batch["tokens"]}, state.step)
        losses.append(float(m["loss"]))   # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    after = first_loss()
    if len(losses) != LSTM_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"lstm: {len(losses)} steps, losses {losses}")
    if any(counts.values()):
        raise AssertionError(f"lstm: a hand kernel launched: {counts}")
    if not after < before:
        raise AssertionError(f"lstm: the first batch's loss did not fall: {before} -> {after}")
    feats, toks = first["features"], first["tokens"]
    device_ms = sum(kernel_device_ms(lambda: step(state, {"features": encode(batch["images"]),
                                                          "tokens": toks}, 0),
                                     reps=2).values())
    encode_device_ms = sum(kernel_device_ms(lambda: encode(batch["images"]), reps=2).values())
    res = {"vocab": len(vocab), "captions": n, "batch": LSTM_BATCH, "max_len": LSTM_MAX_LEN,
           **LSTM_WIDTHS, "encoder_dim": int(feats.shape[-1]), "grid": int(feats.shape[1]),
           "losses": losses, "first_batch_loss_before": before, "first_batch_loss_after": after,
           "median_step_ms": statistics.median(times[1:]),
           "median_encode_ms": statistics.median(encode_ms[1:]),
           "step_device_ms": device_ms, "encode_device_ms": encode_device_ms,
           "peak_gib_above_start": peak, "launches": counts}
    say("lstm_train", **res)
    return {"params": state.params, "enc_params": enc_params, "vocab": vocab,
            "images": [images[f] for f in files[:LSTM_EVAL_IMAGES]]}


def stop_token(toks) -> tuple:
    """toks [B, max_len], a greedy decode that never stopped -> (token,
    row, step): a token that `row` first emits at `step` and some other row
    never emits, at step 1 or later where there is one, else at step 0. As
    eos it stops that row while another runs to max_len, so the decode's
    per-row stop (tokens 0 after it, the lengths, the loop's end) does real
    work. Raises where no token does that, as where every row repeats one
    caption."""
    toks = np.asarray(toks)
    for step in [*range(1, toks.shape[1]), 0]:
        for row in range(toks.shape[0]):
            t = int(toks[row, step])
            if t not in toks[row, :step] and any(t not in other for other in toks):
                return t, row, step
    raise AssertionError(f"lstm eval: no token stops one caption while another runs on: "
                         f"{toks.tolist()}")


def phase_lstm_eval(trained: dict, device="cuda") -> dict:
    """Phase 45: eval_attention's per-image function (make_captioner: the
    fp32 ResNet-50 grid, generate_caption at max_len 20) on phase 44's
    params for 4 staged images, and generate_caption on the 4 grids at once,
    on the card and on the CPU from the same params, TF32 off. The 4
    captions must not all be equal, and eos is a token that one of them
    emits (at step 2 or later where one does) while another never does
    (stop_token): each
    call's words, tokens and lengths equal, the alphas within
    LSTM_ALPHA_TOL. Seconds an image on the card."""
    import types

    from construction_clip_tpu_torch.apps import eval_attention
    from construction_clip_tpu_torch.apps.train_attention import make_encoder
    from construction_clip_tpu_torch.data.pipeline import host_shape_unify
    from construction_clip_tpu_torch.models.lstm_captioner import generate_caption

    vocab, params = trained["vocab"], as_tree(trained["params"])
    cpu_params = tree_map(lambda t: t.detach().cpu(), params)
    cpu_enc = tree_map(lambda t: t.cpu(), trained["enc_params"])
    staged = [host_shape_unify(im, eval_attention.STAGE_SIZE) for im in trained["images"]]
    batch = torch.from_numpy(np.stack(staged))
    sos = vocab.stoi["<SOS>"]
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        feats = make_encoder(trained["enc_params"])(batch.to(device))
        raw, _, _ = generate_caption(params, feats, sos_id=sos, eos_id=-1,
                                     max_len=LSTM_EVAL_MAX_LEN)
        raw = raw.cpu().numpy()
        if len({tuple(r) for r in raw}) < 2:
            raise AssertionError(f"lstm eval: every image gives one caption: {raw.tolist()}")
        eos, row, step = stop_token(raw)
        view = types.SimpleNamespace(stoi={**vocab.stoi, "<EOS>": eos}, itos=vocab.itos)
        card_out = generate_caption(params, feats, sos_id=sos, eos_id=eos,
                                    max_len=LSTM_EVAL_MAX_LEN)
        card = eval_attention.make_captioner(trained["enc_params"], params, view,
                                             max_len=LSTM_EVAL_MAX_LEN)
        card(staged[0])   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [card(u8) for u8 in staged]
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    cpu = eval_attention.make_captioner(cpu_enc, cpu_params, view, max_len=LSTM_EVAL_MAX_LEN)
    want = [cpu(u8) for u8 in staged]
    cpu_out = generate_caption(cpu_params, make_encoder(cpu_enc)(batch), sos_id=sos,
                               eos_id=eos, max_len=LSTM_EVAL_MAX_LEN)
    (g_tok, g_len, g_alpha), (w_tok, w_len, w_alpha) = (
        [t.cpu().numpy() for t in out] for out in (card_out, cpu_out))
    alpha_err = max([float(np.abs(g[1] - w[1]).max()) for g, w in zip(got, want)]
                    + [float(np.abs(g_alpha - w_alpha).max())])
    res = {"images": len(staged), "max_len": LSTM_EVAL_MAX_LEN, "eos": eos,
           "eos_row": row, "eos_step": step, "lengths": g_len.tolist(),
           "distinct_captions": len({tuple(r) for r in raw}),
           "words": [len(g[0]) for g in got], "captions": [" ".join(g[0]) for g in got],
           "tokens_equal": (all(g[0] == w[0] for g, w in zip(got, want))
                            and np.array_equal(g_tok, w_tok) and np.array_equal(g_len, w_len)),
           "max_alpha_err": alpha_err, "alpha_tol": LSTM_ALPHA_TOL,
           "s_per_image": seconds / len(staged)}
    say("lstm_eval", **res)
    if not res["tokens_equal"] or alpha_err > LSTM_ALPHA_TOL:
        raise AssertionError(f"lstm eval, card against CPU: {res}")
    if not (g_len.min() <= step + 1 and g_len.max() == LSTM_EVAL_MAX_LEN):
        raise AssertionError(f"lstm eval: eos {eos} did not stop row {row} at step {step} "
                             f"while another ran on: lengths {g_len.tolist()}")
    return res


# phase 47: rematerialisation at ViT-L/14, bf16, B=36 (4 groups of 9)
REMAT_POLICIES = (False, True, "dots", "save_qkv", "save_mlp_hidden", "save_qkv_attn_out",
                  "save_qkv_mlp", "save_attn_preact", "save_preact", "save_big")
REMAT_STEPS = 3
REMAT_LR = 1e-4
REMAT_PROFILED = (False, True, "save_preact")   # a step's device time under the profiler
REMAT_KERNELS = ("fused_attention_block", "fused_attention_block_bwd", "flash_attention_fwd",
                 "flash_attention_bwd")
# a small CLIP for the fp32 card-against-CPU step: the image tower's T = 17^2 + 1 = 290
# takes the flash route (K4/K5), the text tower's T = 16 K1's (K1/K3)
REMAT_PARITY_CFG = CLIPConfig(
    vision=VisionConfig(image_size=34, patch_size=2, width=128, layers=2, heads=2,
                        embed_dim=64),
    text=TextConfig(vocab_size=512, context_length=16, width=128, layers=2, heads=2,
                    embed_dim=64))


def _remat_run(cfg, params_np, batch, remat, steps, device, first_grads=None) -> dict:
    """One loss_and_grads, then `steps` bf16 make_train_step(remat=...) steps
    on one batch: losses, step times, launches of the steps, and the peak
    memory of the steps after the first (the first step also allocates
    AdamW's moments, which would hide the activations), with the memory held
    before them (params, moments, and no remat's gradients, which every run
    holds then), and the largest difference of a gradient leaf from
    `first_grads` (no remat's) or, without them, from a second call's.
    Returns (that, the gradients' leaves, or None with `first_grads`)."""
    params = convert.to_params(params_np, device=device, trainable=True)

    def grads():
        out = contrastive.loss_and_grads(params, cfg, batch["images"], batch["tokens"],
                                         policy=BF16_POLICY, remat=remat)[2]
        return [g.detach() for g in tree_leaves(out)]

    got = grads()
    against = grads() if first_grads is None else first_grads
    grad_diff = max(float((g - h).abs().max()) for g, h in zip(got, against))
    del against
    if first_grads is not None:
        got = None
    tx = make_adamw(REMAT_LR, warmup_steps=0, total_steps=1000)
    state = TrainState.create(params, tx)
    step = contrastive.make_train_step(cfg, tx, policy=BF16_POLICY, device=device, remat=remat)
    reset_launches()
    losses, times, base = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))   # waits for the step
        times.append(time.perf_counter() - t0)
        if i == 0:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
    counts = launches()
    out = {"remat": remat, "losses": losses, "median_step_ms": statistics.median(times) * 1e3,
           "launches": {n: counts[n] for n in REMAT_KERNELS},
           ("grad_max_diff" if first_grads is not None else "grad_repeat_max_diff"): grad_diff}
    if steps > 1:
        out.update(held_gib=base / 2 ** 30, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   peak_above_held_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                   **_remat_memory(state.params, cfg, batch, remat))
    if remat in REMAT_PROFILED:
        out["step_device_ms"] = sum(kernel_device_ms(lambda: step(state, batch),
                                                     reps=2).values())
    del state, step, params
    torch.cuda.empty_cache()
    return out, got


def _remat_memory(params, cfg, batch, remat) -> dict:
    """The memory the loss's graph keeps for the backward (allocated after
    the forward, above before it: the saved activations and the bf16 casts
    of the params) and the peak of the forward and backward above the same
    point, without the optimizer step, whose temporaries set a step's peak
    once remat has cut the activations."""
    params = as_tree(params)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    img = encode_image(params, cfg, batch["images"], policy=BF16_POLICY, normalize=True,
                       remat=remat)
    txt = encode_text(params, cfg, batch["tokens"], policy=BF16_POLICY, normalize=True)
    loss, _ = local_infonce(img, txt, params["logit_scale"])
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    grads = torch.autograd.grad(loss, tree_leaves(params))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del grads, loss, img, txt
    return {"kept_for_backward_gib": kept / 2 ** 30, "fwd_bwd_peak_gib": peak / 2 ** 30}


def phase_remat(device="cuda") -> dict:
    """Phase 47 (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        clip_tok, _ = tokenizers(tmp)
    cfg = CLIPConfig.vit_l_14()
    params_np = convert.init_clip(2, cfg)
    batch = class_balanced_batch(cfg, clip_tok, 4, 10, device)
    runs, first_grads = {}, None
    for remat in REMAT_POLICIES:
        out, got = _remat_run(cfg, params_np, batch, remat, REMAT_STEPS, device, first_grads)
        first_grads = first_grads if got is None else got
        runs[str(remat)] = out
        say("remat_vit_l_14", batch=int(batch["tokens"].shape[0]), **out)
    del first_grads, got, params_np
    torch.cuda.empty_cache()
    none, full = runs["False"], runs["True"]
    for key, out in runs.items():
        if not all(np.isfinite(out["losses"])):
            raise AssertionError(f"remat {key}: loss not finite: {out['losses']}")
        if out["losses"][0] != none["losses"][0]:
            raise AssertionError(f"remat {key}: first loss {out['losses'][0]} is not no "
                                 f"remat's {none['losses'][0]}")
        diff = out["grad_repeat_max_diff" if key == "False" else "grad_max_diff"]
        if diff != 0:
            raise AssertionError(f"remat {key}: gradients differ from no remat's first "
                                 f"call's by up to {diff}")
        if key not in ("False", "True") and not (
                full["kept_for_backward_gib"] < out["kept_for_backward_gib"]
                < none["kept_for_backward_gib"]
                and full["fwd_bwd_peak_gib"] <= out["fwd_bwd_peak_gib"]
                <= none["fwd_bwd_peak_gib"]
                and out["peak_gib"] <= none["peak_gib"]):
            raise AssertionError(f"remat {key}: memory not between full remat's and no "
                                 f"remat's: {out}, {full}, {none}")
    for what in ("peak_gib", "fwd_bwd_peak_gib", "kept_for_backward_gib"):
        if not full[what] < none[what]:
            raise AssertionError(f"full remat's {what} {full[what]} is not below no "
                                 f"remat's {none[what]}")
    k_none, k_full = none["launches"], full["launches"]
    if min(k_none.values()) <= 0 or k_full["flash_attention_fwd"] != 2 * k_none[
            "flash_attention_fwd"] or any(k_full[n] != k_none[n] for n in REMAT_KERNELS
                                          if n != "flash_attention_fwd"):
        raise AssertionError(f"ViT-L/14 launches: no remat {k_none}, full remat {k_full}")

    # ViT-B/32: the image tower's blocks are K1's, so full remat re-runs K1
    cfg_b = CLIPConfig.vit_b_32()
    params_b = convert.init_clip(0, cfg_b)
    batch_b = class_balanced_batch(cfg_b, clip_tok, 4, 9, device)
    k1 = {str(r): _remat_run(cfg_b, params_b, batch_b, r, 1, device)[0]["launches"]
          for r in (False, True)}
    if k1["True"]["fused_attention_block"] != k1["False"]["fused_attention_block"] + \
            cfg_b.vision.layers or k1["True"]["fused_attention_block_bwd"] != \
            k1["False"]["fused_attention_block_bwd"]:
        raise AssertionError(f"ViT-B/32 K1/K3 launches under remat: {k1}")
    del params_b, batch_b

    # the kernels the checkpoint re-runs give their bits again
    rng = np.random.default_rng(47)
    x, ln, attn = _block_inputs(rng, 36, 50, 768, torch.bfloat16, device)
    args = (x, ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"],
            attn["b_out"])
    k1_same = torch.equal(fused_attention_block_fwd(*args, n_heads=12),
                          fused_attention_block_fwd(*args, n_heads=12))
    q, k, v = (torch.from_numpy(rng.standard_normal((36, 16, 257, 64), np.float32)).to(
        device, torch.bfloat16) for _ in range(3))
    k4_same = torch.equal(flash_attention_fwd(q, k, v, is_causal=False, scale=0.125),
                          flash_attention_fwd(q, k, v, is_causal=False, scale=0.125))
    if not (k1_same and k4_same):
        raise AssertionError(f"a second call differs: K1 {k1_same}, K4 {k4_same}")

    parity = remat_parity(device)
    out = {"runs": runs, "vit_b_32_launches": k1, "k1_repeats_bits": k1_same,
           "k4_repeats_bits": k4_same, "parity": parity}
    say("remat", peak_gib={k: out["peak_gib"] for k, out in runs.items()},
        kept_for_backward_gib={k: out["kept_for_backward_gib"] for k, out in runs.items()},
        vit_b_32_launches=k1, k1_repeats_bits=k1_same, k4_repeats_bits=k4_same)
    return out


def remat_parity(device) -> dict:
    """One fp32 step's loss and gradients with remat True and save_preact on
    the card (TF32 off) against the CPU, at REMAT_PARITY_CFG; each leaf's
    error as phase 11 measures it, held to CAPTION_GRAD_TOL."""
    cfg = REMAT_PARITY_CFG
    params_np = convert.init_clip(47, cfg)
    rng = np.random.default_rng(470)
    images = rng.standard_normal((4, 34, 34, 3)).astype(np.float32)
    tokens = rng.integers(1, 511, (4, 16)).astype(np.int32)
    tokens[:, -1] = 511                                   # the EOT, at the argmax
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    try:
        for remat in (True, "save_preact"):
            got = {}
            for dev in (device, "cpu"):
                params = convert.to_params(params_np, device=dev, trainable=True)
                reset_launches()
                loss, _, grads = contrastive.loss_and_grads(
                    params, cfg, torch.from_numpy(images).to(dev),
                    torch.from_numpy(tokens).to(dev), remat=remat)
                got[dev] = (float(loss), [g.detach().cpu() for g in tree_leaves(grads)],
                            launches())
            (lk, gk, ck), (lc, gc, _) = got[device], got["cpu"]
            if min(ck[n] for n in REMAT_KERNELS) <= 0:
                raise AssertionError(f"remat parity {remat}: kernels not all launched: {ck}")
            total = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in gc])))
            worst = max(float(torch.linalg.vector_norm(a - b)
                              / (torch.linalg.vector_norm(b) + 1e-6 * total))
                        for a, b in zip(gk, gc))
            report[str(remat)] = {"loss_card": lk, "loss_cpu": lc,
                                  "loss_rel_err": abs(lk - lc) / abs(lc),
                                  "worst_leaf_err": worst, "tol": CAPTION_GRAD_TOL,
                                  "launches": {n: ck[n] for n in REMAT_KERNELS}}
            if report[str(remat)]["loss_rel_err"] > 1e-5 or worst > CAPTION_GRAD_TOL:
                raise AssertionError(f"remat parity {remat}: {report[str(remat)]}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    say("remat_parity", **report)
    return report


# phases 42-45 and 47 in order, each (its number, a function of the state they share):
# phase 45 reads phase 44's params and trains them itself when it runs without phase 44.
# `python3 chip_smoke.py --only NAME[,NAME]` runs named ones, for a quicker look: the
# device line, then these phases alone, and no verdict; without --only every phase runs
SUBSETS = {"detection_train": ("42", lambda ctx: phase_detection_train()),
           "detection_train_parity": ("43", lambda ctx: phase_detection_train_parity()),
           "lstm_train": ("44", lambda ctx: ctx.update(trained=phase_lstm_train())),
           "lstm_eval": ("45", lambda ctx: phase_lstm_eval(ctx.pop("trained", None)
                                                           or phase_lstm_train())),
           "remat": ("47", lambda ctx: phase_remat())}


def run_phases(names: list) -> None:
    ctx: dict = {}
    for name in names:
        t0 = time.perf_counter()
        SUBSETS[name][1](ctx)
        say(f"{name}_wall", phases=SUBSETS[name][0], seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()


def run_subsets(names: list) -> None:
    unknown = [n for n in names if n not in SUBSETS]
    if unknown:
        raise SystemExit(f"--only: unknown {unknown}; the subsets are {sorted(SUBSETS)}")
    phase_device()
    run_phases(names)
    print(json.dumps({"ok": True, "subsets": names}), flush=True)


def main() -> None:
    if len(sys.argv) > 1:
        if len(sys.argv) != 3 or sys.argv[1] != "--only":
            raise SystemExit("usage: chip_smoke.py [--only NAME[,NAME...]]")
        return run_subsets(sys.argv[2].split(","))
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
    serve5 = phase_serve(clip_np, cap_np, cfgs, clip_tok, lm_tok, "cuda")
    counts = dict(serve5["launches"])
    serve5 = {k: serve5[k] for k in ("req_per_s", "warm_single_request_s")}
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
    del one_process, batch
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        cap_npz = os.path.join(tmp, "clipcap.npz")
        phase_clipcap_train(cfgs, cap_npz)
        phase_clipcap_parity(cfgs)
        phase_predict(convert.init_clip(0, cfgs[0]), cap_npz, cfgs, clip_tok, lm_tok)
        torch.cuda.empty_cache()
        t5_npz = os.path.join(tmp, "t5_prefix.npz")
        tree = convert.init_clipcap_t5(30, t5_cfgs[1], t5_cfgs[2])
        phase_t5_caption_train(t5_cfgs, tree, t5_npz)
        phase_t5_caption_parity(t5_cfgs, tree)
        del tree
        phase_predict_t5(convert.init_clip(0, cfgs[0]), t5_npz, t5_cfgs, clip_tok, lm_tok)
        torch.cuda.empty_cache()

        phase_dh96({})
        mapper_cfgs = (cfgs[0], cfgs[1], MAPPER_CCFG)
        mapper_npz = os.path.join(tmp, "clipcap_transformer.npz")
        phase_clipcap_train(mapper_cfgs, mapper_npz, name="clipcap_transformer_train")
        phase_clipcap_parity(mapper_cfgs, name="clipcap_transformer_parity")
        phase_predict(convert.init_clip(0, cfgs[0]), mapper_npz, mapper_cfgs, clip_tok, lm_tok,
                      name="predict_transformer")
        torch.cuda.empty_cache()
        phase_explain(convert.init_clip(0, cfgs[0]), cap_npz, cfgs, clip_tok, lm_tok)
    torch.cuda.empty_cache()
    phase_clip_caption(cfgs[0], clip_tok)
    torch.cuda.empty_cache()
    phase_t5_mapper(convert.init_clip(0, cfgs[0]), t5_cfgs, clip_tok, lm_tok)
    torch.cuda.empty_cache()

    tree = phase_detector()["tree"]
    phase_detector_serve(convert.init_clip(0, cfgs[0]), convert.init_clipcap(1, cfgs[2], cfgs[1]),
                         cfgs, clip_tok, lm_tok, tree, serve5)
    torch.cuda.empty_cache()
    phase_eval_detection()
    torch.cuda.empty_cache()
    run_phases(list(SUBSETS))
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
