"""construction_clip_tpu_torch: the PyTorch + CUDA port of construction_clip_tpu,
for NVIDIA Hopper GPUs.

It mirrors the JAX package's layout and names, so each module's counterpart is
easy to find, and its tests hold each module against the JAX package on the
same parameters and inputs:
  core/      precision policy, parameter trees, config dataclasses
  ops/       norms, activations, plain attention, and the hand-written CUDA
             kernels (csrc/) with their build module and plain versions
  data/      image preprocessing, the image-text loader
  models/    CLIP towers, transformer blocks, ClipCap mapper, GPT-2 with KV cache
  infer/     greedy and beam decode, zero-shot classify, caption pipeline
  serve/     the HTTP service on top of the JAX package's serving layer
  parallel/  the contrastive loss (one device)
  train/     train state, AdamW, the contrastive step, checkpoints, resume
  apps/      the training CLI
  convert.py JAX parameter trees -> port parameters, numpy-seeded init
The package never imports jax.
"""
