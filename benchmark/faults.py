"""Faults planted in the program under test, for the checks' own tests: each
is a context manager that breaks the timed path underneath the harness, which
runs unchanged above it and has to find its outputs not correct.

- `unchanged_state`: a training step that returns its state unchanged;
- `half_batch`: a training step that leaves out half of the batch, its mean
  taken over the rest;
- `altered_answer`: the zero-shot labels' probabilities moved one label on
  where the batch function produces them.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged_state():
    from construction_clip_tpu_torch.train import contrastive

    return _patched(contrastive, "apply_gradients", lambda original: lambda state, grads, tx: state)


def half_batch():
    from construction_clip_tpu_torch.train import contrastive

    def replace(original):
        def loss_and_grads(params, cfg, images, tokens, **kw):
            half = images.shape[0] // 2
            return original(params, cfg, images[:half], tokens[:half], **kw)
        return loss_and_grads

    return _patched(contrastive, "loss_and_grads", replace)


def altered_answer():
    from construction_clip_tpu_torch.apps import predict_zeroshot

    def replace(original):
        def classify_batch(*args, **kw):
            probs, _ = original(*args, **kw)
            probs = torch.roll(probs, 1, dims=1)
            return probs, probs.argmax(dim=-1)
        return classify_batch

    return _patched(predict_zeroshot, "classify_batch", replace)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
