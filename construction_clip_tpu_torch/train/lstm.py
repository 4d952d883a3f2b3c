"""Show-attend-tell (LSTM captioner) training step, the port of
construction_clip_tpu/train/lstm.py: CE on captions[:, 1:], dropout on the
decoder's hidden state, Adam (the reference trainer, attention_model/train.py).

The loss is the GLOBAL token mean. Data-parallel (`dp`, core/mesh.py, with
more than one rank) each rank's loss is its rows' NLL sum over the
all_reduced count of valid tokens, and the gradients and the loss are
summed over the ranks (train/grads.token_mean_grads), so the update is the
one-process update on the global batch for any padding over the ranks.

Dropout draws from a torch.Generator seeded with the step's seed, and under
DP with (seed, rank), as the JAX step folds the data-axis index into its
key: a valid sampling of the same distribution, not the one process's masks.
With dropout_rate 0 the ranks' step equals the one process's.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.params import as_tree, tree_leaves
from construction_clip_tpu_torch.models.lstm_captioner import (caption_lm_loss_parts,
                                                               captioner_forward)
from construction_clip_tpu_torch.train.grads import token_mean_grads
from construction_clip_tpu_torch.train.state import TrainState, apply_gradients


def dropout_generator(seed: int, rank: int, device) -> torch.Generator:
    """The step's dropout stream on `device`: seeded with (seed, rank)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(rank)) % (1 << 63))
    return gen


def make_lstm_train_step(tx, *, dp=None, dropout_rate: float = 0.3):
    """Returns (state, batch, seed) -> (state, metrics).

    batch: {"features": [B,N,enc] float (the frozen CNN grid), "tokens": [B,T]
    int}, moved to the params' device; with `dp`, this
    rank's rows of the global batch. `seed` (an int) seeds the step's dropout.
    The params and moments are updated in place; the loss metric is a tensor
    on the device."""
    rank = dp.rank if dp is not None else 0

    def step(state: TrainState, batch, seed: int):
        params = as_tree(state.params)
        dev = tree_leaves(params)[0].device
        features = torch.as_tensor(batch["features"]).to(dev, non_blocking=True)
        tokens = torch.as_tensor(batch["tokens"]).to(dev, non_blocking=True).long()
        gen = dropout_generator(seed, rank, dev) if dropout_rate > 0.0 else None
        logits, _ = captioner_forward(params, features, tokens, dropout_rate=dropout_rate,
                                      generator=gen)
        total, count = caption_lm_loss_parts(logits, tokens)
        del logits
        loss, grads = token_mean_grads(total, count, params, dp)
        return apply_gradients(state, grads, tx), {"loss": loss}

    return step
