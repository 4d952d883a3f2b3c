"""Show-attend-tell captioner, the port of
construction_clip_tpu/models/lstm_captioner.py: Bahdanau attention + LSTM
decoder over a frozen CNN feature grid (reference attention_model/model.py).

  - attention: score = A(tanh(U(features) + W(h))), softmax over the grid's
    positions, context = sum(alpha * features);
  - an LSTM cell over [word_embed ‖ context] in torch LSTMCell's gate order
    (i, f, g, o), h and c from linear maps of the MEAN feature;
    logits = fcn(dropout(h));
  - teacher-forced `captioner_forward` and greedy `generate_caption`, which
    returns the per-step alphas for the 7x7 overlays.

The JAX package's lax.scan and while_loop are Python loops over the steps.
U(features) does not change over the steps, so it is computed once a call
(the JAX step recomputes it; the same products). Greedy decode stops when
every row is done, one host check a step. The tree is the JAX package's
(`convert.init_lstm_captioner`, `from_torch_state_dict`), weights [in, out].
"""

from __future__ import annotations

import numpy as np
import torch


def _lin(p, x):
    return x @ p["w"] + p["b"]


def attention(params, features, h, u=None):
    """features [B,N,enc], h [B,dec] -> (alpha [B,N], context [B,enc]). `u`:
    U(features), where the caller computed it once for every step."""
    u = _lin(params["att_U"], features) if u is None else u    # [B,N,att]
    w = _lin(params["att_W"], h)                                # [B,att]
    scores = _lin(params["att_A"], torch.tanh(u + w[:, None]))[..., 0]
    alpha = torch.softmax(scores, dim=1)
    context = (features * alpha[..., None]).sum(dim=1)
    return alpha, context


def _lstm_cell(params, x, h, c):
    gates = x @ params["w_ih"] + params["b_ih"] + h @ params["w_hh"] + params["b_hh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def init_state(params, features):
    mean = features.mean(dim=1)
    return _lin(params["init_h"], mean), _lin(params["init_c"], mean)


def captioner_forward(params, features, captions, *, dropout_rate: float = 0.0,
                      generator: torch.Generator | None = None):
    """Teacher-forced: features [B,N,enc], captions [B,T] ->
    (logits [B,T-1,V], alphas [B,T-1,N]). Dropout on h before fcn draws its
    masks from `generator` (on the features' device) when dropout_rate > 0
    and a generator is given, as the JAX step drops only with a key."""
    embeds = params["embedding"][captions]        # [B,T,E]
    h, c = init_state(params, features)
    u = _lin(params["att_U"], features)
    keep_p = 1.0 - dropout_rate
    logits, alphas = [], []
    for t in range(captions.shape[1] - 1):
        alpha, context = attention(params, features, h, u)
        h, c = _lstm_cell(params, torch.cat([embeds[:, t], context], dim=-1), h, c)
        out = h
        if dropout_rate > 0.0 and generator is not None:
            keep = torch.rand(out.shape, generator=generator, device=out.device) < keep_p
            out = torch.where(keep, out / keep_p, 0.0)
        logits.append(_lin(params["fcn"], out))
        alphas.append(alpha)
    return torch.stack(logits, dim=1), torch.stack(alphas, dim=1)


def caption_lm_loss_parts(logits, captions, *, pad_id: int = 0):
    """(sum of masked token NLL, number of valid tokens): the pieces of the
    global token-mean CE, which data-parallel ranks sum before dividing."""
    targets = captions[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    mask = (targets != pad_id).float()
    return (nll * mask).sum(), mask.sum()


def caption_lm_loss(logits, captions, *, pad_id: int = 0):
    """CE of logits[:, s] against captions[:, s+1], padding masked."""
    total, count = caption_lm_loss_parts(logits, captions, pad_id=pad_id)
    return total / count.clamp(min=1.0)


@torch.no_grad()
def generate_caption(params, features, *, sos_id: int, eos_id: int, max_len: int = 20):
    """Greedy decode. features [B,N,enc] -> (tokens [B,max_len] int32, lengths
    [B], alphas [B,max_len,N]). A row that emitted eos takes 0 from the next
    step on; the loop stops when every row is done, and the steps it did not
    run leave tokens and alphas at 0, as the JAX while_loop does."""
    b, n, _ = features.shape
    dev = features.device
    h, c = init_state(params, features)
    u = _lin(params["att_U"], features)
    emb = params["embedding"][torch.full((b,), sos_id, dtype=torch.long, device=dev)]
    toks = torch.zeros(b, max_len, dtype=torch.int32, device=dev)
    alphas = torch.zeros(b, max_len, n, dtype=features.dtype, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(max_len):
        alpha, context = attention(params, features, h, u)
        h, c = _lstm_cell(params, torch.cat([emb, context], dim=-1), h, c)
        nxt = _lin(params["fcn"], h).argmax(dim=-1)
        nxt = torch.where(done, 0, nxt)
        toks[:, t] = nxt
        alphas[:, t] = alpha
        done = done | (nxt == eos_id)
        emb = params["embedding"][nxt]
        if bool(done.all()):
            break
    is_eos = toks == eos_id
    lengths = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1) + 1, max_len)
    return toks, lengths, alphas


def from_torch_state_dict(sd, *, vocab_size: int) -> dict:
    """A torch DecoderRNN state dict (the reference attention_model layout)
    -> the JAX package's tree, numpy (`convert.to_params` makes it a
    ParamTree). vocab_size is taken for the JAX package's signature."""
    def a(k):
        x = sd[k]
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.asarray(x)

    def lin(prefix):
        return {"w": a(f"{prefix}.weight").T, "b": a(f"{prefix}.bias")}

    return {
        "embedding": a("embedding.weight"),
        "att_W": lin("attention.W"), "att_U": lin("attention.U"),
        "att_A": lin("attention.A"),
        "init_h": lin("init_h"), "init_c": lin("init_c"),
        "w_ih": a("lstm_cell.weight_ih").T, "b_ih": a("lstm_cell.bias_ih"),
        "w_hh": a("lstm_cell.weight_hh").T, "b_hh": a("lstm_cell.bias_hh"),
        "fcn": lin("fcn"),
    }
