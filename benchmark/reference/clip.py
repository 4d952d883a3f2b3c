"""Plain PyTorch reference of the CLIP cells: preprocessing, both towers,
zero-shot label probabilities, symmetric InfoNCE and AdamW.

It follows OpenAI CLIP (github.com/openai/CLIP clip/model.py) over the
parameter layout of benchmark/weights.py (weights [in, out], layers stacked
along a leading axis) and imports nothing of the program under test. It
computes in float32 with TF32 off (mode "fp32"). The controls run the same
code one precision lower: mode "tf32" turns TF32 on for every float32
product, and mode "fp8" rounds both operands of every model product, in the
forward and the backward, to float8 (e4m3, one scale a tensor).

Batches run in blocks of rows so that they fit beside nothing else on the
card. A training step's gradient is exact across blocks: the features of the
whole batch are taken without a graph, the loss's gradient with respect to
them is formed once, and each block is then run again with a graph and
backpropagated from that gradient.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5


@contextlib.contextmanager
def precision(mode: str):
    """float32 products as `mode` asks ("tf32": TF32 on; else full float32)."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if mode == "tf32" else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _fp8(x, dtype=torch.float8_e4m3fn):
    """x rounded to float8 with one scale for the tensor, back in float32."""
    top = float(torch.finfo(dtype).max)
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _fp8(a) @ _fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        return gq @ _fp8(b).mT, _fp8(a).mT @ gq


def mm(a, b, mode: str):
    return _Fp8MatMul.apply(a, b) if mode == "fp8" else a @ b


# Copied from the JAX package's data/preprocess.py:_pil_resize_weights (numpy):
# PIL's bicubic filter (a = -0.5, support scaled by the downscale factor, rows
# normalised), as the weights of a dense product.
@functools.lru_cache(maxsize=8)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    a = -0.5

    def cubic(x):
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        if x < 2.0:
            return (((x - 5.0) * x + 8.0) * x - 4.0) * a
        return 0.0

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        ks = [cubic((j + 0.5 - center) / filterscale) for j in range(lo, hi)]
        s = sum(ks)
        if s != 0:
            w[i, lo:hi] = np.asarray(ks) / s
    return w.astype(np.float32)


def preprocess(u8, size: int):
    """[B, S, S, 3] uint8 (square) -> [B, size, size, 3] float32: bicubic
    resize of the shorter side to `size` (PIL's filter), centre crop with
    torchvision's rounding, clip to [0, 1], CLIP's normalisation."""
    x = u8.float() / 255.0
    h, w = x.shape[1], x.shape[2]
    th, tw = (size, max(size, int(round(w * size / h)))) if h <= w else \
        (max(size, int(round(h * size / w))), size)
    wh = torch.from_numpy(resize_weights(h, th)).to(x.device)
    ww = torch.from_numpy(resize_weights(w, tw)).to(x.device)
    x = torch.einsum("oh,bhwc->bowc", wh, x)
    x = torch.einsum("pw,bowc->bopc", ww, x)
    top, left = int(round((th - size) / 2.0)), int(round((tw - size) / 2.0))
    x = x[:, top: top + size, left: left + size, :].clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def layer_norm(x, p):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * p["scale"] + p["bias"]


def _layer(stacked, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in stacked.items()}


def block(x, p, heads: int, causal: bool, mode: str):
    b, t, d = x.shape
    dh = d // heads
    qkv = mm(layer_norm(x, p["ln_1"]), p["attn"]["w_qkv"], mode) + p["attn"]["b_qkv"]
    q, k, v = (z.reshape(b, t, heads, dh).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
    logits = mm(q, k.transpose(-1, -2), mode) * dh ** -0.5
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    out = mm(torch.softmax(logits, dim=-1), v, mode).transpose(1, 2).reshape(b, t, d)
    x = x + mm(out, p["attn"]["w_out"], mode) + p["attn"]["b_out"]
    hid = mm(layer_norm(x, p["ln_2"]), p["mlp"]["w_fc"], mode) + p["mlp"]["b_fc"]
    hid = hid * torch.sigmoid(1.702 * hid)   # QuickGELU
    return x + mm(hid, p["mlp"]["w_proj"], mode) + p["mlp"]["b_proj"]


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def encode_image(params, cfg: dict, images, mode: str):
    """[B, H, W, 3] preprocessed -> [B, embed] L2-normalised."""
    v, p = cfg["vision"], params["vision"]
    b, ps = images.shape[0], v["patch_size"]
    g = v["image_size"] // ps
    x = images.reshape(b, g, ps, g, ps, 3).permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, 3 * ps * ps)
    x = mm(x, p["patch_embed"], mode)
    x = torch.cat([p["class_emb"].expand(b, 1, v["width"]), x], dim=1) + p["pos_emb"]
    x = layer_norm(x, p["ln_pre"])
    for i in range(v["layers"]):
        x = block(x, _layer(p["blocks"], i), v["heads"], False, mode)
    return _normalize(mm(layer_norm(x[:, 0], p["ln_post"]), p["proj"], mode))


def encode_text(params, cfg: dict, tokens, mode: str):
    """[B, context] ids -> [B, embed] L2-normalised, read at the largest id."""
    t, p = cfg["text"], params["text"]
    tokens = tokens.long()
    x = p["tok_emb"][tokens] + p["pos_emb"][: tokens.shape[1]]
    for i in range(t["layers"]):
        x = block(x, _layer(p["blocks"], i), t["heads"], True, mode)
    x = layer_norm(x, p["ln_final"])
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return _normalize(mm(x, p["proj"], mode))


def zeroshot_logprobs(params, cfg: dict, label_feats, u8, mode: str, rows: int):
    """log-probabilities [B, L] of the labels for staged uint8 images."""
    out = []
    with torch.no_grad():
        for lo in range(0, u8.shape[0], rows):
            img = encode_image(params, cfg, preprocess(u8[lo: lo + rows],
                                                       cfg["vision"]["image_size"]), mode)
            logits = torch.exp(params["logit_scale"]) * img @ label_feats.T
            out.append(torch.log_softmax(logits, dim=-1))
    return torch.cat(out)


def infonce(img, txt, logit_scale):
    logits = torch.exp(logit_scale) * img @ txt.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    ce = torch.nn.functional.cross_entropy
    return 0.5 * (ce(logits, labels) + ce(logits.T, labels))


def _features(params, cfg, u8, tokens, mode, rows, lo, hi):
    img = encode_image(params, cfg, preprocess(u8[lo:hi], cfg["vision"]["image_size"]), mode)
    return img, encode_text(params, cfg, tokens[lo:hi], mode)


def loss_and_grads(params, leaves: dict, cfg: dict, u8, tokens, mode: str, rows: int):
    """(loss, {path: gradient}) of symmetric InfoNCE over the whole batch,
    run in blocks of `rows`. `leaves` maps paths to the tensors of `params`,
    which require grad."""
    n = u8.shape[0]
    for p in leaves.values():
        p.grad = None
    with torch.no_grad():
        parts = [_features(params, cfg, u8, tokens, mode, rows, lo, min(lo + rows, n))
                 for lo in range(0, n, rows)]
    img = torch.cat([a for a, _ in parts]).requires_grad_()
    txt = torch.cat([b for _, b in parts]).requires_grad_()
    loss = infonce(img, txt, params["logit_scale"])
    loss.backward()
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        fi, ft = _features(params, cfg, u8, tokens, mode, rows, lo, hi)
        ((fi * img.grad[lo:hi]).sum() + (ft * txt.grad[lo:hi]).sum()).backward()
    return float(loss.detach()), {k: p.grad.detach().clone() for k, p in leaves.items()}


class AdamW:
    """optax.adamw over a linear warm-up and decay schedule: bias correction
    with count + 1, the decay added before the rate, the rate taken at the
    count before the step."""

    def __init__(self, lr, warmup_steps, total_steps, weight_decay=0.0, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.lr, self.warmup, self.total = lr, warmup_steps, total_steps
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.count, self.m, self.v = 0, {}, {}

    def rate(self, step: int) -> float:
        if step < self.warmup:
            return self.lr * step / max(1.0, self.warmup)
        return self.lr * max(0.0, (self.total - step) / max(1.0, self.total - self.warmup))

    @torch.no_grad()
    def apply(self, leaves: dict, grads: dict):
        c, lr = self.count, self.rate(self.count)
        for k, p in leaves.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * self.b2 + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            u = (m / (1 - self.b1 ** (c + 1))) / ((v / (1 - self.b2 ** (c + 1))).sqrt() + self.eps)
            p -= lr * (u + self.wd * p)
        self.count += 1


def _nest(flat: dict) -> dict:
    tree = {}
    for path, value in flat.items():
        node = tree
        keys = path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree


def train_readings(params, leaves: dict, cfg: dict, batches, opt: AdamW, mode: str,
                   rows: int, units) -> dict:
    """Runs len(batches) steps from `params` (changed in place) and returns
    {"loss": [each step's loss], "grad_norm": {unit: the first gradient's
    norm}, "change_norm": {unit: |params after the steps - params before|}},
    over the parts that units(tree) names."""
    start = {k: p.detach().clone() for k, p in leaves.items()}
    losses, first = [], None
    with precision(mode):
        for u8, tokens in batches:
            loss, grads = loss_and_grads(params, leaves, cfg, u8, tokens, mode, rows)
            losses.append(loss)
            if first is None:
                first = {k: float(torch.linalg.vector_norm(g)) for k, g in units(_nest(grads))}
            opt.apply(leaves, grads)
            del grads
    moved = _nest({k: p.detach() - start[k] for k, p in leaves.items()})
    change = {k: float(torch.linalg.vector_norm(d)) for k, d in units(moved)}
    return {"loss": losses, "grad_norm": first, "change_norm": change}
