"""Relevance-propagation explainability (counterpart of
construction_clip_tpu/infer/explain.py): for each image-text pair, the
gradient of its logit with respect to every block's attention probabilities,
cam = clamp(grad * probs, 0).mean(heads), propagated as R += cam @ R through
the blocks from `start_layer` (-1: the last block alone), for the image and
the text tower; then the CLS row of R_image as a bilinear-upsampled JET
overlay and the EOT row of R_text as per-character scores and an HTML
heatmap; and the decoder's last-layer attention over the prompt and the
caption.

The gradient comes through `probs_probe` (ops/attention.mha): zeros added to
the probabilities, whose gradient is the probabilities' gradient. One
`torch.autograd.grad` of the diagonal logit sum gives both towers' probe
gradients, as `jax.grad` does in the JAX package. The probe path is the
composed attention in every block (models/blocks.apply_block leaves the
fused kernel for it), in the policy's dtype; the explain app runs it in fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models import gpt2 as gpt2_lib
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text


def _propagate(probs, grads, start_layer: int):
    """probs, grads [L, B, H, T, T] -> relevance R [B, T, T]."""
    n_layers, b, _, t, _ = probs.shape
    cam = (grads * probs).clamp(min=0).mean(dim=2)   # [L, B, T, T]
    eye = torch.eye(t, dtype=cam.dtype, device=cam.device).expand(b, t, t)
    r = eye
    for layer in range(start_layer % n_layers, n_layers):
        r = r + cam[layer] @ r
    return r - eye


def interpret(params, cfg: CLIPConfig, images, tokens, *, start_layer: int = -1,
              start_layer_text: int = -1, policy: Policy = DEFAULT_POLICY):
    """images [B, H, W, 3] preprocessed, tokens [B, ctx], on the params' device;
    image i pairs with text i (the diagonal of the logits).

    Returns (R_text [B, ctx, ctx], R_image [B, T_img, T_img]), fp32; row 0 of
    R_image (the CLS row) and the EOT row of R_text are what the figures show."""
    params = as_tree(params)
    v, t = cfg.vision, cfg.text
    b, dev = images.shape[0], images.device
    tokens = torch.as_tensor(tokens, device=dev)
    probe_v = torch.zeros((v.layers, b, v.heads, v.seq_len, v.seq_len), device=dev,
                          requires_grad=True)
    probe_t = torch.zeros((t.layers, b, t.heads, tokens.shape[1], tokens.shape[1]),
                          device=dev, requires_grad=True)
    with torch.enable_grad():
        img_f, probs_v = encode_image(params, cfg, images, policy=policy, normalize=True,
                                      return_probs=True, probs_probe=probe_v)
        txt_f, probs_t = encode_text(params, cfg, tokens, policy=policy, normalize=True,
                                     return_probs=True, probs_probe=probe_t)
        logits = torch.exp(params["logit_scale"]) * img_f @ txt_f.T
        grad_v, grad_t = torch.autograd.grad(torch.diagonal(logits).sum(), (probe_v, probe_t))
    r_image = _propagate(probs_v.detach().float(), grad_v, start_layer)
    r_text = _propagate(probs_t.detach().float(), grad_t, start_layer_text)
    return r_text, r_image


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def resize_bilinear(x, out_hw) -> np.ndarray:
    """A 2-D map resized to out_hw (H, W) bilinearly with half-pixel centres,
    as jax.image.resize(..., "bilinear") does (antialiased when it shrinks)."""
    x = torch.from_numpy(np.ascontiguousarray(_to_numpy(x)))[None, None]
    shrink = out_hw[0] < x.shape[-2] or out_hw[1] < x.shape[-1]
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=shrink)[0, 0].numpy()


def image_relevance_map(r_image_row, grid: int, *, out_size: int = 224) -> np.ndarray:
    """R_image[b, 0] (the CLS row) over the grid x grid patches -> [out_size,
    out_size] in [0, 1] (resize_bilinear)."""
    rel = _to_numpy(r_image_row)[1: 1 + grid * grid].reshape(grid, grid)
    rel = resize_bilinear(rel, (out_size, out_size))
    lo, hi = rel.min(), rel.max()
    return (rel - lo) / (hi - lo + 1e-8)


def text_relevance_scores(r_text_row, tokens_row, eot_index: int) -> np.ndarray:
    """Relevance of each token for the EOT feature position, normalized to
    [0, 1] over the real tokens."""
    scores = _to_numpy(r_text_row)[eot_index].copy()
    n = int(eot_index) + 1
    s = scores[:n]
    lo, hi = s.min(), s.max()
    out = np.zeros_like(scores)
    out[:n] = (s - lo) / (hi - lo + 1e-8)
    return out


def text_heatmap_per_char(r_text_b, tokens_row, text: str, tokenizer):
    """Per-character relevance of one text: the EOT row of R_text over the
    columns 1 .. EOT-1 (the BPE tokens between SOT and EOT), normalized to sum
    1, each character taking the sum of its BPE tokens' scores. Returns
    [(char, score)] for as many characters as have token scores."""
    eot = int(np.asarray(tokens_row).argmax())
    row = _to_numpy(r_text_b)[eot, 1:eot]
    total = row.sum()
    scores = row / total if total != 0 else row
    out = []
    i = 0
    for ch in text:
        n = len(tokenizer.encode(ch))
        if n == 0:
            out.append((ch, 0.0))
            continue
        if i + n > len(scores):
            break
        out.append((ch, float(scores[i: i + n].sum())))
        i += n
    return out


def render_text_heatmap_html(char_scores, out_path: str, *, title: str = "") -> str:
    """The per-character heatmap as HTML, written to `out_path` and returned:
    green for positive relevance, red for negative, opacity by magnitude."""
    spans = []
    peak = (max(abs(s) for _, s in char_scores) or 1.0) if char_scores else 1.0
    for ch, s in char_scores:
        a = min(abs(s) / peak, 1.0)
        color = (f"hsla(120, 75%, 50%, {a:.3f})" if s >= 0
                 else f"hsla(0, 75%, 50%, {a:.3f})")
        label = ch.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        spans.append(
            f'<mark style="background-color: {color}; line-height: 1.75">'
            f"{label}</mark>")
    html = ("<html><head><meta charset='utf-8'></head><body>"
            f"<div><b>{title}</b></div>"
            f"<div style='font-size: 20px'>{''.join(spans)}</div>"
            "</body></html>")
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(html)
    return html


def decoder_attention_map(gpt_params, gcfg, prompt_embeds, generated_tokens, *,
                          policy: Policy = DEFAULT_POLICY) -> np.ndarray:
    """The last layer's decoder attention of each generated token, from one
    uncached forward over [prompt ‖ generated] (causal attention makes each
    row what the step that generated the token saw). Returns [n_generated,
    seq_len] for row 0: the mean over heads of the attention of each position
    that predicts a generated token."""
    gpt_params = as_tree(gpt_params)
    generated_tokens = torch.as_tensor(generated_tokens, device=prompt_embeds.device)
    with torch.inference_mode():
        tok_emb = gpt2_lib.embed_tokens(gpt_params, generated_tokens, policy=policy)
        embeds = torch.cat([prompt_embeds.to(tok_emb.dtype), tok_emb], dim=1)
        _, probs = gpt2_lib.gpt2_forward(gpt_params, gcfg, inputs_embeds=embeds, policy=policy,
                                         return_probs=True)
        t0 = prompt_embeds.shape[1]
        rows = probs[-1][:, :, t0 - 1: -1, :].mean(dim=1)
    return rows[0].cpu().numpy()


def plot_attention_map(attn_rows: np.ndarray, out_path: str, *, token_labels=None) -> None:
    """A heatmap figure of decoder_attention_map's rows (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, max(3, attn_rows.shape[0] / 4)))
    ax.imshow(attn_rows, aspect="auto", cmap="viridis")
    ax.set_xlabel("attended position")
    ax.set_ylabel("generated token")
    if token_labels is not None:
        ax.set_yticks(range(len(token_labels)))
        ax.set_yticklabels(token_labels)
    fig.colorbar(ax.images[0])
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def overlay_heatmap(image_u8: np.ndarray, relevance01: np.ndarray) -> np.ndarray:
    """JET overlay: image_u8 [H, W, 3], relevance01 [H, W] in [0, 1] -> uint8
    [H, W, 3]. OpenCV's JET where cv2 imports, else a numpy approximation of
    it, as the JAX package."""
    try:
        import cv2

        heat = cv2.applyColorMap((relevance01 * 255).astype(np.uint8), cv2.COLORMAP_JET)
        heat = cv2.cvtColor(heat, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    except ImportError:
        x = relevance01
        heat = np.stack([np.clip(1.5 - np.abs(4 * x - 3), 0, 1),
                         np.clip(1.5 - np.abs(4 * x - 2), 0, 1),
                         np.clip(1.5 - np.abs(4 * x - 1), 0, 1)], axis=-1)
    img = image_u8.astype(np.float32) / 255.0
    out = heat + img
    out = out / out.max()
    return (out * 255).astype(np.uint8)
