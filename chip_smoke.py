#!/usr/bin/env python3
"""Smoke run of the PyTorch port (construction_clip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (the last line is the JSON verdict):
  1. device: the card's name and power limit; no CUDA device is an error.
  2. build: nvcc builds the port's CUDA kernels from csrc/ (timed).
  3. K1, the fused attention block, against its plain version at the serving
     path's shapes, bf16 and fp32, with times.
  4. K2, decode-step attention with beam ancestry, against its plain version.
  5. the serving path at full width (ViT-B/32, GPT-2 12x768, MLP mapper, random
     weights from a numpy seed, bf16): requests from 4 threads through
     TorchPredictService; launch counts of both kernels in that run.
  6. kernel path against plain path at full width in fp32: image features,
     zero-shot classes and greedy tokens.
Any failed check raises, so the script exits nonzero and prints no verdict.
The script imports nothing of JAX, tokenizers, transformers or PIL.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from construction_clip_tpu.data.clip_tokenizer import ClipTokenizer  # noqa: E402
from construction_clip_tpu.data.labels import (  # noqa: E402
    CAPTION_TYPE_PROMPTS, VIOLATION_TYPES, attribute_string)
from construction_clip_tpu_torch import convert  # noqa: E402
from construction_clip_tpu_torch.core.configs import (  # noqa: E402
    CLIPConfig, ClipCapConfig, GPT2Config)
from construction_clip_tpu_torch.core.params import as_tree  # noqa: E402
from construction_clip_tpu_torch.core.precision import BF16_POLICY  # noqa: E402
from construction_clip_tpu_torch.data.preprocess import preprocess_batch  # noqa: E402
from construction_clip_tpu_torch.infer.caption import CaptionPipeline  # noqa: E402
from construction_clip_tpu_torch.infer.decode import greedy_decode  # noqa: E402
from construction_clip_tpu_torch.infer.precompute import make_embed_classify_fn  # noqa: E402
from construction_clip_tpu_torch.models import gpt2  # noqa: E402
from construction_clip_tpu_torch.models.clipcap.model import map_prefix  # noqa: E402
from construction_clip_tpu_torch.ops import _build  # noqa: E402
from construction_clip_tpu_torch.ops.attention import use_impl  # noqa: E402
from construction_clip_tpu_torch.ops.attention_block import (  # noqa: E402
    fused_attention_block, fused_attention_block_plain)
from construction_clip_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_step_attention, decode_step_attention_plain)
from construction_clip_tpu_torch.serve.app import TorchPredictService  # noqa: E402

K1_SHAPES = ((8, 50, 768, 12, False),   # ViT-B/32 image tower, batch 8
             (9, 77, 512, 8, True),     # text tower, 9 violation-type prompts
             (2, 77, 512, 8, True))     # text tower, 2 caption-type prompts
# bf16 keeps 8 significant bits: one rounding step is up to 2^-7 of the value,
# and a different summation order can flip the rounding of qkv, p and the
# output. fp32: the same math with the sums in another order.
K1_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-4, 2e-4)}   # (atol, rtol)
# K2 rounds once, at the output: at most one bf16 step apart; fp32 order only.
K2_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
K2_SHAPE = dict(layers=12, rows=24, heads=12, t_max=140, dh=64)   # 8 images x beam 3
K2_CACHE_LENS = (39, 90, 139)

KERNELS = {
    "fused_attention_block": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/attention_block.cu",
        replaces="construction_clip_tpu/ops/pallas_attention_block.py:402"),
    "decode_step_attention": dict(
        route="cuda", source="construction_clip_tpu_torch/csrc/decode_attention.cu",
        replaces="construction_clip_tpu/ops/pallas_decode_attention.py:92"),
}


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
    say("build", seconds=time.perf_counter() - t0, library=str(_build.library_path()))


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

            got = kernel()
            torch.cuda.synchronize()
            stats = compare(got, plain(), *K1_TOL[dtype],
                            what=f"K1 {[b, t, d]} h={h} causal={causal} {dtype}")
            stats.update(ms=median_ms(kernel), plain_ms=median_ms(plain))
            say("k1", shape=[b, t, d], heads=h, causal=causal, dtype=str(dtype), **stats)
            if (b, t, d) == (8, 50, 768) and dtype == torch.bfloat16:
                results["fused_attention_block"] = stats


def phase_k2(results: dict) -> None:
    rng = np.random.default_rng(2)
    s = K2_SHAPE
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
                    return decode_step_attention_plain(q, ck, cv, layer, cache_len, ancestry)

                got = kernel()
                torch.cuda.synchronize()
                stats = compare(got, plain(), *K2_TOL[dtype],
                                what=f"K2 cache_len={cache_len} ancestry={ancestry is not None}"
                                     f" {dtype}")
                stats.update(ms=median_ms(kernel), plain_ms=median_ms(plain))
                say("k2", **s, cache_len=cache_len, ancestry=ancestry is not None,
                    dtype=str(dtype), **stats)
                if cache_len == 139 and ancestry is not None and dtype == torch.bfloat16:
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
        toks = [self.vocab[int(i)] for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t not in self.SPECIAL]
        return " ".join(toks)


def tokenizers(tmp: str):
    """The 49,408-token CLIP BPE and the 21,128-entry BERT vocab, written by
    tools/make_offline_assets.py into `tmp`."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_offline_assets as assets

    merges = os.path.join(tmp, "clip_merges.txt.gz")
    assets.write_clip_merges(merges)
    vocab = os.path.join(tmp, "vocab.txt")
    assets.write_bert_vocab(vocab, assets.corpus_characters([]))
    clip_tok = ClipTokenizer(merges)
    if clip_tok.vocab_size != CLIPConfig().text.vocab_size:
        raise AssertionError(f"CLIP tokenizer vocab {clip_tok.vocab_size}")
    return clip_tok, CharTokenizer(vocab)


def synthetic_images(rng, shapes):
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8) for h, w in shapes]


def reset_launches() -> None:
    fused_attention_block.launches = 0
    decode_step_attention.launches = 0


def launches() -> dict:
    return {"fused_attention_block": fused_attention_block.launches,
            "decode_step_attention": decode_step_attention.launches}


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
    counts = launches()
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


def plain_top2_gaps(params, gcfg, embeds, tokens):
    """Top-2 logit gap of the plain path at each greedy step, teacher-forced
    with the plain path's own tokens: [B, steps]."""
    with use_impl("plain"), torch.inference_mode():
        last, cache = gpt2.gpt2_forward(
            params, gcfg, inputs_embeds=embeds,
            cache=gpt2.KVCache.create(gcfg, embeds.shape[0], embeds.shape[1] + tokens.shape[1],
                                      device=embeds.device))
        gaps = []
        for step in range(tokens.shape[1]):
            top2 = last[:, -1].topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            last, cache = gpt2.gpt2_forward(params, gcfg, tokens=tokens[:, step:step + 1],
                                            cache=cache)
    return torch.stack(gaps, dim=1)


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


def main() -> None:
    info = phase_device()
    phase_build()
    results: dict = {}
    phase_k1(results)
    phase_k2(results)
    with tempfile.TemporaryDirectory() as tmp:
        clip_tok, lm_tok = tokenizers(tmp)
    cfgs = (CLIPConfig.vit_b_32(), GPT2Config(), ClipCapConfig())   # full width
    clip_np = convert.init_clip(0, cfgs[0])
    cap_np = convert.init_clipcap(1, cfgs[2], cfgs[1])
    counts = phase_serve(clip_np, cap_np, cfgs, clip_tok, lm_tok, "cuda")
    phase_parity(clip_np, cap_np, cfgs, clip_tok, lm_tok, "cuda")
    kernels = [{"name": name, **KERNELS[name], "launches": counts[name],
                "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]} for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
