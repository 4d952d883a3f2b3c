"""End-to-end caption prediction: image -> CLIP embed -> zero-shot attribute ->
mapper prefix -> GPT-2 decode -> text (counterpart of
construction_clip_tpu/infer/caption.py:CaptionPipeline, same fields and outputs).

Params are the JAX layout (ParamTrees or nested dicts of tensors, see
core/params.py) on one device; they are cast once to the policy's compute dtype
at construction, except an int8-serving image tower or GPT-2
(models/clip/quant.quantize_clip, models/gpt2.quantize_gpt2), which stay as
the quantizer left them: bf16 floats, int8 weights, fp32 scales. Everything
from the preprocessed images to the decoded tokens stays on that device; the
host fetches one packed int32 array per batch.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from construction_clip_tpu_torch.core.configs import CLIPConfig, ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.data.labels import (
    CAPTION_TYPE_PROMPTS, VIOLATION_TYPES, attribute_string)
from construction_clip_tpu_torch.infer.decode import beam_decode, greedy_decode
from construction_clip_tpu_torch.infer.precompute import make_embed_classify_fn
from construction_clip_tpu_torch.models import gpt2 as gpt2_lib
from construction_clip_tpu_torch.models.clip.quant import is_quantized_clip
from construction_clip_tpu_torch.models.clipcap.model import map_prefix


def _cast_except(tree, policy: Policy, keep: Optional[str]):
    """policy.cast_to_compute over `tree`, but the subtree `keep` as it is."""
    rest = policy.cast_to_compute({k: v for k, v in tree.items() if k != keep})
    return rest if keep is None else dict(rest, **{keep: tree[keep]})


@dataclasses.dataclass
class CaptionPipeline:
    clip_params: object       # ParamTree or nested dict of tensors
    clip_cfg: CLIPConfig
    cap_params: object        # {"mapper", "gpt"}
    ccfg: ClipCapConfig
    gcfg: GPT2Config
    clip_tokenizer: object    # ClipTokenizer (label prompts)
    lm_tokenizer: object      # BERT-style tokenizer (attribute + captions)
    policy: Policy = DEFAULT_POLICY
    stop_token: int = 102     # [SEP] in the BERT-chinese vocab
    max_steps: int = 100
    beam_size: int = 3
    temperature: float = 0.5

    def __post_init__(self):
        clip, cap = as_tree(self.clip_params), as_tree(self.cap_params)
        self._clip = _cast_except(clip, self.policy,
                                  "vision" if is_quantized_clip(clip) else None)
        self._cap = _cast_except(cap, self.policy,
                                 "gpt" if gpt2_lib._is_quantized(cap["gpt"]) else None)
        self.device = tree_leaves(self._clip)[0].device
        ctx = self.clip_cfg.text.context_length
        ct = self.clip_tokenizer.tokenize(list(CAPTION_TYPE_PROMPTS), ctx)
        vt = self.clip_tokenizer.tokenize(list(VIOLATION_TYPES), ctx)
        self._embed_classify = make_embed_classify_fn(
            self._clip, self.clip_cfg, ct, vt, policy=self.policy)
        # the zero-shot attribute takes one of len(ct) x len(vt) = 18 values, so
        # its token rows are a device table and the lookup a device gather
        rows = [self.attribute_tokens([attribute_string(c, v)])[0]
                for c in CAPTION_TYPE_PROMPTS for v in VIOLATION_TYPES]
        self._attr_table = torch.from_numpy(np.stack(rows)).to(self.device)

    # ---- pieces -----------------------------------------------------------

    def classify_and_embed(self, images):
        """preprocessed images [B,H,W,3] -> (clip_embeds [B,E], attributes [B] str)."""
        emb, ct, vt = self._embed_classify(images)
        attrs = [attribute_string(CAPTION_TYPE_PROMPTS[int(c)], VIOLATION_TYPES[int(v)])
                 for c, v in zip(ct.tolist(), vt.tolist())]
        return emb, attrs

    def attribute_tokens(self, attributes: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(attributes), self.ccfg.attribute_length), np.int32)
        for i, a in enumerate(attributes):
            ids = self.lm_tokenizer.encode(a)[: self.ccfg.attribute_length]
            out[i, : len(ids)] = ids
        return out

    def prompt_embeds(self, clip_embeds, attr_tokens):
        prefix = map_prefix(self._cap["mapper"], self.ccfg, self.gcfg, clip_embeds,
                            policy=self.policy)
        attr_emb = gpt2_lib.embed_tokens(self._cap["gpt"],
                                         torch.as_tensor(attr_tokens, device=self.device),
                                         policy=self.policy)
        return torch.cat([prefix.to(attr_emb.dtype), attr_emb], dim=1)

    def decode_to_text(self, tokens: np.ndarray, lengths: np.ndarray) -> list[str]:
        out = []
        for row, n in zip(tokens, lengths):
            ids = [int(t) for t in row[: int(n)] if int(t) != self.stop_token]
            text = self.lm_tokenizer.decode(ids, skip_special_tokens=True)
            out.append(text.replace(" ", ""))  # BERT-zh decode inserts spaces
        return out

    def _greedy(self, embeds):
        return greedy_decode(self._cap["gpt"], self.gcfg, embeds, max_steps=self.max_steps,
                             stop_token=self.stop_token, policy=self.policy)

    # ---- end to end -------------------------------------------------------

    @torch.inference_mode()
    def caption_images(self, images, *, attributes: Optional[Sequence[str]] = None,
                       use_beam: bool = True):
        """images: preprocessed [B,H,W,3] on the pipeline's device. Returns a list of
        dicts {caption, attribute, caption_type, violation_type, decode_suspect}."""
        emb, ct, vt = self._embed_classify(images)
        if attributes is None:
            attr_tok = self._attr_table[ct * len(VIOLATION_TYPES) + vt]
        else:
            attr_tok = self.attribute_tokens(list(attributes))
        embeds = self.prompt_embeds(emb, attr_tok)
        if use_beam:
            res = beam_decode(self._cap["gpt"], self.gcfg, embeds,
                              beam_size=self.beam_size, max_steps=self.max_steps,
                              stop_token=self.stop_token, temperature=self.temperature,
                              policy=self.policy)
            toks_d, lens_d = res.tokens[:, 0], res.lengths[:, 0]  # best beam
        else:
            res = self._greedy(embeds)
            toks_d, lens_d = res.tokens, res.lengths
        cols = [toks_d.int(), lens_d[:, None].int()]
        if attributes is None:
            cols += [ct[:, None].int(), vt[:, None].int()]
        packed = torch.cat(cols, dim=1).cpu().numpy()
        if attributes is not None:
            toks, lens = packed[:, :-1], packed[:, -1]
            attrs = list(attributes)
        else:
            toks, lens = packed[:, :-3], packed[:, -3]
            attrs = [attribute_string(CAPTION_TYPE_PROMPTS[int(c)], VIOLATION_TYPES[int(v)])
                     for c, v in zip(packed[:, -2], packed[:, -1])]
        captions = self.decode_to_text(toks, lens)
        # Decode-collapse guard, as the JAX pipeline: a row that decodes to '' at
        # exactly max_steps is retried with greedy; rows still collapsed after
        # that are flagged decode_suspect for the caller to re-run.
        suspect = {i for i, (c, n) in enumerate(zip(captions, lens))
                   if not c and int(n) >= self.max_steps}
        if use_beam and suspect:
            bad = sorted(suspect)
            logging.getLogger(__name__).warning(
                "beam decode collapsed on %d/%d rows (empty at max_steps);"
                " retrying those rows with greedy decode", len(bad), len(captions))
            g = self._greedy(embeds)
            gpacked = torch.cat([g.tokens.int(), g.lengths[:, None].int()],
                                dim=1).cpu().numpy()
            gcaps = self.decode_to_text(gpacked[:, :-1], gpacked[:, -1])
            for i in bad:
                captions[i] = gcaps[i]
                if gcaps[i] or int(gpacked[i, -1]) < self.max_steps:
                    suspect.discard(i)
        if suspect:
            logging.getLogger(__name__).error(
                "%d/%d rows still collapsed after retry; rows are flagged"
                " decode_suspect", len(suspect), len(captions))
        out = []
        for i, (cap, attr) in enumerate(zip(captions, attrs)):
            parts = attr.split()
            ct_zh = parts[0] if parts else ""
            vt_zh = parts[1] if len(parts) > 1 else ""
            out.append({
                "caption": cap,
                "attribute": attr,
                "caption_type": "status" if ct_zh == "現況" else "violation",
                "violation_type": vt_zh,
                "decode_suspect": i in suspect,
            })
        return out
