"""The zero-shot batch loop of `apps/predict_zeroshot.py`, as its user runs it.

Set-up makes the weights and the labels' token ids from the seed, the
labels' features through `infer/zeroshot.label_features`, the app's batch
function `make_process` in the traffic's precision, and a pool of staged
uint8 batches (pageable numpy, as `stream_corpus` yields them). The window is
one client in a closed loop: `process(annotations, staged)` on the pool's
batches in turn, the next sent when the previous one's labels are on the host.

The check compares, for a sample of the window's batches drawn from the seed,
the probabilities and labels that `process` returned with the reference's,
computed from the same staged bytes, weights and label ids.
"""

from __future__ import annotations

import gc
import random
import types

import numpy as np
import torch

import trace as tracing
import weights
from work import clip_plan
from harness import Clock, clip_config, free_cuda, reference_module, say, sync

ROWS = 32   # the reference's rows a block


class Run:
    kind = "zeroshot"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, trace: bool):
        from construction_clip_tpu_torch.apps.predict_zeroshot import make_process
        from construction_clip_tpu_torch.core.params import ParamTree
        from construction_clip_tpu_torch.core.precision import policy_from_name
        from construction_clip_tpu_torch.infer.zeroshot import label_features

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.cuda = device.type == "cuda"
        clock = Clock(self.cuda)
        ccfg = clip_config(cfg)
        policy = policy_from_name(traffic["precision"])
        tree = weights.clip_params(cfg, seed, device)
        params = ParamTree(tree).tree()
        del tree
        t = cfg["text"]
        self.label_tokens = weights.token_ids(
            traffic["labels"], t["context_length"], t["vocab_size"], traffic["label_eot"],
            weights.generator(seed, weights.LABELS, device), device)
        clock.lap("weights")
        feats = label_features(params, ccfg, self.label_tokens, policy=policy)
        clock.lap("label features (loads the kernels)")
        self.names = [f"label_{i}" for i in range(traffic["labels"])]
        self.process = make_process(params, ccfg, feats, self.names, "violation_type", device,
                                    policy=policy)
        b, s = traffic["batch"], traffic["stage_size"]
        g = weights.generator(seed, weights.IMAGES, device)
        self.pool = [weights.images_u8(b, s, g, device).cpu().numpy()
                     for _ in range(traffic["pool_batches"])]
        self.anns = [[types.SimpleNamespace(id=f"{k}-{i}", file_name=f"{k}-{i}.jpg",
                                            violation_type=None) for i in range(b)]
                     for k in range(len(self.pool))]
        clock.lap("input pool")
        self.outs = []
        for _ in range(traffic["warmup_batches"]):
            self._unit()
        self.outs = []
        clock.lap("warm-up batches")
        if trace:
            tracing.warm()
        sync(self.cuda)
        clock.lap("profiler")
        clock.report()

    def _unit(self) -> None:
        k = len(self.outs) % len(self.pool)
        records, probs = self.process(self.anns[k], self.pool[k])
        self.outs.append((k, probs, [self.names.index(r["prediction"]) for r in records]))

    def window(self, seconds: float, trace: bool):
        t = self.traffic
        record = tracing.drive(self._unit, seconds, self.cuda,
                               t["trace_batches"] if trace else 0)
        _describe(record.unit_s)
        self.memory_peak = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0
        vars(record).update(
            kind=self.kind, cfg=self.cfg, traffic=t, done=record.units * t["batch"],
            latencies=record.unit_s, calls=clip_plan.plan(self.cfg, t, ("vision",), False),
            trace=record.stretch.read() if record.stretch else None, stretch=None)
        return record

    def free(self) -> None:
        """Drops the program's state, keeping the sampled outputs."""
        rng = random.Random(self.seed)
        picks = sorted(rng.sample(range(len(self.outs)),
                                  min(self.traffic["check_batches"], len(self.outs))))
        self.picked = [(self.outs[i][0], torch.log(self.outs[i][1].float()).cpu(),
                        self.outs[i][2]) for i in picks]
        self.process = self.outs = None
        gc.collect()
        free_cuda(self.cuda)

    def reference(self, mode: str) -> dict:
        """{pool index: the reference's log-probabilities [B, L]} of the
        sampled batches' staged bytes, in `mode`."""
        ref = reference_module(self.cfg)
        params = weights.clip_params(self.cfg, self.seed, self.device)
        out = {}
        with ref.precision(mode), torch.no_grad():
            feats = ref.encode_text(params, self.cfg, self.label_tokens, mode)
            for k in sorted({k for k, _, _ in self.picked}):
                u8 = torch.from_numpy(self.pool[k]).to(self.device)
                out[k] = ref.zeroshot_logprobs(params, self.cfg, feats, u8, mode, ROWS).cpu()
        del params
        free_cuda(self.cuda)
        return out

    def readings(self, outputs, ref: dict) -> dict:
        """logprob_gap: the largest |log p - log p_ref| over the sample's rows
        and labels (compared); label_gap: the largest amount by which the
        reference's log-probability of a returned label lies below its best
        (printed, not compared: the control, TF32, moves a label too seldom
        for it to separate the two)."""
        lp_gap = label_gap = 0.0
        for k, logp, pred in outputs:
            want = ref[k]
            lp_gap = max(lp_gap, float((logp - want).abs().max()))
            chosen = want.gather(1, torch.tensor(pred)[:, None])[:, 0]
            label_gap = max(label_gap, float((want.max(dim=1).values - chosen).max()))
        return {"logprob_gap": lp_gap, "label_gap": label_gap}

    def check(self) -> dict:
        self.free()
        return self.readings(self.picked, self.reference("fp32"))

    def control(self, mode: str) -> dict:
        """The reference in `mode` put in the program's place, read as the
        program's outputs are (after check)."""
        low = self.reference(mode)
        outputs = [(k, low[k], low[k].argmax(dim=1).tolist()) for k, _, _ in self.picked]
        return self.readings(outputs, self.reference("fp32"))


def _describe(lat: list) -> None:
    """Batch times of the window: percentiles and each quarter's median."""
    if len(lat) < 8:
        return
    ms = np.asarray(lat) * 1e3
    q = len(ms) // 4
    say("batch ms p5 p50 p95 p99", np.percentile(ms, [5, 50, 95, 99]).round(3).tolist(),
        "quarters' medians", [round(float(np.median(ms[i * q:(i + 1) * q])), 3) for i in range(4)])
