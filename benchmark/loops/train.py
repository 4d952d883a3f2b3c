"""The contrastive fine-tune step loop of `apps/train_clip.fit`, as its user
runs it on one card.

Set-up makes the weights from the seed as a trainable `ParamTree`, the
step `train/contrastive.make_train_step` with `train/state.make_adamw` in
the traffic's precision, its `TrainState`, and a pool of staged uint8 batches
with their token ids in pinned host memory. Each step copies its batch to the
card without blocking, as `TorchImageTextLoader` does, runs
`data/preprocess.preprocess_batch` and the step, and reads the loss and
accuracy every `log_every` steps, as `fit` does.

The first `check_steps` steps run in set-up through the window's own call and
feed, on distinct batches; the same object then runs the window. The check
holds them to the reference's steps from the same weights and batches: each
step's loss, the first gradient's norm leaf by leaf (read from AdamW's first
moment after one step), and each leaf's change over the steps.
"""

from __future__ import annotations

import gc
import statistics

import torch

import trace as tracing
import weights
from work import clip_plan
from harness import Clock, clip_config, free_cuda, reference_module, sync

# a leaf whose reference gradient is below this share of the median leaf's is
# moved by AdamW's normalisation of rounding alone: its change is not compared
GRAD_FLOOR = 1e-3


def _norms(tree, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().float())) * scale
            for k, v in weights.units(tree)}


def _nest(flat: dict) -> dict:
    tree = {}
    for path, value in flat.items():
        node = tree
        keys = path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree


class Run:
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, trace: bool):
        from construction_clip_tpu_torch.core.params import ParamTree, as_tree
        from construction_clip_tpu_torch.core.precision import policy_from_name
        from construction_clip_tpu_torch.data.preprocess import preprocess_batch
        from construction_clip_tpu_torch.train.contrastive import make_train_step
        from construction_clip_tpu_torch.train.state import TrainState, make_adamw

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.cuda = device.type == "cuda"
        self._preprocess = preprocess_batch
        clock = Clock(self.cuda)
        opt = traffic["optimizer"]
        params = ParamTree(weights.clip_params(cfg, seed, device), trainable=True)
        tx = make_adamw(opt["lr"], warmup_steps=opt["warmup_steps"],
                        total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
                        b1=opt["b1"], b2=opt["b2"], eps=opt["eps"])
        self.step = make_train_step(clip_config(cfg), tx,
                                    policy=policy_from_name(traffic["precision"]), device=device)
        self.state = TrainState.create(params, tx)
        clock.lap("weights and optimizer state")
        b, s, t = traffic["batch"], traffic["stage_size"], cfg["text"]
        gi = weights.generator(seed, weights.IMAGES, device)
        gt = weights.generator(seed, weights.TOKENS, device)
        self.pool = []
        for _ in range(traffic["pool_batches"]):
            batch = {"images": weights.images_u8(b, s, gi, device).cpu(),
                     "tokens": weights.token_ids(b, t["context_length"], t["vocab_size"],
                                                 traffic["eot"], gt, device).cpu()}
            self.pool.append({k: v.pin_memory() if self.cuda else v for k, v in batch.items()})
        clock.lap("input pool")
        self.steps = 0
        self.program = {"loss": []}
        for _ in range(traffic["check_steps"]):
            m = self._unit()
            self.program["loss"].append(float(m["loss"].detach()))
            if self.steps == 1:
                self.program["grad_norm"] = _norms(self.state.opt_state["m"], 1 / (1 - opt["b1"]))
        clock.lap(f"{traffic['check_steps']} checked steps")
        start = weights.clip_params(cfg, seed, device)
        now = dict(weights.leaf_items(as_tree(self.state.params)))
        with torch.no_grad():
            moved = {k: now[k].detach() - v for k, v in weights.leaf_items(start)}
        self.program["change_norm"] = _norms(_nest(moved))
        del start, now, moved
        clock.lap("change norms")
        if trace:
            tracing.warm()
        sync(self.cuda)
        clock.lap("profiler")
        clock.report()

    def _unit(self):
        host = self.pool[self.steps % len(self.pool)]
        batch = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
        images = self._preprocess(batch["images"], self.cfg["vision"]["image_size"])
        self.state, m = self.step(self.state, {"images": images, "tokens": batch["tokens"]})
        self.steps += 1
        return m

    def _logged(self) -> None:
        m = self._unit()
        if self.state.step % self.traffic["log_every"] == 0:
            float(m["loss"].detach()), float(m["accuracy"])

    def window(self, seconds: float, trace: bool):
        t = self.traffic
        sync(self.cuda)
        before = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        record = tracing.drive(self._logged, seconds, self.cuda,
                               t["trace_steps"] if trace else 0)
        peak = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0
        self.memory_peak = max(before, peak)
        vars(record).update(
            kind=self.kind, cfg=self.cfg, traffic=t, done=record.units * t["batch"],
            peak_window_bytes=peak,
            calls=clip_plan.plan(self.cfg, t, ("vision", "text"), True),
            trace=record.stretch.read() if record.stretch else None, stretch=None)
        return record

    def free(self) -> None:
        self.state = self.step = None
        gc.collect()
        free_cuda(self.cuda)

    def reference(self, mode: str) -> dict:
        """The reference's readings of the first check_steps steps in `mode`."""
        ref = reference_module(self.cfg)
        params = weights.clip_params(self.cfg, self.seed, self.device)
        leaves = dict(weights.leaf_items(params))
        for p in leaves.values():
            p.requires_grad_(True)
        opt = self.traffic["optimizer"]
        adamw = ref.AdamW(opt["lr"], opt["warmup_steps"], opt["total_steps"],
                          opt["weight_decay"], opt["b1"], opt["b2"], opt["eps"])
        batches = [(self.pool[i]["images"].to(self.device), self.pool[i]["tokens"].to(self.device))
                   for i in range(self.traffic["check_steps"])]
        out = ref.train_readings(params, leaves, self.cfg, batches, adamw, mode,
                                 self.traffic["ref_rows"], weights.units)
        del params, leaves, adamw, batches
        gc.collect()
        free_cuda(self.cuda)
        return out

    @staticmethod
    def readings(got: dict, want: dict) -> dict:
        """loss_gap: the largest |loss - reference| over the steps, as a share
        of the reference's; grad_gap and change_gap: the largest gap between a
        leaf's norm and the reference's, as a share of the larger of the
        reference's norm of that leaf and of the median leaf."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))

        def gap(a: dict, b: dict, keys) -> float:
            med = statistics.median(b[k] for k in keys)
            return max(abs(a[k] - b[k]) / max(b[k], med) for k in keys)

        g = want["grad_norm"]
        med = statistics.median(g.values())
        moved = [k for k in g if g[k] >= GRAD_FLOOR * med]
        return {"loss_gap": loss_gap, "grad_gap": gap(got["grad_norm"], g, list(g)),
                "change_gap": gap(got["change_norm"], want["change_norm"], moved)}

    def check(self) -> dict:
        self.free()
        self.want = self.reference("fp32")
        return self.readings(self.program, self.want)

    def control(self, mode: str) -> dict:
        """The reference in `mode` put in the program's place (after check)."""
        return self.readings(self.reference(mode), self.want)
