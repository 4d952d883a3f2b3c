"""Mixed-precision policy (counterpart of construction_clip_tpu/core/precision.py).

Params may be stored in fp32; the policy names the dtype the model computes in
(fp32 or bf16) and the dtype of its outputs (features, logits). LayerNorm and
softmax statistics stay in fp32 whatever the compute dtype (ops/norms.py,
ops/attention.py).

fp32 here means full fp32: TF32 is switched off for matmuls and convolutions so
that an fp32 run on the card computes what the fp32 reference computes.
"""

from __future__ import annotations

import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        """Floating tensors of a nested dict cast to the compute dtype; a tensor
        already in that dtype is returned as it is (no copy)."""
        from construction_clip_tpu_torch.core.params import tree_map

        return tree_map(
            lambda x: x.to(self.compute_dtype)
            if isinstance(x, torch.Tensor) and x.is_floating_point() else x, tree)

    def cast_to_output(self, x):
        return x.to(self.output_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)


def policy_from_name(name: str) -> Policy:
    return {"float32": DEFAULT_POLICY, "fp32": DEFAULT_POLICY,
            "bfloat16": BF16_POLICY, "bf16": BF16_POLICY}[name]
