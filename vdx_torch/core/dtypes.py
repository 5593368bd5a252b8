"""Dtype policy (mirror of vdx/core/dtypes.py's ``Policy``).

  * params     — stored in ``param_dtype``, cast to ``compute`` at use
  * compute    — bf16 for matmul/conv, fp32 accumulation
  * norms/softmax — fp32, cast back
  * scheduler math — always fp32
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy threaded through every module."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_to_norm(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.norm_dtype)

    def cast_to_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)


DEFAULT_POLICY = Policy()
# Full-fp32 policy: CPU parity tests, where bf16 rounding would swamp the
# comparison tolerance.
FP32_POLICY = Policy(compute_dtype=torch.float32)
# bf16 params and compute: the benchmark workload's policy (bench.py).
BF16_POLICY = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
