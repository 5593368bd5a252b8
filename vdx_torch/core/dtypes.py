"""Dtype policy (mirror of vdx/core/dtypes.py's ``Policy``).

  * params     — stored in ``param_dtype``, cast to ``compute`` at use
  * compute    — bf16 for matmul/conv, fp32 accumulation
  * norms/softmax — fp32, cast back
  * scheduler math — always fp32

fp32 compute is exact fp32 on the card too: :func:`exact_fp32` turns
TF32 off for cuBLAS and cuDNN while an fp32-policy call runs on CUDA
(PyTorch lets cuDNN convolve fp32 in TF32 by default), and gives the
user's settings back afterwards. bf16 calls leave the flags alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

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


@contextlib.contextmanager
def exact_fp32(policy: Policy, device):
    """While the block runs: if ``policy`` computes in fp32 and ``device``
    is CUDA, ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` are False; both are restored on
    exit. Otherwise nothing changes."""
    if policy.compute_dtype != torch.float32 \
            or torch.device(device).type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def exact_fp32_method(method):
    """Decorator for a module method whose first argument is a tensor:
    runs it under :func:`exact_fp32` with the module's ``policy`` and
    that tensor's device."""

    @functools.wraps(method)
    def wrapper(self, x, *args, **kwargs):
        with exact_fp32(self.policy, x.device):
            return method(self, x, *args, **kwargs)

    return wrapper
