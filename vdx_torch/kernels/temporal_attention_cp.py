"""K9 — temporal attention with all-fp32 arithmetic (CUDA,
``csrc/temporal_attention.cu``).

Port of vdx/kernels/temporal_attention_cp.py ``temporal_attention_cp``:
per-position attention over the F frames of [P, F, H, D] tensors, with
the inputs taken to fp32, q * scale in fp32, the scores' softmax in base
e normalised before PV (p = e / sum e), PV in fp32, and one rounding to
q's dtype at the end. The TPU kernel's [F, C, P] layout (positions on
lanes) is a Mosaic layout choice, not part of the function; on Hopper K9
is the third mode of csrc/temporal_attention.cu, on its SIMT kernel (fp32
FMAs, q, k and v staged in their own dtype, scores register-blocked).

vdx's ``interpret`` argument (run the Pallas kernel in interpret mode) has
no meaning here: a CPU tensor takes the plain version, a CUDA tensor the
kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from vdx_torch.kernels.flash_attention import (check_temporal_shapes,
                                               launch_temporal)


def temporal_attention_cp_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *,
                                scale: float) -> torch.Tensor:
    """Plain PyTorch K9. [P, F, H, D] -> [P, F, H, D]."""
    s = torch.einsum("pfhd,pghd->phfg", q.float() * scale, k.float())
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("phfg,pghd->pfhd", p, v.float()).to(q.dtype)


def temporal_attention_cp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          block_p: int = 128) -> torch.Tensor:
    """K9: [P, F, H, D] q, k, v (bf16 or fp32) -> q's shape; ``scale``
    defaults to D ** -0.5.

    Raises where vdx asserts: P % block_p == 0, and D % 8 == 0 or
    H * D % 8 == 0 (plus one shape for q, k, v). ``block_p`` is the TPU
    kernel's tile of positions; the Hopper kernel needs none and keeps it
    only for that precondition. CUDA: one launch, F <= 32, D <= 160. CPU:
    the plain version.
    """
    check_temporal_shapes("K9", q, k, v)
    P, F, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if P % block_p:
        raise ValueError(f"K9 takes P % block_p == 0; got P={P}, "
                         f"block_p={block_p}")
    if D % 8 and (H * D) % 8:
        raise ValueError(f"K9 takes D % 8 == 0 or H * D % 8 == 0; got "
                         f"H={H}, D={D}")
    if q.device.type == "cpu":
        return temporal_attention_cp_plain(q, k, v, scale=scale)
    o = launch_temporal("cp", "K9 temporal_attention_cp", q, k, v, scale)
    temporal_attention_cp.launches += 1
    return o


temporal_attention_cp.launches = 0
