"""GroupNorm (+fused SiLU) over channels-last tensors (port of
vdx/ops/groupnorm.py).

torch ``nn.GroupNorm`` semantics: statistics per (batch, group) over all
remaining axes, in fp32 whatever the input dtype. eps is per call: 1e-5
in ResNet blocks, 1e-6 in transformer, motion and VAE GN.

Dispatch mirrors vdx: on the accelerator (here a CUDA tensor) the fused
kernels K2/K3 run (kernels/groupnorm.py, which raises on a shape neither
kernel takes); on the CPU the plain formulation below runs, as vdx runs
its XLA formulation off the TPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vdx_torch.kernels.groupnorm import group_norm_silu_cuda


def _group_norm_plain(x, num_groups, scale, bias, eps=1e-5):
    """Plain formulation (mean, then variance of the deviations)."""
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f"C={C} not divisible by {num_groups} groups")
    xg = x.float().reshape(*x.shape[:-1], num_groups, C // num_groups)
    axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, keepdim=True, unbiased=False)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _group_norm_silu_plain(x, num_groups, scale, bias, eps=1e-5):
    y = _group_norm_plain(x, num_groups, scale, bias, eps)
    return F.silu(y.float()).to(x.dtype)


def _dispatch(x, num_groups, scale, bias, eps, stats_axis_name, frame_mask,
              with_silu):
    if stats_axis_name is not None or frame_mask is not None:
        raise NotImplementedError(
            "stats_axis_name/frame_mask come with the parallel slice "
            "(ROADMAP Queue 1 item 14)")
    if x.device.type == "cuda":
        if scale is None or bias is None:
            raise ValueError("the CUDA GroupNorm kernels take scale and bias")
        return group_norm_silu_cuda(x, num_groups, scale, bias, eps, with_silu)
    ref = _group_norm_silu_plain if with_silu else _group_norm_plain
    return ref(x, num_groups, scale, bias, eps)


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
    stats_axis_name: Optional[str] = None,
    frame_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GroupNorm over a channels-last tensor [B, ..., C]: statistics span
    every axis but the batch and the group split of the last axis (for
    [B, F, H, W, C], frames and space jointly)."""
    return _dispatch(x, num_groups, scale, bias, eps, stats_axis_name,
                     frame_mask, False)


def group_norm_silu(
    x: torch.Tensor,
    num_groups: int,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
    stats_axis_name: Optional[str] = None,
    frame_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GroupNorm followed by SiLU — the UNet ResNet hot pattern."""
    return _dispatch(x, num_groups, scale, bias, eps, stats_axis_name,
                     frame_mask, True)
