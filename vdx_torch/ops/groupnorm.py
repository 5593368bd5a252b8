"""GroupNorm (+fused SiLU) over channels-last tensors (port of
vdx/ops/groupnorm.py).

torch ``nn.GroupNorm`` semantics: statistics per (batch, group) over all
remaining axes, in fp32 whatever the input dtype. eps is per call: 1e-5
in ResNet blocks, 1e-6 in transformer, motion and VAE GN.

Dispatch mirrors vdx: on the accelerator (here a CUDA tensor) the fused
kernels K2/K3 run (kernels/groupnorm.py, which raises on a shape neither
kernel takes); on the CPU the plain formulation below runs, as vdx runs
its XLA formulation off the TPU.

Under autograd (grad enabled and an input that requires grad) a CUDA
call goes through :class:`GroupNormFn`: the kernel runs the forward and
the backward is the plain formulation's VJP at the saved x, scale and
bias, as vdx's ``_gn_pallas`` custom VJP (its Pallas kernel is
forward-only, its backward the XLA formulation's VJP).

Under frame sharding the statistics span the global frame axis:
``stats_axis_name`` averages the local moments over a bound mesh axis
(parallel/mesh.pmean), ``frame_mask`` ([F] bool over axis 1) leaves
padded frame slots out of masked sums whose count is summed with them
(per-shard real counts differ, so a mean of means would be wrong). vdx
sends both forms to its XLA formulation, never to its Pallas kernels
(vdx/ops/groupnorm.py:129-145); the port sends them to the plain
formulation on every device. That is vdx's routing, not a missing kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vdx_torch.kernels.groupnorm import group_norm_silu_cuda
from vdx_torch.parallel.mesh import pmean, psum


def _group_norm_plain(x, num_groups, scale, bias, eps=1e-5,
                      stats_axis_name=None, frame_mask=None):
    """Plain formulation (mean, then variance of the deviations); the
    sharded forms as vdx's (E[x^2] - mean^2 of the global moments)."""
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f"C={C} not divisible by {num_groups} groups")
    xg = x.float().reshape(*x.shape[:-1], num_groups, C // num_groups)
    axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    if frame_mask is not None:
        w = frame_mask.float().reshape((1, -1) + (1,) * (xg.dim() - 2))
        per_frame = 1
        for a in axes:
            if a != 1:
                per_frame *= xg.shape[a]
        cnt = w.sum().reshape(1) * per_frame
        s1 = (xg * w).sum(dim=axes, keepdim=True)
        s2 = (xg * xg * w).sum(dim=axes, keepdim=True)
        if stats_axis_name is not None:
            s1, s2, cnt = psum((s1, s2, cnt), stats_axis_name)
        mean = s1 / cnt
        var = s2 / cnt - mean * mean
    elif stats_axis_name is not None:
        mean, sq = pmean((xg.mean(dim=axes, keepdim=True),
                          (xg * xg).mean(dim=axes, keepdim=True)),
                         stats_axis_name)
        var = sq - mean * mean
    else:
        mean = xg.mean(dim=axes, keepdim=True)
        var = xg.var(dim=axes, keepdim=True, unbiased=False)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _group_norm_silu_plain(x, num_groups, scale, bias, eps=1e-5,
                           stats_axis_name=None, frame_mask=None):
    y = _group_norm_plain(x, num_groups, scale, bias, eps, stats_axis_name,
                          frame_mask)
    return F.silu(y.float()).to(x.dtype)


class GroupNormFn(torch.autograd.Function):
    """K2/K3 under autograd (vdx's ``_gn_pallas``): the forward is the
    kernel dispatch (``group_norm_silu_cuda``, looked up at each call),
    the backward recomputes :func:`_group_norm_plain` or
    :func:`_group_norm_silu_plain` on the saved inputs and returns its
    VJP, each gradient in its input's dtype. ``backward_calls`` counts
    backward passes."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, with_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, with_silu)
        return group_norm_silu_cuda(x, num_groups, scale, bias, eps, with_silu)

    @staticmethod
    def backward(ctx, g):
        GroupNormFn.backward_calls += 1
        num_groups, eps, with_silu = ctx.cfg
        ref = _group_norm_silu_plain if with_silu else _group_norm_plain
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(bool(n))
                   for t, n in zip(ctx.saved_tensors, needs)]
            y = ref(ins[0], num_groups, ins[1], ins[2], eps)
            got = iter(torch.autograd.grad(
                y, [t for t in ins if t.requires_grad], g))
        return (*(next(got) if n else None for n in needs), None, None, None)


def _dispatch(x, num_groups, scale, bias, eps, stats_axis_name, frame_mask,
              with_silu):
    ref = _group_norm_silu_plain if with_silu else _group_norm_plain
    if stats_axis_name is not None or frame_mask is not None:
        # vdx's routing: the sharded forms never reach the kernels
        return ref(x, num_groups, scale, bias, eps, stats_axis_name, frame_mask)
    if x.device.type == "cuda":
        if scale is None or bias is None:
            raise ValueError("the CUDA GroupNorm kernels take scale and bias")
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                        or bias.requires_grad):
            return GroupNormFn.apply(x, scale, bias, num_groups, eps, with_silu)
        return group_norm_silu_cuda(x, num_groups, scale, bias, eps, with_silu)
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
    [B, F, H, W, C], frames and space jointly). ``stats_axis_name``: the
    mesh axis the reduction axes are sharded over (the moments are
    averaged across it); ``frame_mask``: [F] bool over axis 1, the real
    frame slots of a padded frame axis (see the module docstring)."""
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
