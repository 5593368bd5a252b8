"""ResNet / resampling blocks, channels-last (port of vdx/nn/resnet.py).

ResnetBlock2D: GN(32, eps)-SiLU-conv3x3 -> +time_emb(SiLU-Linear) ->
GN-SiLU-conv3x3 -> +skip (1x1 conv when channels change). Parameter
names follow diffusers (norm1, conv1, time_emb_proj, norm2, conv2,
conv_shortcut).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.layers import Conv2d, Dense
from vdx_torch.ops.groupnorm import group_norm, group_norm_silu


class GroupNormModule(nn.Module):
    """Affine GroupNorm holding ``weight``/``bias`` (vdx's scale/bias)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 with_silu: bool = False, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.with_silu = with_silu
        self.weight = nn.Parameter(torch.ones(channels, dtype=policy.param_dtype))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=policy.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = group_norm_silu if self.with_silu else group_norm
        return fn(x, self.num_groups, self.weight, self.bias, self.eps)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.norm1 = GroupNormModule(in_channels, groups, eps, True, policy)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, policy=policy)
        self.time_emb_proj = (
            None if temb_channels is None
            else Dense(temb_channels, out_channels, policy=policy))
        self.norm2 = GroupNormModule(out_channels, groups, eps, True, policy)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, policy=policy)
        self.conv_shortcut = (
            None if in_channels == out_channels
            else Conv2d(in_channels, out_channels, 1, policy=policy))

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            t = F.silu(temb.float()).to(self.policy.compute_dtype)
            h = h + self.time_emb_proj(t)[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """3x3 stride-2 conv after an asymmetric (0, 1) pad, as vdx."""

    def __init__(self, channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.conv = Conv2d(channels, out_channels, 3, stride=2, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest-neighbour 2x upsample + 3x3 conv."""

    def __init__(self, channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.conv = Conv2d(channels, out_channels, 3, padding=1, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)
