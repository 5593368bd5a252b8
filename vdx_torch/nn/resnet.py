"""ResNet / resampling blocks, channels-last (port of vdx/nn/resnet.py).

ResnetBlock2D: GN(32, eps)-SiLU-conv3x3 -> +time_emb(SiLU-Linear) ->
GN-SiLU-conv3x3 -> +skip (1x1 conv when channels change). Parameter
names follow diffusers (norm1, conv1, time_emb_proj, norm2, conv2,
conv_shortcut).

The frame-spanning pieces that the SVD UNet, ModelScope's UNet3D and the
temporal VAE decoder share: ``frame_groups``, ``TemporalResBlock`` (the
(3, 1, 1) resblock over [B, F, H, W, C]) and ``AlphaBlender`` (the
learned sigmoid blend of a spatial and a temporal branch).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.layers import Conv2d, Dense, FrameConv
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


def frame_groups(channels: int) -> int:
    """GroupNorm groups of the frame-spanning norms: 32 where they divide
    the channels, else min(C, 8) (vdx's TemporalConv and temporal
    resblocks)."""
    return 32 if channels % 32 == 0 else min(channels, 8)


class AlphaBlender(nn.Module):
    """Learned sigmoid blend of two branches, in fp32, cast to the first
    branch's dtype: alpha * a + (1 - alpha) * b, alpha = sigmoid(mix).
    ``mix_factor`` is fp32 whatever the policy (vdx's param)."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.empty(1, dtype=torch.float32))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        return (alpha * a.float() + (1.0 - alpha) * b.float()).to(a.dtype)


class TemporalResBlock(nn.Module):
    """The (3, 1, 1) resblock over [B, F, H, W, C]: GN-SiLU, frame conv,
    a per-frame time-embedding bias (when ``temb_channels``), GN-SiLU,
    frame conv. GN eps 1e-5 over frames and space."""

    def __init__(self, channels: int, temb_channels: Optional[int],
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        g = frame_groups(channels)
        self.policy = policy
        self.norm1 = GroupNormModule(channels, g, 1e-5, True, policy)
        self.conv1 = FrameConv(channels, channels, policy)
        self.time_emb_proj = (None if temb_channels is None
                              else Dense(temb_channels, channels, policy=policy))
        self.norm2 = GroupNormModule(channels, g, 1e-5, True, policy)
        self.conv2 = FrameConv(channels, channels, policy)

    def forward(self, h: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h [B, F, H, W, C], temb [B*F, D] -> the branch (no residual)."""
        t = self.conv1(self.norm1(h))
        if self.time_emb_proj is not None and temb is not None:
            te = F.silu(temb.float()).to(self.policy.compute_dtype)
            B, F_ = h.shape[:2]
            t = t + self.time_emb_proj(te).reshape(B, F_, 1, 1, -1)
        return self.conv2(self.norm2(t))
