"""Temporal (motion) transformer — the AnimateDiff motion module (port of
vdx/nn/temporal.py, the local mode: all frames on one device).

    GroupNorm (stats over frames and space jointly) -> proj_in (Linear)
      -> [B*H*W, F, C]          (each spatial position attends across frames)
      -> TemporalBlock x depth  (sinusoidal frame PE, double temporal
                                 self-attention, GEGLU ff)
    -> proj_out (Linear) -> +residual

Under PAB, ``refresh`` reaches both attentions of every block
(nn/attention.py). Frame-sharded execution (ring / Ulysses) waits for the
parallel slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.attention import Attention, FeedForward
from vdx_torch.nn.embeddings import sinusoidal_positional_encoding
from vdx_torch.nn.layers import Dense
from vdx_torch.nn.resnet import GroupNormModule
from vdx_torch.nn.transformer import LayerNormF32


class TemporalBlock(nn.Module):
    """BasicTransformerBlock with sinusoidal frame PE and double self-attn."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.dim = dim
        self.norm1 = LayerNormF32(dim, policy=policy)
        self.attn1 = Attention(dim, heads, head_dim, policy=policy)
        self.norm2 = LayerNormF32(dim, policy=policy)
        self.attn2 = Attention(dim, heads, head_dim, policy=policy)
        self.norm3 = LayerNormF32(dim, policy=policy)
        self.ff = FeedForward(dim, policy=policy)

    def forward(self, x: torch.Tensor, refresh=None,
                cache: Optional[dict] = None) -> torch.Tensor:  # [P, F, C]
        pe = sinusoidal_positional_encoding(x.shape[1], self.dim,
                                            x.device).to(x.dtype)
        x = x + self.attn1(self.norm1(x) + pe[None], refresh=refresh, cache=cache)
        x = x + self.attn2(self.norm2(x) + pe[None], refresh=refresh, cache=cache)
        return x + self.ff(self.norm3(x))


class TemporalTransformer3D(nn.Module):
    """Motion module. Input [B*F, H, W, C] + num_frames; same output."""

    def __init__(self, channels: int, heads: int = 8, depth: int = 1,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.norm = GroupNormModule(channels, math.gcd(32, channels), 1e-6,
                                    policy=policy)
        self.proj_in = Dense(channels, channels, policy=policy)
        self.transformer_blocks = nn.ModuleList([
            TemporalBlock(channels, heads, channels // heads, policy)
            for _ in range(depth)
        ])
        self.proj_out = Dense(channels, channels, policy=policy)

    def forward(self, x: torch.Tensor, num_frames: int, refresh=None,
                cache: Optional[dict] = None) -> torch.Tensor:
        BF, H, W, C = x.shape
        F_ = num_frames
        B = BF // F_
        residual = x
        h = self.norm(x.reshape(B, F_, H, W, C))  # GN stats over (F, H, W)
        h = h.permute(0, 2, 3, 1, 4).reshape(B * H * W, F_, C)
        h = self.proj_in(h)
        for blk in self.transformer_blocks:
            h = blk(h, refresh, cache)
        h = self.proj_out(h)
        h = h.reshape(B, H, W, F_, C).permute(0, 3, 1, 2, 4).reshape(BF, H, W, C)
        return h + residual
