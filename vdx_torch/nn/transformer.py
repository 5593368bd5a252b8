"""Spatial transformer blocks, SD-1.5 Transformer2DModel semantics (port of
vdx/nn/transformer.py).

SpatialTransformer: GN(32, 1e-6) -> 1x1 proj_in -> [B, H*W, C] ->
BasicTransformerBlock (self-attn, text cross-attn, GEGLU ff) -> 1x1
proj_out -> +residual.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.attention import Attention, FeedForward
from vdx_torch.nn.layers import Conv2d
from vdx_torch.nn.resnet import GroupNormModule


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in fp32, output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__(dim, eps=eps, dtype=policy.param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.norm1 = LayerNormF32(dim, policy=policy)
        self.attn1 = Attention(dim, heads, head_dim, policy=policy)
        self.norm2 = LayerNormF32(dim, policy=policy)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim,
                               policy=policy)
        self.norm3 = LayerNormF32(dim, policy=policy)
        self.ff = FeedForward(dim, policy=policy)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Per-frame transformer over the flattened spatial axis.
    Input [B', H, W, C] (B' = batch*frames), context [B', 77, D]."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int = 768, depth: int = 1,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.norm = GroupNormModule(channels, 32, 1e-6, policy=policy)
        self.proj_in = Conv2d(channels, channels, 1, policy=policy)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, head_dim, context_dim, policy)
            for _ in range(depth)
        ])
        self.proj_out = Conv2d(channels, channels, 1, policy=policy)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        residual = x
        h = self.proj_in(self.norm(x)).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        return self.proj_out(h.reshape(B, H, W, C)) + residual
