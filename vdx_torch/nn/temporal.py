"""Temporal (motion) transformer — the AnimateDiff motion module (port of
vdx/nn/temporal.py).

    GroupNorm (stats over frames and space jointly) -> proj_in (Linear)
      -> [B*H*W, F, C]          (each spatial position attends across frames)
      -> TemporalBlock x depth  (sinusoidal frame PE, double temporal
                                 self-attention, GEGLU ff)
    -> proj_out (Linear) -> +residual

Under PAB, ``refresh`` reaches both attentions of every block
(nn/attention.py).

Frame sharding (``temporal_impl``, vdx's names; the same weights run
sharded or not). Inside a ``Mesh.bind()`` the frame axis of every tensor
is this rank's shard, and only the cross-frame ops communicate:

  * ``"ring:<axis>"`` — ring attention: the local queries stay, the KV
    blocks rotate around the mesh axis (parallel/ring_attention.py);
  * ``"ulysses:<axis>"`` — two tiled all_to_alls swap [P, F_local, C] to
    [P/n, F_global, C] around the whole TemporalBlock, which then runs
    the local program; a site whose positions P do not divide the axis
    falls back to the ring (a static per-site choice; both are exact).

In both modes the GroupNorm statistics span the global frame axis and the
frame PE takes global frame positions. Ragged frames (``frames_valid``,
the global count of real frames in a zero-padded frame axis): the padded
slots are masked out of the GN statistics and out of every softmax (the
ring's ``kv_valid``), and where the whole frame axis is on the device the
block slices it to the real frames, runs, and zero-fills the rest. The
site's rule lives in nn/frame_shard.py, which Latte's temporal blocks
share.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.attention import Attention, FeedForward
from vdx_torch.nn.frame_shard import (frame_stats, global_frame_pe,
                                      run_temporal_site)
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
                cache: Optional[dict] = None, temporal_impl: str = "local",
                frames_valid: Optional[int] = None) -> torch.Tensor:  # [P, F, C]
        def body(x, axis, kv_valid):
            pe = global_frame_pe(x.shape[1], self.dim, axis, x.device)
            pe = pe.to(x.dtype)[None]
            attn = dict(impl=None if axis is None else f"ring:{axis}",
                        kv_valid=kv_valid)
            x = x + self.attn1(self.norm1(x) + pe, refresh=refresh,
                               cache=cache, **attn)
            x = x + self.attn2(self.norm2(x) + pe, refresh=refresh,
                               cache=cache, **attn)
            return x + self.ff(self.norm3(x))

        return run_temporal_site(body, x, temporal_impl, frames_valid)


class TemporalTransformer3D(nn.Module):
    """Motion module. Input [B*F, H, W, C] + num_frames (the local count
    under frame sharding); same output."""

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
                cache: Optional[dict] = None, temporal_impl: str = "local",
                frames_valid: Optional[int] = None) -> torch.Tensor:
        BF, H, W, C = x.shape
        F_ = num_frames
        B = BF // F_
        residual = x
        # GN stats over (F, H, W): the global frame axis when sharded
        h = self.norm(x.reshape(B, F_, H, W, C),
                      *frame_stats(temporal_impl, F_, frames_valid, x.device))
        h = h.permute(0, 2, 3, 1, 4).reshape(B * H * W, F_, C)
        h = self.proj_in(h)
        for blk in self.transformer_blocks:
            h = blk(h, refresh, cache, temporal_impl, frames_valid)
        h = self.proj_out(h)
        h = h.reshape(B, H, W, F_, C).permute(0, 3, 1, 2, 4).reshape(BF, H, W, C)
        return h + residual
