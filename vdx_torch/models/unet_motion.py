"""UNetMotion — SD-1.5 UNet with interleaved AnimateDiff motion modules
(port of vdx/models/unet_motion.py).

Per-layer interleave: resnet -> spatial self-attn -> text cross-attn ->
motion module. Video enters as [B, F, H, W, C]; spatial stages run on the
flattened [B*F, H, W, C] view, motion modules re-fold to [B*H*W, F, C].
Module names follow diffusers' UNetMotionModel (down_blocks.i.resnets.j,
.attentions.j, .motion_modules.j, .downsamplers.0, mid_block, up_blocks,
...), so the weight rules in core/convert.py apply unchanged.

FreeU, PAB and frame-sharded temporal attention wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.embeddings import TimestepEmbedding, get_timestep_embedding
from vdx_torch.nn.layers import Conv2d
from vdx_torch.nn.resnet import (Downsample2D, GroupNormModule, ResnetBlock2D,
                                 Upsample2D)
from vdx_torch.nn.temporal import TemporalTransformer3D
from vdx_torch.nn.transformer import SpatialTransformer


@dataclasses.dataclass(frozen=True)
class UNetMotionConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8  # spatial heads; head_dim = C / heads
    motion_heads: int = 8
    motion_max_seq: int = 32
    transformer_depth: int = 1
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)

    @classmethod
    def sd15(cls) -> "UNetMotionConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "UNetMotionConfig":
        """Small config for CPU tests: same topology, 64x fewer params."""
        return cls(
            block_out_channels=(32, 64, 64, 64),
            layers_per_block=1,
            cross_attention_dim=64,
            attention_heads=2,
            motion_heads=2,
        )

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))


class _Stage(nn.Module):
    """One down/up block: resnets, optional attentions, motion modules and
    an optional resampler (diffusers' container names)."""

    def __init__(self, cfg: UNetMotionConfig, in_channels, channels: int,
                 has_attn: bool, n_layers: int, resampler, policy: Policy):
        super().__init__()
        temb = cfg.block_out_channels[0] * 4
        ins = in_channels if isinstance(in_channels, list) \
            else [in_channels] + [channels] * (n_layers - 1)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ins[i], channels, temb, policy=policy)
            for i in range(n_layers)])
        if has_attn:
            self.attentions = nn.ModuleList([
                SpatialTransformer(channels, cfg.attention_heads,
                                   channels // cfg.attention_heads,
                                   cfg.cross_attention_dim,
                                   cfg.transformer_depth, policy)
                for _ in range(n_layers)])
        else:
            self.attentions = None
        self.motion_modules = nn.ModuleList([
            TemporalTransformer3D(channels, cfg.motion_heads, policy=policy)
            for _ in range(n_layers)])
        if resampler == "down":
            self.downsamplers = nn.ModuleList(
                [Downsample2D(channels, channels, policy)])
        elif resampler == "up":
            self.upsamplers = nn.ModuleList(
                [Upsample2D(channels, channels, policy)])

    def layer(self, i, x, temb, context, num_frames):
        """One (resnet -> spatial -> cross -> motion) unit."""
        x = self.resnets[i](x, temb)
        if self.attentions is not None:
            x = self.attentions[i](x, context)
        return self.motion_modules[i](x, num_frames)


class _MidBlock(nn.Module):
    def __init__(self, cfg: UNetMotionConfig, policy: Policy):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, temb, policy=policy) for _ in range(2)])
        self.attentions = nn.ModuleList([
            SpatialTransformer(ch, cfg.attention_heads,
                               ch // cfg.attention_heads,
                               cfg.cross_attention_dim, cfg.transformer_depth,
                               policy)])
        self.motion_modules = nn.ModuleList([
            TemporalTransformer3D(ch, cfg.motion_heads, policy=policy)])


class UNetMotion(nn.Module):
    def __init__(self, config: UNetMotionConfig = UNetMotionConfig(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = config
        self.config = cfg
        self.policy = policy
        c0 = cfg.block_out_channels[0]
        n = len(cfg.block_out_channels)
        L = cfg.layers_per_block
        self.conv_in = Conv2d(cfg.in_channels, c0, 3, padding=1, policy=policy)
        self.time_embedding = TimestepEmbedding(c0, c0 * 4, policy)

        res_ch = [c0]
        self.down_blocks = nn.ModuleList()
        prev = c0
        for bi, ch in enumerate(cfg.block_out_channels):
            self.down_blocks.append(_Stage(
                cfg, prev, ch, cfg.down_block_has_attn[bi], L,
                "down" if bi < n - 1 else None, policy))
            res_ch += [ch] * L + ([ch] if bi < n - 1 else [])
            prev = ch

        self.mid_block = _MidBlock(cfg, policy)

        self.up_blocks = nn.ModuleList()
        for bi, ch in enumerate(reversed(cfg.block_out_channels)):
            ins = []
            for _ in range(L + 1):
                ins.append(prev + res_ch.pop())
                prev = ch
            self.up_blocks.append(_Stage(
                cfg, ins, ch, cfg.up_block_has_attn[bi], L + 1,
                "up" if bi < n - 1 else None, policy))

        self.conv_norm_out = GroupNormModule(c0, 32, 1e-5, with_silu=True,
                                             policy=policy)
        self.conv_out = Conv2d(c0, cfg.out_channels, 3, padding=1, policy=policy)

    def forward(self, sample: torch.Tensor, timestep: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """sample [B, F, H, W, C_in], timestep scalar or [B], context
        [B, S_text, D] -> [B, F, H, W, C_out] in the output dtype."""
        cfg = self.config
        cd = self.policy.compute_dtype
        B, F_, H, W, Cin = sample.shape
        x = sample.reshape(B * F_, H, W, Cin).to(cd)
        context = context.repeat_interleave(F_, dim=0).to(cd)

        t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        t = t.expand(B)
        temb = self.time_embedding(
            get_timestep_embedding(t, cfg.block_out_channels[0]))
        temb = temb.repeat_interleave(F_, dim=0)  # [B*F, 4*c0]

        x = self.conv_in(x)
        residuals = [x]
        for blk in self.down_blocks:
            for li in range(len(blk.resnets)):
                x = blk.layer(li, x, temb, context, F_)
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                residuals.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = mid.attentions[0](x, context)
        x = mid.motion_modules[0](x, F_)
        x = mid.resnets[1](x, temb)

        for blk in self.up_blocks:
            for li in range(len(blk.resnets)):
                x = torch.cat([x, residuals.pop()], dim=-1)
                x = blk.layer(li, x, temb, context, F_)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        x = self.policy.cast_to_output(x)
        return x.reshape(B, F_, H, W, cfg.out_channels)
