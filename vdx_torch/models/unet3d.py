"""UNet3D — the ModelScope-class text-to-video denoiser (port of
vdx/models/unet3d.py).

Per layer:

    ResnetBlock2D (spatial) -> TemporalConv (3x1x1 conv stack over frames)
      -> SpatialTransformer (self + text cross-attn)
      -> TemporalTransformer3D (temporal attention)

plus a ``transformer_in`` temporal transformer right after conv_in, as
diffusers' UNet3DConditionModel. Heads are C // attention_head_dim (at
least one) with head dim C // heads: 64 at every level of the published
config. Video enters as [B, F, H, W, C]; spatial stages run on the
flattened [B*F, H, W, C] view. Module names follow diffusers
(down_blocks.i.resnets.j, .temp_convs.j, .attentions.j,
.temp_attentions.j, mid_block, up_blocks, transformer_in, ...), so vdx's
``unet3d_rules`` (core/convert.py) name every weight.

``attn_impl`` and ``freeu`` as UNetMotion's; under Pyramid Attention
Broadcast the forward takes ``pab_refresh`` and ``pab_cache`` and returns
(output, cache) (models/unet_motion.py): attn1 of a spatial block takes
"spatial", attn2 "cross", both attentions of a temporal transformer
(``transformer_in`` included) "temporal". Frame sharding:
``temporal_impl`` and ``frames_valid`` as UNetMotion's, reaching the two
cross-frame ops, TemporalConv (GN statistics over the global frame axis,
halo'd frame convs: nn/resnet.frame_conv_stage) and the temporal
transformers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy, exact_fp32_method
from vdx_torch.nn.attention import Attention
from vdx_torch.nn.embeddings import TimestepEmbedding, get_timestep_embedding
from vdx_torch.nn.freeu import FreeUConfig, apply_freeu
from vdx_torch.nn.layers import Conv2d, FrameConv
from vdx_torch.nn.resnet import (Downsample2D, GroupNormModule, ResnetBlock2D,
                                 Upsample2D, frame_conv_stage, frame_groups)
from vdx_torch.nn.temporal import TemporalTransformer3D
from vdx_torch.nn.transformer import SpatialTransformer


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64  # heads = C // head_dim (ModelScope style)
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)

    @classmethod
    def modelscope(cls) -> "UNet3DConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "UNet3DConfig":
        return cls(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                   cross_attention_dim=64, attention_head_dim=16)

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))


class TemporalConv(nn.Module):
    """ModelScope's TemporalConvLayer: four (GroupNorm-SiLU, conv (3,1,1))
    stages over [B, F, H, W, C] and a residual. The GroupNorm spans frames
    and space (eps 1e-5). conv{i} holds diffusers' (norm, activation,
    conv) slots 0 and 2; the SiLU is fused into the norm."""

    def __init__(self, channels: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        g = frame_groups(channels)
        for i in range(1, 5):
            setattr(self, f"conv{i}", nn.ModuleList([
                GroupNormModule(channels, g, 1e-5, with_silu=True, policy=policy),
                nn.Identity(), FrameConv(channels, channels, policy)]))

    def forward(self, x: torch.Tensor, num_frames: int,
                temporal_impl: str = "local",
                frames_valid: Optional[int] = None) -> torch.Tensor:
        BF, H, W, C = x.shape
        h = x.reshape(BF // num_frames, num_frames, H, W, C)
        for i in range(1, 5):
            norm, _, conv = getattr(self, f"conv{i}")
            h = frame_conv_stage(norm, conv, h, temporal_impl, frames_valid)
        return x + h.reshape(BF, H, W, C)


def _heads(cfg: UNet3DConfig, channels: int) -> int:
    return max(1, channels // cfg.attention_head_dim)


class _Stage(nn.Module):
    """One down/up block: resnets, temporal convs, optional spatial and
    temporal transformers, an optional resampler (diffusers' names)."""

    def __init__(self, cfg: UNet3DConfig, ins, channels: int, has_attn: bool,
                 n_layers: int, resampler, policy: Policy, attn_impl: str):
        super().__init__()
        temb = cfg.block_out_channels[0] * 4
        heads = _heads(cfg, channels)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ins[i], channels, temb, policy=policy)
            for i in range(n_layers)])
        self.temp_convs = nn.ModuleList([TemporalConv(channels, policy)
                                         for _ in range(n_layers)])
        if has_attn:
            self.attentions = nn.ModuleList([
                SpatialTransformer(channels, heads, channels // heads,
                                   cfg.cross_attention_dim, 1, policy, attn_impl)
                for _ in range(n_layers)])
            self.temp_attentions = nn.ModuleList([
                TemporalTransformer3D(channels, heads, policy=policy)
                for _ in range(n_layers)])
        else:
            self.attentions = self.temp_attentions = None
        if resampler == "down":
            self.downsamplers = nn.ModuleList(
                [Downsample2D(channels, channels, policy)])
        elif resampler == "up":
            self.upsamplers = nn.ModuleList(
                [Upsample2D(channels, channels, policy)])

    def layer(self, i, x, temb, context, num_frames, refresh=None, cache=None,
              **frames):
        """One (resnet -> temporal conv -> spatial -> temporal) unit."""
        r = refresh or {}
        x = self.resnets[i](x, temb)
        x = self.temp_convs[i](x, num_frames, **frames)
        if self.attentions is not None:
            x = self.attentions[i](x, context, r.get("spatial"), r.get("cross"),
                                   cache)
            x = self.temp_attentions[i](x, num_frames, r.get("temporal"), cache,
                                        **frames)
        return x


class UNet3D(nn.Module):
    def __init__(self, config: UNet3DConfig = UNet3DConfig(),
                 policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto",
                 freeu: Optional[FreeUConfig] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.policy = policy
        self.attn_impl = attn_impl
        self.freeu = freeu
        c0 = cfg.block_out_channels[0]
        n = len(cfg.block_out_channels)
        L = cfg.layers_per_block
        self.conv_in = Conv2d(cfg.in_channels, c0, 3, padding=1, policy=policy)
        self.time_embedding = TimestepEmbedding(c0, c0 * 4, policy)
        self.transformer_in = TemporalTransformer3D(c0, _heads(cfg, c0),
                                                    policy=policy)

        res_ch = [c0]
        self.down_blocks = nn.ModuleList()
        prev = c0
        for bi, ch in enumerate(cfg.block_out_channels):
            self.down_blocks.append(_Stage(
                cfg, [prev] + [ch] * (L - 1), ch, cfg.down_block_has_attn[bi],
                L, "down" if bi < n - 1 else None, policy, attn_impl))
            res_ch += [ch] * L + ([ch] if bi < n - 1 else [])
            prev = ch

        self.mid_block = _Stage(cfg, [prev, prev], prev, True, 1, None,
                                policy, attn_impl)
        # the mid block's second resnet and temporal conv (vdx's
        # mid_resnet_1 / mid_tconv_1: diffusers' resnets.1 / temp_convs.1)
        temb = c0 * 4
        self.mid_block.resnets.append(ResnetBlock2D(prev, prev, temb,
                                                    policy=policy))
        self.mid_block.temp_convs.append(TemporalConv(prev, policy))

        self.up_blocks = nn.ModuleList()
        for bi, ch in enumerate(reversed(cfg.block_out_channels)):
            ins = []
            for _ in range(L + 1):
                ins.append(prev + res_ch.pop())
                prev = ch
            self.up_blocks.append(_Stage(
                cfg, ins, ch, cfg.up_block_has_attn[bi], L + 1,
                "up" if bi < n - 1 else None, policy, attn_impl))

        self.conv_norm_out = GroupNormModule(c0, 32, 1e-5, with_silu=True,
                                             policy=policy)
        self.conv_out = Conv2d(c0, cfg.out_channels, 3, padding=1, policy=policy)
        for name, m in self.named_modules():
            if isinstance(m, Attention):
                m.pab_key = name

    @exact_fp32_method
    def forward(self, sample: torch.Tensor, timestep: torch.Tensor,
                context: torch.Tensor, *, pab_refresh: Optional[dict] = None,
                pab_cache: Optional[dict] = None,
                frames_valid: Optional[int] = None,
                temporal_impl: str = "local"):
        """sample [B, F, H, W, C_in], timestep scalar or [B], context
        [B, S_text, D] -> [B, F, H, W, C_out] in the output dtype; with
        ``pab_refresh``, -> (that, the PAB cache)."""
        cfg = self.config
        cd = self.policy.compute_dtype
        B, F_, H, W, Cin = sample.shape
        x = sample.reshape(B * F_, H, W, Cin).to(cd)
        context = context.repeat_interleave(F_, dim=0).to(cd)

        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(B)
        temb = self.time_embedding(
            get_timestep_embedding(t, cfg.block_out_channels[0]))
        temb = temb.repeat_interleave(F_, dim=0)  # [B*F, 4*c0]

        r = pab_refresh
        cache = None if r is None else ({} if pab_cache is None else pab_cache)
        rm = r or {}
        fr = dict(temporal_impl=temporal_impl, frames_valid=frames_valid)
        x = self.conv_in(x)
        x = self.transformer_in(x, F_, rm.get("temporal"), cache, **fr)
        residuals = [x]
        for blk in self.down_blocks:
            for li in range(len(blk.resnets)):
                x = blk.layer(li, x, temb, context, F_, r, cache, **fr)
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                residuals.append(x)

        mid = self.mid_block
        x = mid.layer(0, x, temb, context, F_, r, cache, **fr)
        x = mid.temp_convs[1](mid.resnets[1](x, temb), F_, **fr)

        for bi, blk in enumerate(self.up_blocks):
            for li in range(len(blk.resnets)):
                skip = residuals.pop()
                if self.freeu is not None:
                    x, skip = apply_freeu(bi, x, skip, self.freeu)
                x = torch.cat([x, skip], dim=-1)
                x = blk.layer(li, x, temb, context, F_, r, cache, **fr)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        x = self.policy.cast_to_output(x).reshape(B, F_, H, W, cfg.out_channels)
        return x if r is None else (x, cache)
