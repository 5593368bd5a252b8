"""UNetSpatioTemporal — Stable Video Diffusion's img2vid denoiser (port of
vdx/models/svd_unet.py).

  * every resnet is a pair: a spatial ResBlock, then a temporal ResBlock
    ((3, 1, 1) convs over frames, a per-frame time-embedding bias), blended
    by a learned sigmoid mix factor (``AlphaBlender``, in fp32)
  * every transformer is a pair: a spatial block with cross-attention to
    the CLIP image embedding [B, 1, 1024], then a temporal block over
    [B*H*W, F, C], alpha-blended likewise
  * the micro-conditions (fps, motion_bucket_id, noise_aug_strength) are
    sinusoid-embedded "added time ids" summed into the time embedding
  * the input is channel-concat(noisy latents, conditioning latents): 8

The frame-spanning GroupNorms (the temporal resblocks' tnorms) use eps
1e-5, the transformer's input norm 1e-6. Module names follow diffusers'
UNetSpatioTemporalConditionModel (resnets.j.spatial_res_block,
.temporal_res_block, .time_mixer; attentions.j.transformer_blocks.0,
.temporal_transformer_blocks.0, ...), so vdx's ``svd_unet_rules`` name
every weight. ``attn_impl``, ``freeu`` and PAB as UNetMotion's (the
temporal block takes "temporal"). Frame-sharded execution waits for
ROADMAP Queue 1 item 14.
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
from vdx_torch.nn.layers import Conv2d, Dense
from vdx_torch.nn.resnet import (AlphaBlender, Downsample2D, GroupNormModule,
                                 ResnetBlock2D, TemporalResBlock, Upsample2D,
                                 frame_groups)
from vdx_torch.nn.temporal import TemporalBlock
from vdx_torch.nn.transformer import BasicTransformerBlock


@dataclasses.dataclass(frozen=True)
class SVDUNetConfig:
    in_channels: int = 8  # 4 noisy + 4 conditioning latents
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    addition_time_embed_dim: int = 256
    num_added_time_ids: int = 3  # fps, motion_bucket_id, noise_aug
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)

    @classmethod
    def svd(cls) -> "SVDUNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SVDUNetConfig":
        return cls(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                   cross_attention_dim=64, attention_head_dim=16,
                   addition_time_embed_dim=32)

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels,
                                               temb_channels, policy=policy)
        self.temporal_res_block = TemporalResBlock(out_channels, temb_channels,
                                                   policy)
        self.time_mixer = AlphaBlender()

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                num_frames: int) -> torch.Tensor:
        s = self.spatial_res_block(x, temb)
        BF, H, W, C = s.shape
        h = s.reshape(BF // num_frames, num_frames, H, W, C)
        t = (h + self.temporal_res_block(h, temb)).reshape(BF, H, W, C)
        return self.time_mixer(s, t)


class TransformerSpatioTemporal(nn.Module):
    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, policy: Policy = DEFAULT_POLICY,
                 attn_impl: str = "auto"):
        super().__init__()
        C = channels
        self.norm = GroupNormModule(C, frame_groups(C), 1e-6, policy=policy)
        self.proj_in = Dense(C, C, policy=policy)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(C, heads, head_dim, context_dim, policy,
                                  attn_impl)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBlock(C, heads, head_dim, policy)])
        self.time_mixer = AlphaBlender()
        self.proj_out = Dense(C, C, policy=policy)

    def forward(self, x: torch.Tensor, context: torch.Tensor, num_frames: int,
                refresh: Optional[dict] = None,
                cache: Optional[dict] = None) -> torch.Tensor:
        r = refresh or {}
        BF, H, W, C = x.shape
        B, F_ = BF // num_frames, num_frames
        h = self.proj_in(self.norm(x))
        hs = self.transformer_blocks[0](h.reshape(BF, H * W, C), context,
                                        r.get("spatial"), r.get("cross"), cache)
        ht = hs.reshape(B, F_, H * W, C).transpose(1, 2).reshape(B * H * W, F_, C)
        ht = self.temporal_transformer_blocks[0](ht, r.get("temporal"), cache)
        ht = ht.reshape(B, H * W, F_, C).transpose(1, 2).reshape(BF, H * W, C)
        h = self.time_mixer(hs, ht).reshape(BF, H, W, C)
        return self.proj_out(h) + x


class _Stage(nn.Module):
    """One down/up block (diffusers' names)."""

    def __init__(self, cfg: SVDUNetConfig, ins, channels: int, has_attn: bool,
                 n_layers: int, resampler, policy: Policy, attn_impl: str):
        super().__init__()
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(ins[i], channels, temb, policy)
            for i in range(n_layers)])
        if has_attn:
            heads = max(1, channels // cfg.attention_head_dim)
            self.attentions = nn.ModuleList([
                TransformerSpatioTemporal(channels, heads, channels // heads,
                                          cfg.cross_attention_dim, policy,
                                          attn_impl)
                for _ in range(n_layers)])
        else:
            self.attentions = None
        if resampler == "down":
            self.downsamplers = nn.ModuleList(
                [Downsample2D(channels, channels, policy)])
        elif resampler == "up":
            self.upsamplers = nn.ModuleList(
                [Upsample2D(channels, channels, policy)])

    def layer(self, i, x, temb, context, num_frames, refresh=None, cache=None):
        x = self.resnets[i](x, temb, num_frames)
        if self.attentions is not None:
            x = self.attentions[i](x, context, num_frames, refresh, cache)
        return x


class UNetSpatioTemporal(nn.Module):
    def __init__(self, config: SVDUNetConfig = SVDUNetConfig(),
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
        self.add_embedding = TimestepEmbedding(
            cfg.num_added_time_ids * cfg.addition_time_embed_dim, c0 * 4, policy)

        res_ch = [c0]
        self.down_blocks = nn.ModuleList()
        prev = c0
        for bi, ch in enumerate(cfg.block_out_channels):
            self.down_blocks.append(_Stage(
                cfg, [prev] + [ch] * (L - 1), ch, cfg.down_block_has_attn[bi],
                L, "down" if bi < n - 1 else None, policy, attn_impl))
            res_ch += [ch] * L + ([ch] if bi < n - 1 else [])
            prev = ch

        # vdx's mid_0 layer (resnet + transformer) and mid_res_1
        self.mid_block = _Stage(cfg, [prev], prev, True, 1, None, policy,
                                attn_impl)
        self.mid_block.resnets.append(
            SpatioTemporalResBlock(prev, prev, c0 * 4, policy))

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
                image_embeds: torch.Tensor, added_time_ids: torch.Tensor, *,
                pab_refresh: Optional[dict] = None,
                pab_cache: Optional[dict] = None):
        """sample [B, F, H, W, 8], timestep scalar or [B] (EDM's continuous
        t), image_embeds [B, 1, cross_dim], added_time_ids [B, 3] ->
        [B, F, H, W, 4] in the output dtype; with ``pab_refresh``, ->
        (that, the PAB cache)."""
        cfg = self.config
        cd = self.policy.compute_dtype
        B, F_, H, W, Cin = sample.shape
        x = sample.reshape(B * F_, H, W, Cin).to(cd)
        context = image_embeds.repeat_interleave(F_, dim=0).to(cd)

        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(B)
        temb = self.time_embedding(
            get_timestep_embedding(t, cfg.block_out_channels[0]))
        # micro-conditioning: each added id sinusoid-embedded, flattened,
        # projected and added
        a_emb = get_timestep_embedding(added_time_ids.reshape(-1),
                                       cfg.addition_time_embed_dim)
        a_emb = a_emb.reshape(B, cfg.num_added_time_ids * cfg.addition_time_embed_dim)
        temb = (temb + self.add_embedding(a_emb)).repeat_interleave(F_, dim=0)

        r = pab_refresh
        cache = None if r is None else ({} if pab_cache is None else pab_cache)
        x = self.conv_in(x)
        residuals = [x]
        for blk in self.down_blocks:
            for li in range(len(blk.resnets)):
                x = blk.layer(li, x, temb, context, F_, r, cache)
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                residuals.append(x)

        mid = self.mid_block
        x = mid.layer(0, x, temb, context, F_, r, cache)
        x = mid.resnets[1](x, temb, F_)

        for bi, blk in enumerate(self.up_blocks):
            for li in range(len(blk.resnets)):
                skip = residuals.pop()
                if self.freeu is not None:
                    x, skip = apply_freeu(bi, x, skip, self.freeu)
                x = torch.cat([x, skip], dim=-1)
                x = blk.layer(li, x, temb, context, F_, r, cache)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        x = self.policy.cast_to_output(x).reshape(B, F_, H, W, cfg.out_channels)
        return x if r is None else (x, cache)
