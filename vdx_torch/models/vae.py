"""AutoencoderKL, SD-1.5 (port of vdx/models/vae.py's encoder and
decoder).

Block channels (128, 256, 512, 512), 2 layers per encoder block and 3 per
decoder block, GN(32, eps 1e-6), single-head mid attention, latent scaling
0.18215, 8x spatial down- and upsampling. Channels-last throughout. Each
encoder downsample pads (0, 1) and convolves 3x3 stride 2 VALID, the VAE's
own convention. Module names follow diffusers' AutoencoderKL (encoder.*,
quant_conv, post_quant_conv, decoder.*, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy, exact_fp32_method
from vdx_torch.nn.layers import Conv2d, Dense
from vdx_torch.nn.resnet import (Downsample2D, GroupNormModule, ResnetBlock2D,
                                 Upsample2D)
from vdx_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215

    @classmethod
    def sd15(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(32, 32, 64, 64), layers_per_block=1)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class VAEAttention(nn.Module):
    """Single-head self-attention over flattened space (VAE mid block)."""

    def __init__(self, channels: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.group_norm = GroupNormModule(channels, 32, 1e-6, policy=policy)
        self.to_q = Dense(channels, channels, policy=policy)
        self.to_k = Dense(channels, channels, policy=policy)
        self.to_v = Dense(channels, channels, policy=policy)
        self.to_out = nn.ModuleList([Dense(channels, channels, policy=policy)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        residual = x
        h = self.group_norm(x).reshape(B, H * W, C)
        q = self.to_q(h)[:, :, None, :]  # single head: [B, S, 1, C]
        k = self.to_k(h)[:, :, None, :]
        v = self.to_v(h)[:, :, None, :]
        o = dot_product_attention(q, k, v, scale=C ** -0.5)[:, :, 0, :]
        return self.to_out[0](o).reshape(B, H, W, C) + residual


class _Mid(nn.Module):
    def __init__(self, ch: int, policy: Policy):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, None, eps=1e-6, policy=policy)
            for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, policy)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, n_layers: int, upsample: bool,
                 policy: Policy):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else ch, ch, None, eps=1e-6,
                          policy=policy)
            for i in range(n_layers)])
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(ch, ch, policy)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, n_layers: int, downsample: bool,
                 policy: Policy):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else ch, ch, None, eps=1e-6,
                          policy=policy)
            for i in range(n_layers)])
        if downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(ch, ch, policy)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    """Images [B, H, W, 3] -> moments [B, h, w, 2 * latent] (mean ++
    logvar) before quant_conv."""

    def __init__(self, config: VAEConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = config
        chans = cfg.block_out_channels
        self.policy = policy
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1,
                              policy=policy)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for bi, ch in enumerate(chans):
            self.down_blocks.append(_DownBlock(prev, ch, cfg.layers_per_block,
                                               bi < len(chans) - 1, policy))
            prev = ch
        self.mid_block = _Mid(chans[-1], policy)
        self.conv_norm_out = GroupNormModule(chans[-1], 32, 1e-6,
                                             with_silu=True, policy=policy)
        self.conv_out = Conv2d(chans[-1], 2 * cfg.latent_channels, 3,
                               padding=1, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x.to(self.policy.compute_dtype))
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = config
        self.policy = policy
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1,
                              policy=policy)
        self.mid_block = _Mid(rev[0], policy)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for bi, ch in enumerate(rev):
            self.up_blocks.append(_UpBlock(prev, ch, cfg.layers_per_block + 1,
                                           bi < len(rev) - 1, policy))
            prev = ch
        self.conv_norm_out = GroupNormModule(rev[-1], 32, 1e-6, with_silu=True,
                                             policy=policy)
        self.conv_out = Conv2d(rev[-1], cfg.in_channels, 3, padding=1,
                               policy=policy)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        x = self.conv_out(self.conv_norm_out(x))
        return self.policy.cast_to_output(x)  # [-1, 1] image range


class AutoencoderKL(nn.Module):
    """The SD-1.5 VAE: ``encode`` for video2video, ``decode`` for every
    path."""

    def __init__(self, config: VAEConfig = VAEConfig(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.config = config
        self.policy = policy
        self.encoder = Encoder(config, policy)
        self.quant_conv = Conv2d(2 * config.latent_channels,
                                 2 * config.latent_channels, 1, policy=policy)
        self.post_quant_conv = Conv2d(config.latent_channels,
                                      config.latent_channels, 1, policy=policy)
        self.decoder = Decoder(config, policy)

    @exact_fp32_method
    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B, H, W, 3] in [-1, 1] -> [B, h, w, 2 * latent]: the
        posterior's mean ++ logvar, in the compute dtype."""
        return self.quant_conv(self.encoder(x))

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Images -> pre-scaled latents [B, h, w, latent]: the posterior
        mean times ``scaling_factor``, or with ``generator`` a sample
        mean + std * n (logvar clamped to [-30, 20], std in fp32)."""
        mean, logvar = self.encode_moments(x).chunk(2, dim=-1)
        if generator is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0).float())
            mean = mean + std * torch.randn(mean.shape, generator=generator,
                                            device=mean.device, dtype=std.dtype)
        return mean * self.config.scaling_factor

    @exact_fp32_method
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Pre-scaled latents [B, h, w, 4] -> images [B, H, W, 3] in [-1, 1]."""
        z = (z / self.config.scaling_factor).to(self.policy.compute_dtype)
        return self.decoder(self.post_quant_conv(z))
