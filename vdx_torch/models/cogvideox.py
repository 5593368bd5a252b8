"""CogVideoX: the joint-attention 3D DiT and the 3D causal VAE (port of
vdx/models/cogvideox.py), BASELINE.json configs[3].

DiT: ONE full attention over the joint sequence [text ++ every video patch
token] per block (biased q/k/v, a per-head LayerNorm on q and k, optional
3D RoPE with identity rows on the text), "expert" adaLN (one SiLU + Linear
gives shift/scale/gate for the video and for the text segment, one shared
affine LayerNorm, eps 1e-5, normalises both), one shared tanh-GELU
feed-forward over the joint sequence. The timestep sinusoid is at the
model width, then a TimestepEmbedding down to ``time_embed_dim``. The 2B
model (``b2()``) adds the summed factorised sinusoidal PE instead of RoPE.
The final LayerNorm runs over the joint sequence, then adaLN on the video
part. Parameter names follow diffusers' CogVideoXTransformer3DModel.

Causal VAE: (3, 3, 3) convolutions padded causally in time (kt - 1 frames
before, none after) and by kh // 2, kw // 2 in space, all with the EDGE
value (vdx pads ``mode="edge"``), so frame t never sees t + 1. GroupNorms
(eps 1e-6, SiLU) span frames and space; 32 groups where both channel
counts divide by 32, else min(C, 8). The decoder upsamples by repeating
pixels (x2 in H and W, x2 in F where ``temporal_downsample`` says so), so
13 latent frames decode to 52. Parameter names follow diffusers'
AutoencoderKLCogVideoX where vdx's rules map them (``encoder.*`` and
``decoder.*``; the decoder's output norm is ``norm_out.norm_layer``).

Under PAB the DiT's forward takes ``pab_refresh`` (its "joint" flag) and
``pab_cache`` and returns (output, cache), as UNetMotion's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy, exact_fp32_method
from vdx_torch.nn.attention import Attention, GELUFeedForward
from vdx_torch.nn.embeddings import (TimestepEmbedding, get_timestep_embedding,
                                     rope_3d, sinusoidal_positional_encoding)
from vdx_torch.nn.layers import Dense, PatchConv
from vdx_torch.nn.resnet import GroupNormModule


# ======================================================================
# DiT
# ======================================================================


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    hidden_size: int = 1920
    depth: int = 30
    num_heads: int = 30
    text_dim: int = 4096
    max_text_len: int = 226
    mlp_ratio: int = 4
    time_embed_dim: int = 512
    #: 3D RoPE over the (F, h, w) token grid (CogVideoX-1.5/5B); False is
    #: the 2B checkpoint's summed factorised sinusoidal PE
    use_rotary: bool = True

    @classmethod
    def b2(cls) -> "CogVideoXConfig":
        return cls(use_rotary=False)

    @classmethod
    def v1_5(cls) -> "CogVideoXConfig":
        return cls(hidden_size=3072, depth=42, num_heads=48, use_rotary=True)

    @classmethod
    def tiny(cls) -> "CogVideoXConfig":
        return cls(hidden_size=64, depth=2, num_heads=2, text_dim=64,
                   max_text_len=8)


class _AffineLN(nn.LayerNorm):
    """Affine LayerNorm in fp32 with an fp32 result (flax's
    ``LayerNorm(dtype=float32)``)."""

    def __init__(self, dim: int, eps: float, policy: Policy):
        super().__init__(dim, eps=eps, dtype=policy.param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


def _scale_shift(x32, scale, shift, dtype):
    """fp32 ``x32 * (1 + scale) + shift``, 1 + scale in scale's dtype as
    vdx adds a Python 1.0, rounded to ``dtype``."""
    return (x32 * (1 + scale).float() + shift.float()).to(dtype)


class CogVideoXLayerNormZero(nn.Module):
    """Expert adaLN: SiLU + Linear -> six chunks (shift, scale, gate of the
    video, then of the text), one shared affine LayerNorm (eps 1e-5)."""

    def __init__(self, cond_dim: int, dim: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.linear = Dense(cond_dim, 6 * dim, policy=policy)
        self.norm = _AffineLN(dim, 1e-5, policy)

    def forward(self, vid, txt, c):
        h = F.silu(c.float()).to(self.policy.compute_dtype)
        mod = self.linear(h)[:, None, :]
        shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
        vid = _scale_shift(self.norm(vid), scale, shift, mod.dtype)
        txt = _scale_shift(self.norm(txt), e_scale, e_shift, mod.dtype)
        return vid, txt, gate, e_gate


class CogVideoXBlock(nn.Module):
    """Joint text+video attention block with expert adaLN."""

    def __init__(self, cfg: CogVideoXConfig, policy: Policy = DEFAULT_POLICY,
                 attn_impl: str = "auto"):
        super().__init__()
        D = cfg.hidden_size
        self.norm1 = CogVideoXLayerNormZero(cfg.time_embed_dim, D, policy)
        self.attn1 = Attention(D, cfg.num_heads, D // cfg.num_heads,
                               policy=policy, attn_impl=attn_impl,
                               qkv_bias=True, qk_norm=True)
        self.norm2 = CogVideoXLayerNormZero(cfg.time_embed_dim, D, policy)
        self.ff = GELUFeedForward(D, cfg.mlp_ratio, policy)

    def forward(self, vid, txt, c, rope=None, refresh=None, cache=None):
        S_txt = txt.shape[1]
        hv, ht, gate, e_gate = self.norm1(vid, txt, c)
        out = self.attn1(torch.cat([ht, hv], dim=1), None, refresh, cache, rope)
        vid = vid + gate * out[:, S_txt:]
        txt = txt + e_gate * out[:, :S_txt]
        hv, ht, gate, e_gate = self.norm2(vid, txt, c)
        h = self.ff(torch.cat([ht, hv], dim=1))
        return vid + gate * h[:, S_txt:], txt + e_gate * h[:, :S_txt]


class CogVideoXDiT(nn.Module):
    def __init__(self, config: CogVideoXConfig = CogVideoXConfig(),
                 policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto",
                 freeu=None):
        super().__init__()
        if freeu is not None:
            raise ValueError("CogVideoXDiT has no skip-connection up path — "
                             "FreeU does not apply")
        cfg = config
        self.config = cfg
        self.policy = policy
        D, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = PatchConv(cfg.in_channels, D, p, policy)
        self.patch_embed.text_proj = Dense(cfg.text_dim, D, policy=policy)
        self.time_embedding = TimestepEmbedding(D, cfg.time_embed_dim, policy)
        self.transformer_blocks = nn.ModuleList([
            CogVideoXBlock(cfg, policy, attn_impl) for _ in range(cfg.depth)])
        self.norm_final = _AffineLN(D, 1e-5, policy)
        self.norm_out = nn.Module()
        self.norm_out.linear = Dense(cfg.time_embed_dim, 2 * D, policy=policy)
        self.norm_out.norm = _AffineLN(D, 1e-5, policy)
        self.proj_out = Dense(D, p * p * cfg.out_channels, policy=policy)
        for name, m in self.named_modules():
            if isinstance(m, Attention):
                m.pab_key = name

    @exact_fp32_method
    def forward(self, sample: torch.Tensor, timestep: torch.Tensor,
                text_states: torch.Tensor, *,
                pab_refresh: Optional[dict] = None,
                pab_cache: Optional[dict] = None):
        """sample [B, F, h, w, C], timestep scalar or [B], text_states
        [B, S_txt, text_dim] -> [B, F, h, w, C_out] in the output dtype;
        with ``pab_refresh``, -> (that, the PAB cache)."""
        cfg = self.config
        cd = self.policy.compute_dtype
        B, F_, H, W, C = sample.shape
        p = cfg.patch_size
        hp, wp = H // p, W // p
        N, D = F_ * hp * wp, cfg.hidden_size
        dev = sample.device

        x = sample.to(cd).reshape(B, F_, hp, p, wp, p, C)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, N, p * p * C)
        vid = self.patch_embed.proj.linear(x)
        rope = None
        if cfg.use_rotary:
            rope = rope_3d(F_, hp, wp, D // cfg.num_heads,
                           text_len=text_states.shape[1], device=dev)
        else:
            pos_s = sinusoidal_positional_encoding(hp * wp, D, dev).to(vid.dtype)
            pos_t = sinusoidal_positional_encoding(F_, D, dev).to(vid.dtype)
            vid = vid + (pos_t[:, None, :] + pos_s[None]).reshape(N, D)[None]
        txt = self.patch_embed.text_proj(text_states.to(cd))

        t = torch.as_tensor(timestep, device=dev).reshape(-1).expand(B)
        c = self.time_embedding(get_timestep_embedding(t, D).to(cd))

        r = pab_refresh
        cache = None if r is None else ({} if pab_cache is None else pab_cache)
        joint = None if r is None else r.get("joint")
        for blk in self.transformer_blocks:
            vid, txt = blk(vid, txt, c, rope, joint, cache)

        S_txt = txt.shape[1]
        vid = self.norm_final(torch.cat([txt, vid], dim=1)).to(vid.dtype)[:, S_txt:]
        h = F.silu(c.float()).to(cd)
        shift, scale = self.norm_out.linear(h)[:, None, :].chunk(2, dim=-1)
        vid = _scale_shift(self.norm_out.norm(vid), scale, shift, shift.dtype)
        vid = self.proj_out(vid).reshape(B, F_, hp, wp, p, p, cfg.out_channels)
        vid = vid.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, F_, H, W,
                                                       cfg.out_channels)
        vid = self.policy.cast_to_output(vid)
        return vid if r is None else (vid, cache)


# ======================================================================
# 3D causal VAE
# ======================================================================


@dataclasses.dataclass(frozen=True)
class CausalVAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    temporal_downsample: Tuple[bool, ...] = (False, True, True, False)
    scaling_factor: float = 1.15258426

    @classmethod
    def cogvideox(cls) -> "CausalVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CausalVAEConfig":
        return cls(block_out_channels=(16, 32, 32, 32), layers_per_block=1)

    @property
    def spatial_downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @property
    def temporal_downscale(self) -> int:
        return 2 ** sum(self.temporal_downsample)


def edge_pad(x: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """[B, F, H, W, C] padded with the edge value: ``t`` frames before the
    first (none after), ``h`` rows and ``w`` columns on each side
    (``jnp.pad(mode="edge")``); one channels-last allocation."""
    B, F_, H, W, C = x.shape
    out = x.new_empty(B, F_ + t, H + 2 * h, W + 2 * w, C)
    out[:, t:, h:h + H, w:w + W] = x
    if h:
        out[:, t:, :h, w:w + W] = x[:, :, :1]
        out[:, t:, h + H:, w:w + W] = x[:, :, -1:]
    if w:
        out[:, t:, :, :w] = out[:, t:, :, w:w + 1]
        out[:, t:, :, w + W:] = out[:, t:, :, w + W - 1:w + W]
    if t:
        out[:, :t] = out[:, t:t + 1]
    return out


class _Conv3dWeights(nn.Module):
    """A Conv3d's ``weight`` [O, I, kt, kh, kw] and ``bias``."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int],
                 policy: Policy):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel,
                                               dtype=policy.param_dtype))
        self.bias = nn.Parameter(torch.empty(cout, dtype=policy.param_dtype))


class CausalConv3d(nn.Module):
    """A (kt, kh, kw) convolution over [B, F, H, W, C] with causal edge
    padding, VALID after it, at ``strides`` (t, h, w); the input goes to
    cuDNN as an NCDHW view with channels-last-3d strides."""

    def __init__(self, cin: int, cout: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.kernel = kernel
        self.strides = strides
        self.conv = _Conv3dWeights(cin, cout, kernel, policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        kt, kh, kw = self.kernel
        xp = edge_pad(x.to(cd), kt - 1, kh // 2, kw // 2)
        y = F.conv3d(xp.permute(0, 4, 1, 2, 3), self.conv.weight.to(cd),
                     self.conv.bias.to(cd), self.strides)
        return y.permute(0, 2, 3, 4, 1)


def _groups(cin: int, cout: int) -> int:
    return 32 if cout % 32 == 0 and cin % 32 == 0 else min(cin, 8)


class CausalResBlock3D(nn.Module):
    def __init__(self, cin: int, cout: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.norm1 = GroupNormModule(cin, _groups(cin, cout), 1e-6, True, policy)
        self.conv1 = CausalConv3d(cin, cout, policy=policy)
        g2 = 32 if cout % 32 == 0 else min(cout, 8)
        self.norm2 = GroupNormModule(cout, g2, 1e-6, True, policy)
        self.conv2 = CausalConv3d(cout, cout, policy=policy)
        self.conv_shortcut = (None if cin == cout else
                              _Conv3dWeights(cin, cout, (1, 1, 1), policy))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            cd = self.policy.compute_dtype
            sc = self.conv_shortcut
            x = F.linear(x.to(cd), sc.weight.to(cd)[:, :, 0, 0, 0], sc.bias.to(cd))
        return x + h


def _out_groups(c: int) -> int:
    return 32 if c % 32 == 0 else 8


class _Stage(nn.Module):
    """One down/up block: ``resnets`` and an optional resampling conv
    (``downsamplers.0`` / ``upsamplers.0``)."""

    def __init__(self, ins, ch: int, resampler: Optional[str],
                 resample_strides, policy: Policy):
        super().__init__()
        self.resnets = nn.ModuleList([CausalResBlock3D(c, ch, policy) for c in ins])
        if resampler is not None:
            setattr(self, resampler, nn.ModuleList([CausalConv3d(
                ch, ch, strides=resample_strides, policy=policy)]))


class CausalVAEEncoder(nn.Module):
    def __init__(self, config: CausalVAEConfig = CausalVAEConfig(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = config
        self.config = cfg
        self.policy = policy
        e = self.encoder = nn.Module()
        chs = cfg.block_out_channels
        n = len(chs)
        e.conv_in = CausalConv3d(cfg.in_channels, chs[0], policy=policy)
        e.down_blocks = nn.ModuleList()
        prev = chs[0]
        for bi, ch in enumerate(chs):
            ts = 2 if cfg.temporal_downsample[bi] else 1
            e.down_blocks.append(_Stage(
                [prev] + [ch] * (cfg.layers_per_block - 1), ch,
                "downsamplers" if bi < n - 1 else None, (ts, 2, 2), policy))
            prev = ch
        e.mid_block = _Stage([prev, prev], prev, None, None, policy)
        e.norm_out = GroupNormModule(prev, _out_groups(prev), 1e-6, True, policy)
        e.conv_out = CausalConv3d(prev, 2 * cfg.latent_channels, policy=policy)

    @exact_fp32_method
    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """[B, F, H, W, 3] -> latent moments [B, F', h, w, 2 * latent]."""
        e = self.encoder
        x = e.conv_in(video.to(self.policy.compute_dtype))
        for blk in e.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        for res in e.mid_block.resnets:
            x = res(x)
        return e.conv_out(e.norm_out(x))


class _NormOut(nn.Module):
    """The decoder's output GroupNorm under diffusers' ``norm_layer``."""

    def __init__(self, c: int, policy: Policy):
        super().__init__()
        self.norm_layer = GroupNormModule(c, _out_groups(c), 1e-6, True, policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_layer(x)


class CausalVAEDecoder(nn.Module):
    def __init__(self, config: CausalVAEConfig = CausalVAEConfig(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = config
        self.config = cfg
        self.policy = policy
        d = self.decoder = nn.Module()
        rev = tuple(reversed(cfg.block_out_channels))
        n = len(rev)
        d.conv_in = CausalConv3d(cfg.latent_channels, rev[0], policy=policy)
        d.mid_block = _Stage([rev[0], rev[0]], rev[0], None, None, policy)
        d.up_blocks = nn.ModuleList()
        prev = rev[0]
        for bi, ch in enumerate(rev):
            d.up_blocks.append(_Stage(
                [prev] + [ch] * cfg.layers_per_block, ch,
                "upsamplers" if bi < n - 1 else None, (1, 1, 1), policy))
            prev = ch
        d.norm_out = _NormOut(prev, policy)
        d.conv_out = CausalConv3d(prev, cfg.in_channels, policy=policy)

    @exact_fp32_method
    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """[B, f, h, w, latent] -> [B, F_out, H, W, 3] in the output dtype:
        x2 in H and W per up block but the last, x2 in F where
        ``temporal_downsample`` (reversed) says so."""
        cfg = self.config
        d = self.decoder
        rev_td = tuple(reversed(cfg.temporal_downsample))
        n = len(cfg.block_out_channels)
        x = d.conv_in(z.to(self.policy.compute_dtype))
        for res in d.mid_block.resnets:
            x = res(x)
        for bi, blk in enumerate(d.up_blocks):
            for res in blk.resnets:
                x = res(x)
            if bi < n - 1:
                x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                if rev_td[n - 2 - bi]:
                    x = x.repeat_interleave(2, dim=1)
                x = blk.upsamplers[0](x)
        x = d.conv_out(d.norm_out(x))
        return self.policy.cast_to_output(x)
