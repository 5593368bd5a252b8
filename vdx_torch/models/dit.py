"""Latte-style spatiotemporal DiT (port of vdx/models/dit.py), BASELINE.json
configs[4].

Blocks alternate: every even block is spatial, on [B*F, N, D] (self-attention
over a frame's patches, cross-attention to the text), every odd block is
temporal, on [B*N, F, D] (self-attention over a patch's frames). adaLN-Zero
conditioning from the timestep; the spatial sinusoidal PE is added once
before the blocks, the frame PE at block 1. LayerNorms are affine-free,
eps 1e-6, fp32. Cross-attention runs on the raw hidden states (no norm
before it), and the final modulation is ``scale_shift_table`` plus the raw
conditioning (no SiLU, no linear), as vdx.

Parameter names follow diffusers' LatteTransformer3DModel
(``pos_embed.proj``, ``adaln_single.emb.timestep_embedder``,
``transformer_blocks.j`` for block 2j, ``temporal_transformer_blocks.j``
for block 2j+1, ``attn1``/``attn2``/``ff``, ``scale_shift_table``,
``proj_out``), except the adaLN: vdx gives every block its own SiLU +
Linear (``adaln.proj``), where diffusers has one global
``adaln_single.linear`` plus a table per block. The port keeps vdx's
structure under that port-owned key (ROADMAP Queue 3, F14);
pipelines/latte.py folds a diffusers checkpoint into it.

``pab_refresh`` / ``pab_cache`` as UNetMotion's: attn1 of a spatial block
takes "spatial", attn2 "cross", attn1 of a temporal block "temporal".

Frame sharding (``temporal_impl`` "ring:<axis>" or "ulysses:<axis>",
``frames_valid``, as vdx's): the spatial blocks are frame-local; only the
temporal blocks communicate, through the Ulysses all_to_all swap where
B*N divides the mesh axis and ring attention otherwise, and the frame PE
takes global frame positions (nn/frame_shard.py, the motion module's
rule).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy, exact_fp32_method
from vdx_torch.nn.attention import Attention, GELUFeedForward
from vdx_torch.nn.embeddings import (TimestepEmbedding, get_timestep_embedding,
                                     sinusoidal_positional_encoding)
from vdx_torch.nn.layers import Dense, PatchConv
from vdx_torch.nn.frame_shard import (_shard_axis, global_frame_pe,
                                      run_temporal_site)


@dataclasses.dataclass(frozen=True)
class LatteConfig:
    in_channels: int = 4
    out_channels: int = 4
    patch_size: int = 2
    hidden_size: int = 1152
    depth: int = 28  # total blocks; alternating spatial/temporal
    num_heads: int = 16
    cross_attention_dim: int = 768
    mlp_ratio: int = 4

    @classmethod
    def xl(cls) -> "LatteConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LatteConfig":
        return cls(hidden_size=64, depth=4, num_heads=2, cross_attention_dim=64)


class AdaLNModulation(nn.Module):
    """SiLU (fp32) + Linear producing ``n_chunks`` [B, 1, D] modulation
    vectors from the conditioning."""

    def __init__(self, cond_dim: int, hidden_size: int, n_chunks: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.n_chunks = n_chunks
        self.proj = Dense(cond_dim, n_chunks * hidden_size, policy=policy)

    def forward(self, c: torch.Tensor):
        h = F.silu(c.float()).to(self.policy.compute_dtype)
        return self.proj(h)[:, None, :].chunk(self.n_chunks, dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Affine-free LayerNorm, fp32, eps 1e-6, in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block, optionally with cross-attention to the
    text (the spatial blocks)."""

    def __init__(self, cfg: LatteConfig, use_cross_attn: bool = False,
                 policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto"):
        super().__init__()
        D = cfg.hidden_size
        head_dim = D // cfg.num_heads
        self.adaln = AdaLNModulation(D, D, 6, policy)
        self.attn1 = Attention(D, cfg.num_heads, head_dim, policy=policy,
                               attn_impl=attn_impl)
        self.attn2 = (Attention(D, cfg.num_heads, head_dim,
                                context_dim=cfg.cross_attention_dim,
                                policy=policy) if use_cross_attn else None)
        self.ff = GELUFeedForward(D, cfg.mlp_ratio, policy)

    def forward(self, x, c, context=None, refresh_self=None, refresh_cross=None,
                cache=None, attn_impl=None, kv_valid=None):
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = self.adaln(c)
        h = _modulate(_layer_norm(x), shift_a, scale_a)
        x = x + gate_a * self.attn1(h, None, refresh_self, cache,
                                    impl=attn_impl, kv_valid=kv_valid)
        if self.attn2 is not None and context is not None:
            # on the raw hidden states: no norm before the cross-attention
            x = x + self.attn2(x, context, refresh_cross, cache)
        h = _modulate(_layer_norm(x), shift_m, scale_m)
        return x + gate_m * self.ff(h)


class LatteDiT(nn.Module):
    def __init__(self, config: LatteConfig = LatteConfig(),
                 policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto",
                 freeu=None):
        super().__init__()
        if freeu is not None:
            raise ValueError("LatteDiT has no skip-connection up path — FreeU "
                             "does not apply")
        cfg = config
        self.config = cfg
        self.policy = policy
        D, p = cfg.hidden_size, cfg.patch_size
        self.pos_embed = nn.Module()
        self.pos_embed.proj = PatchConv(cfg.in_channels, D, p, policy)
        self.adaln_single = nn.Module()
        self.adaln_single.emb = nn.Module()
        self.adaln_single.emb.timestep_embedder = TimestepEmbedding(256, D, policy)
        n = cfg.depth
        self.transformer_blocks = nn.ModuleList([
            DiTBlock(cfg, True, policy, attn_impl) for _ in range((n + 1) // 2)])
        self.temporal_transformer_blocks = nn.ModuleList([
            DiTBlock(cfg, False, policy) for _ in range(n // 2)])
        self.scale_shift_table = nn.Parameter(
            torch.empty(2, D, dtype=policy.param_dtype))
        self.proj_out = Dense(D, p * p * cfg.out_channels, policy=policy)
        for name, m in self.named_modules():
            if isinstance(m, Attention):
                m.pab_key = name

    @exact_fp32_method
    def forward(self, sample: torch.Tensor, timestep: torch.Tensor,
                context: Optional[torch.Tensor] = None, *,
                pab_refresh: Optional[dict] = None,
                pab_cache: Optional[dict] = None,
                frames_valid: Optional[int] = None,
                temporal_impl: str = "local"):
        """sample [B, F, H, W, C], timestep scalar or [B], context
        [B, S, cross_dim] or None -> [B, F, H, W, C_out] in the output
        dtype; with ``pab_refresh``, -> (that, the PAB cache). Under frame
        sharding F is this rank's shard of the frame axis."""
        s_axis = _shard_axis(temporal_impl)
        cfg = self.config
        cd = self.policy.compute_dtype
        B, F_, H, W, C = sample.shape
        p = cfg.patch_size
        hp, wp = H // p, W // p
        N, D = hp * wp, cfg.hidden_size

        # patchify in (p_h, p_w, C) order -> the conv's weight as a linear
        x = sample.to(cd).reshape(B, F_, hp, p, wp, p, C)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, F_, N, p * p * C)
        x = self.pos_embed.proj.linear(x)
        dev = sample.device
        x = x + sinusoidal_positional_encoding(N, D, dev).to(x.dtype)[None, None]
        pos_t = global_frame_pe(F_, D, s_axis, dev).to(x.dtype)

        t = torch.as_tensor(timestep, device=dev).reshape(-1).expand(B)
        c = self.adaln_single.emb.timestep_embedder(get_timestep_embedding(t, 256))
        if context is not None:
            context = context.to(cd)

        r = pab_refresh
        cache = None if r is None else ({} if pab_cache is None else pab_cache)
        rm = r or {}
        for i in range(cfg.depth):
            if i % 2 == 0:
                blk = self.transformer_blocks[i // 2]
                ctx = (None if context is None
                       else context.repeat_interleave(F_, dim=0))
                xs = blk(x.reshape(B * F_, N, D), c.repeat_interleave(F_, dim=0),
                         ctx, rm.get("spatial"), rm.get("cross"), cache)
                x = xs.reshape(B, F_, N, D)
            else:
                blk = self.temporal_transformer_blocks[i // 2]
                xt = x.transpose(1, 2).reshape(B * N, F_, D)
                if i == 1:
                    xt = xt + pos_t[None]
                xt = run_temporal_site(
                    lambda xt, axis, kv_valid, ct: blk(
                        xt, ct, None, rm.get("temporal"), None, cache,
                        None if axis is None else f"ring:{axis}", kv_valid),
                    xt, temporal_impl,
                    frames_valid if s_axis is not None else None,
                    (c.repeat_interleave(N, dim=0),))
                x = xt.reshape(B, N, F_, D).transpose(1, 2)

        # final modulation: the table plus the RAW conditioning
        ft, cm = self.scale_shift_table.float(), c.float()
        shift = (ft[0][None] + cm)[:, None, :].to(x.dtype)
        scale = (ft[1][None] + cm)[:, None, :].to(x.dtype)
        x = _modulate(_layer_norm(x.reshape(B, F_ * N, D)), shift, scale)
        x = self.proj_out(x.reshape(B, F_, N, D))
        x = x.reshape(B, F_, hp, wp, p, p, cfg.out_channels)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, F_, H, W, cfg.out_channels)
        x = self.policy.cast_to_output(x)
        return x if r is None else (x, cache)
