"""Timestep and positional embeddings (port of vdx/nn/embeddings.py).

* :func:`get_timestep_embedding` — SD UNet sinusoidal timestep embedding
  (cos-first, ``downscale_freq_shift=0``).
* :class:`TimestepEmbedding` — linear -> SiLU -> linear (320 -> 1280).
* :func:`sinusoidal_positional_encoding` — interleaved sin/cos PE the
  motion modules add over the frame axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.layers import Dense


def get_timestep_embedding(timesteps: torch.Tensor, dim: int, *,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: float = 10000.0) -> torch.Tensor:
    """[B] (possibly fractional) timesteps -> [B, dim] fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def sinusoidal_positional_encoding(seq_len: int, dim: int,
                                   device=None) -> torch.Tensor:
    """pe[p, 2i] = sin, pe[p, 2i+1] = cos. [S, dim] fp32."""
    position = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / dim))
    pe = torch.zeros(seq_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU (fp32) -> linear_2."""

    def __init__(self, in_dim: int, embed_dim: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.linear_1 = Dense(in_dim, embed_dim, policy=policy)
        self.linear_2 = Dense(embed_dim, embed_dim, policy=policy)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.linear_1(t_emb.to(self.policy.compute_dtype))
        h = F.silu(h.float()).to(self.policy.compute_dtype)
        return self.linear_2(h)
