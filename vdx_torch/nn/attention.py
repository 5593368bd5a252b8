"""Attention and feed-forward modules, SD-1.5 conventions (port of
vdx/nn/attention.py).

Attention: to_q/to_k/to_v without bias, to_out.0 with bias, scale
1/sqrt(head_dim); self-attention (context=None) or cross-attention.
FeedForward: GEGLU — Linear(C -> 8C), split, x * gelu(gate), Linear(4C -> C).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.layers import Dense
from vdx_torch.ops.attention import dot_product_attention


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int = 8, head_dim: int = 64,
                 context_dim: Optional[int] = None,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        inner = heads * head_dim
        kv_dim = context_dim or query_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = Dense(query_dim, inner, bias=False, policy=policy)
        self.to_k = Dense(kv_dim, inner, bias=False, policy=policy)
        self.to_v = Dense(kv_dim, inner, bias=False, policy=policy)
        self.to_out = nn.ModuleList([Dense(inner, query_dim, policy=policy)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        if ctx.shape[1] == 1:
            # Single-KV attention: the softmax over one key is identically
            # 1, so the output is to_out(v) broadcast over the queries —
            # exact, not an approximation (vdx/nn/attention.py:78-101).
            out1 = self.to_out[0](self.to_v(ctx))
            return out1.expand(x.shape[0], x.shape[1], out1.shape[-1])
        B, Sq = x.shape[:2]
        Skv = ctx.shape[1]
        q = self.to_q(x).view(B, Sq, self.heads, self.head_dim)
        k = self.to_k(ctx).view(B, Skv, self.heads, self.head_dim)
        v = self.to_v(ctx).view(B, Skv, self.heads, self.head_dim)
        out = dot_product_attention(q, k, v, scale=self.head_dim ** -0.5)
        return self.to_out[0](out.reshape(B, Sq, self.heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        # Exact (erf) gelu under fp32 compute, as the checkpoints; tanh
        # under bf16, where the product is rounded to bf16 anyway (vdx's
        # scoped precision-policy exception, nn/attention.py:150-174).
        approx = "tanh" if h.dtype == torch.bfloat16 else "none"
        return h * F.gelu(gate.float(), approximate=approx).to(h.dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        # net.1 is diffusers' parameter-free dropout slot
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, policy), nn.Identity(),
                                  Dense(dim * mult, dim, policy=policy)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))
