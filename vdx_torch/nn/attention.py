"""Attention and feed-forward modules, SD-1.5 conventions (port of
vdx/nn/attention.py).

Attention: to_q/to_k/to_v without bias, to_out.0 with bias, scale
1/sqrt(head_dim); self-attention (context=None) or cross-attention.
``attn_impl`` picks the ops.attention implementation of the spatial and
cross sites (vdx's ``Attention.attn_impl``); the motion modules keep
``auto``. The DiT families' options: ``qkv_bias`` (biased projections),
``out_bias``, ``qk_norm`` (a per-head affine LayerNorm on q and k, fp32,
eps 1e-6, cast back: ``norm_q``/``norm_k``) and a ``rope``
argument (interleaved-pair rotary tables, :func:`apply_rope`).

Pyramid Attention Broadcast (vdx's ``pab`` flag and ``pab_cache``
collection): ``refresh`` None computes; True computes and stores the
output (after to_out, in the compute dtype) in ``cache`` under the
module's ``pab_key``; False returns the stored output and runs no
projection and no attention. The cache is a dict the caller owns and
passes down, never state of the module, so no request sees another's.

FeedForward: GEGLU — Linear(C -> 8C), split, x * gelu(gate), Linear(4C -> C).
GELUFeedForward: Linear(C -> 4C), tanh GELU in fp32, Linear(4C -> C) (the
PixArt/Latte and CogVideoX feed-forward), under FeedForward's names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.layers import Dense, LayerNormF32
from vdx_torch.ops.attention import dot_product_attention

Rope = Tuple[torch.Tensor, torch.Tensor]


def apply_rope(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """Rotate q or k [B, S, H, D] by interleaved-pair RoPE: (x[2i],
    x[2i+1]) turns by the i-th angle of the fp32 tables (cos, sin)
    [S, D/2]; the rotation runs in fp32 and is cast back."""
    cos, sin = rope
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int = 8, head_dim: int = 64,
                 context_dim: Optional[int] = None,
                 policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto", *,
                 qkv_bias: bool = False, out_bias: bool = True,
                 qk_norm: bool = False):
        super().__init__()
        inner = heads * head_dim
        kv_dim = context_dim or query_dim
        self.heads = heads
        self.head_dim = head_dim
        self.attn_impl = attn_impl
        self.to_q = Dense(query_dim, inner, bias=qkv_bias, policy=policy)
        self.to_k = Dense(kv_dim, inner, bias=qkv_bias, policy=policy)
        self.to_v = Dense(kv_dim, inner, bias=qkv_bias, policy=policy)
        self.to_out = nn.ModuleList([Dense(inner, query_dim, bias=out_bias,
                                           policy=policy)])
        if qk_norm:
            self.norm_q = LayerNormF32(head_dim, 1e-6, policy)
            self.norm_k = LayerNormF32(head_dim, 1e-6, policy)
        else:
            self.norm_q = self.norm_k = None
        #: the module's key in a PAB cache (UNetMotion sets its qualified name)
        self.pab_key = ""

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                refresh: Optional[bool] = None,
                cache: Optional[dict] = None,
                rope: Optional[Rope] = None, *, impl: Optional[str] = None,
                kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``impl`` overrides the module's ``attn_impl`` for this call (a
        frame-sharded temporal site's "ring:<axis>"); ``kv_valid`` is the
        ring's key mask (ops/attention.py)."""
        sharded = {k: v for k, v in (("impl", impl), ("kv_valid", kv_valid))
                   if v is not None}
        if refresh is None:
            return self._compute(x, context, rope, **sharded)
        if refresh:
            cache[self.pab_key] = self._compute(x, context, rope, **sharded)
        return cache[self.pab_key]

    def _compute(self, x: torch.Tensor, context: Optional[torch.Tensor],
                 rope: Optional[Rope], impl: Optional[str] = None,
                 kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        impl = impl or self.attn_impl
        ctx = x if context is None else context
        if (ctx.shape[1] == 1 and self.norm_q is None and rope is None
                and not impl.startswith("ring")):
            # Single-KV attention: the softmax over one key is identically
            # 1, so the output is to_out(v) broadcast over the queries —
            # exact, not an approximation (vdx/nn/attention.py:78-101).
            # Not under ring sharding, where one local frame may belong to
            # a longer global sequence.
            out1 = self.to_out[0](self.to_v(ctx))
            return out1.expand(x.shape[0], x.shape[1], out1.shape[-1])
        B, Sq = x.shape[:2]
        Skv = ctx.shape[1]
        q = self.to_q(x).view(B, Sq, self.heads, self.head_dim)
        k = self.to_k(ctx).view(B, Skv, self.heads, self.head_dim)
        v = self.to_v(ctx).view(B, Skv, self.heads, self.head_dim)
        if self.norm_q is not None:  # q, k and v share the compute dtype
            q = self.norm_q(q)
            k = self.norm_k(k)
        if rope is not None:
            q = apply_rope(q, rope)
            k = apply_rope(k, rope)
        out = dot_product_attention(q, k, v, scale=self.head_dim ** -0.5,
                                    impl=impl, kv_valid=kv_valid)
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


class _GELUProj(nn.Module):
    """diffusers' GELU activation module: Linear ``proj``, then tanh GELU
    in fp32, cast back."""

    def __init__(self, dim: int, dim_out: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.proj = Dense(dim, dim_out, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj(x)
        return F.gelu(h.float(), approximate="tanh").to(h.dtype)


class GELUFeedForward(nn.Module):
    """diffusers' FeedForward(activation_fn="gelu-approximate"): Latte's and
    CogVideoX's, with FeedForward's parameter paths (net.0.proj, net.2)."""

    def __init__(self, dim: int, mult: int = 4, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, dim * mult, policy), nn.Identity(),
                                  Dense(dim * mult, dim, policy=policy)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))
