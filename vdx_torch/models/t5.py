"""T5 (v1.1) encoder, CogVideoX's text tower (port of vdx/models/t5.py).

RMSNorm before each sublayer (no bias, fp32), relative position bias
buckets computed once in block 0 and added to every block's attention
logits, UNSCALED dot-product attention with an fp32 softmax, a gated
tanh-GELU feed-forward (``wi_0``, ``wi_1``, ``wo``), no bias in any
linear, a final RMSNorm. No attention mask: padded ids attend, as vdx.
Parameter names follow transformers' T5EncoderModel (``shared``,
``encoder.block.i.layer.0.SelfAttention``, ``encoder.block.i.layer.1
.DenseReluDense``, ``encoder.final_layer_norm``).

The attention is plain PyTorch (vdx's is a plain einsum, no Pallas
kernel): 226 tokens, a [B, 64, 226, 226] score tensor at T5-XXL.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy, exact_fp32_method
from vdx_torch.nn.layers import Dense


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128

    @classmethod
    def xxl(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=512, d_model=64, d_kv=16, d_ff=128,
                   num_layers=2, num_heads=4)


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight in fp32, in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=policy.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.sqrt(1.0 / (var + self.eps))
                * self.weight.float()).to(x.dtype)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5's bidirectional relative position buckets [qlen, klen] (host
    side, int64)."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return ret + np.where(is_small, n, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool = False,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = Dense(cfg.d_model, inner, bias=False, policy=policy)
        self.k = Dense(cfg.d_model, inner, bias=False, policy=policy)
        self.v = Dense(cfg.d_model, inner, bias=False, policy=policy)
        self.o = Dense(inner, cfg.d_model, bias=False, policy=policy)
        self.relative_attention_bias = (
            nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads,
                         dtype=policy.param_dtype) if has_bias_table else None)

    def forward(self, x: torch.Tensor, position_bias=None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Dk = cfg.num_heads, cfg.d_kv
        q, k, v = (proj(x).view(B, S, H, Dk).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        if self.relative_attention_bias is not None:
            buckets = torch.as_tensor(relative_position_buckets(
                S, S, cfg.relative_attention_num_buckets,
                cfg.relative_attention_max_distance), device=x.device)
            # [S, S, H] -> [1, H, S, S], in the table's dtype
            position_bias = self.relative_attention_bias.weight[buckets] \
                .permute(2, 0, 1)[None]
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if position_bias is not None:
            scores = scores + position_bias.float()
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, S, H * Dk)
        return self.o(out), position_bias


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, first: bool, policy: Policy):
        super().__init__()
        self.layer_norm = RMSNorm(cfg.d_model, policy=policy)
        self.SelfAttention = T5Attention(cfg, first, policy)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config, policy: Policy):
        super().__init__()
        self.wi_0 = Dense(cfg.d_model, cfg.d_ff, bias=False, policy=policy)
        self.wi_1 = Dense(cfg.d_model, cfg.d_ff, bias=False, policy=policy)
        self.wo = Dense(cfg.d_ff, cfg.d_model, bias=False, policy=policy)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        wi0 = self.wi_0(h)
        gelu = F.gelu(wi0.float(), approximate="tanh").to(wi0.dtype)
        return self.wo(gelu * self.wi_1(h))


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config, policy: Policy):
        super().__init__()
        self.layer_norm = RMSNorm(cfg.d_model, policy=policy)
        self.DenseReluDense = _DenseGatedGelu(cfg, policy)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, first: bool = False,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, first, policy),
                                    _FFLayer(cfg, policy)])

    def forward(self, x: torch.Tensor, position_bias=None):
        attn, ff = self.layer
        a, position_bias = attn.SelfAttention(attn.layer_norm(x), position_bias)
        x = x + a
        return x + ff.DenseReluDense(ff.layer_norm(x)), position_bias


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config, policy: Policy):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0, policy)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, policy=policy)


class T5Encoder(nn.Module):
    def __init__(self, config: T5Config = T5Config(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.config = config
        self.policy = policy
        self.shared = nn.Embedding(config.vocab_size, config.d_model,
                                   dtype=policy.param_dtype)
        self.encoder = _Stack(config, policy)

    @exact_fp32_method
    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """int ids [B, S] -> states [B, S, d_model] in the output dtype."""
        x = self.shared(input_ids.long()).to(self.policy.compute_dtype)
        bias = None
        for blk in self.encoder.block:
            x, bias = blk(x, bias)
        x = self.encoder.final_layer_norm(x)
        return self.policy.cast_to_output(x)
