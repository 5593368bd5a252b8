"""CLIP ViT-L/14 text tower — the SD-1.5 prompt encoder (port of
vdx/models/clip_text.py).

vocab 49408, hidden 768, 12 layers, 12 heads, MLP 3072 with quick-GELU,
learned position embeddings over 77 tokens, causal mask, final LayerNorm.
Module names follow transformers' CLIPTextModel (text_model.embeddings,
text_model.encoder.layers.i, text_model.final_layer_norm).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.nn.layers import Dense
from vdx_torch.nn.transformer import LayerNormF32
from vdx_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77

    @classmethod
    def sd15(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        # the vocab covers the CLIP id space (BOS/EOS at 49406/49407)
        return cls(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.sigmoid(1.702 * x32)).to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, policy: Policy):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = Dense(d, d, policy=policy)
        self.k_proj = Dense(d, d, policy=policy)
        self.v_proj = Dense(d, d, policy=policy)
        self.out_proj = Dense(d, d, policy=policy)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        hd = D // self.heads
        q = self.q_proj(x).view(B, S, self.heads, hd)
        k = self.k_proj(x).view(B, S, self.heads, hd)
        v = self.v_proj(x).view(B, S, self.heads, hd)
        out = dot_product_attention(q, k, v, scale=hd ** -0.5, mask=mask,
                                    impl="xla")
        return self.out_proj(out.reshape(B, S, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, policy: Policy):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, policy=policy)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, policy: Policy):
        super().__init__()
        self.layer_norm1 = LayerNormF32(cfg.hidden_size, policy=policy)
        self.self_attn = CLIPAttention(cfg, policy)
        self.layer_norm2 = LayerNormF32(cfg.hidden_size, policy=policy)
        self.mlp = CLIPMLP(cfg, policy)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, policy: Policy):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            dtype=policy.param_dtype)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size,
                                               dtype=policy.param_dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, policy: Policy):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg, policy)
                                     for _ in range(cfg.num_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, policy: Policy):
        super().__init__()
        self.embeddings = _Embeddings(cfg, policy)
        self.encoder = _Encoder(cfg, policy)
        self.final_layer_norm = LayerNormF32(cfg.hidden_size, policy=policy)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.config = config
        self.policy = policy
        self.text_model = _TextModel(config, policy)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, 77] token ids -> [B, 77, hidden] final hidden states."""
        tm = self.text_model
        S = input_ids.shape[1]
        tok = tm.embeddings.token_embedding(input_ids)
        pos = tm.embeddings.position_embedding.weight[:S]
        x = (tok + pos[None]).to(self.policy.compute_dtype)
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                       device=input_ids.device))[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x.float())
        return self.policy.cast_to_output(x)
