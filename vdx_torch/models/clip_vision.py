"""CLIP ViT vision tower — SVD's image-conditioning encoder (port of
vdx/models/clip_vision.py).

OpenCLIP ViT-H/14 (``vit_h``: 224 px, patch 14, hidden 1280, 32 layers,
16 heads, MLP 5120 with quick-GELU in fp32), a class token and learned
positions, pre-LN and post-LN at eps 1e-5 in fp32, and a bias-free
``visual_projection`` to the UNet's cross-attention width. Attention runs
on the exact eager path (``impl="xla"``), as vdx's. Module names follow
transformers' CLIPVisionModelWithProjection (vision_model.embeddings,
vision_model.pre_layrnorm, vision_model.encoder.layers.i,
vision_model.post_layernorm, visual_projection).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy, exact_fp32_method
from vdx_torch.models.clip_text import quick_gelu
from vdx_torch.nn.layers import Dense
from vdx_torch.nn.transformer import LayerNormF32
from vdx_torch.ops.attention import dot_product_attention

# CLIP image normalisation
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    projection_dim: int = 1024

    @classmethod
    def vit_h(cls) -> "CLIPVisionConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                   num_heads=2, intermediate_size=128, projection_dim=64)


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, policy: Policy):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = Dense(d, d, policy=policy)
        self.k_proj = Dense(d, d, policy=policy)
        self.v_proj = Dense(d, d, policy=policy)
        self.out_proj = Dense(d, d, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        hd = D // self.heads
        q, k, v = (p(x).view(B, S, self.heads, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        out = dot_product_attention(q, k, v, scale=hd ** -0.5, impl="xla")
        return self.out_proj(out.reshape(B, S, D))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, policy: Policy):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, policy=policy)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, policy: Policy):
        super().__init__()
        self.layer_norm1 = LayerNormF32(cfg.hidden_size, policy=policy)
        self.self_attn = _Attention(cfg, policy)
        self.layer_norm2 = LayerNormF32(cfg.hidden_size, policy=policy)
        self.mlp = _MLP(cfg, policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, policy: Policy):
        super().__init__()
        p, d = cfg.patch_size, cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False,
                                         dtype=policy.param_dtype)
        self.class_embedding = nn.Parameter(torch.empty(d, dtype=policy.param_dtype))
        self.position_embedding = nn.Embedding(1 + (cfg.image_size // p) ** 2, d,
                                               dtype=policy.param_dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, policy: Policy):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg, policy)
                                     for _ in range(cfg.num_layers)])


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, policy: Policy):
        super().__init__()
        self.embeddings = _Embeddings(cfg, policy)
        # transformers' historical spelling
        self.pre_layrnorm = LayerNormF32(cfg.hidden_size, policy=policy)
        self.encoder = _Encoder(cfg, policy)
        self.post_layernorm = LayerNormF32(cfg.hidden_size, policy=policy)


class CLIPVisionModel(nn.Module):
    """[B, H, W, 3] in [0, 1] -> the pooled, projected embedding
    [B, projection_dim]."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.config = config
        self.policy = policy
        self.vision_model = _VisionModel(config, policy)
        self.visual_projection = Dense(config.hidden_size, config.projection_dim,
                                       bias=False, policy=policy)

    @exact_fp32_method
    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        vm = self.vision_model
        emb = vm.embeddings
        mean = torch.tensor(IMAGE_MEAN, device=pixels.device)
        std = torch.tensor(IMAGE_STD, device=pixels.device)
        x = ((pixels.float() - mean) / std).to(cd)
        p = self.config.patch_size
        x = F.conv2d(x.permute(0, 3, 1, 2), emb.patch_embedding.weight.to(cd),
                     stride=p)
        B, D = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # [B, patches, D], row-major patches
        cls = emb.class_embedding.to(cd).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1)
        x = x + emb.position_embedding.weight[:x.shape[1]].to(cd)[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = vm.post_layernorm(x[:, 0])
        return self.policy.cast_to_output(self.visual_projection(pooled))
