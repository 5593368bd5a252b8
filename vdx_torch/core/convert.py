"""Weights between vdx's parameter trees and the port's modules.

The port's modules use diffusers/transformers state_dict names and
torch-native shapes, so vdx's conversion rules (vdx/core/convert.py) name
the bridge. This module keeps its own copy of the rule tables it needs —
UNetMotion, the AutoencoderKL and the CLIP text tower — and runs
them backwards: :func:`params_from_jax` turns a flattened vdx parameter
tree (numpy leaves) into a state_dict for the port's module. The
families: UNetMotion, UNet3D (ModelScope), UNetSpatioTemporal (SVD),
LatteDiT and CogVideoXDiT denoisers, the AutoencoderKL, SVD's temporal
decoder, the CLIP text and vision towers, T5, and CogVideoX's causal VAE
encoder and decoder.

Layout transforms (vdx <- torch):
  * Conv:   torch OIHW     -> flax HWIO   (``t_conv``)
  * Conv3d: torch OITHW    -> flax THWIO  (``t_conv3d``: the (3, 1, 1)
    frame convs, the causal VAE's 3x3x3 convs)
  * 1x1x1 Conv3d [O, I, 1, 1, 1] -> Dense [I, O] (``t_conv3d_1x1_dense``)
  * patch Conv2d [D, C, p, p] -> Dense [p*p*C, D] (``t_patch_conv``; its
    inverse needs p and C: the rule tables carry ``patch_conv(p, C)``)
  * Dense:  torch [out,in] -> flax [in,out] (``t_dense``)
  * Norms and embeddings: identical (``t_id``)
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

Rules = Dict[str, Tuple[str, Callable]]


def t_conv(w):  # OIHW -> HWIO
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def t_dense(w):  # [out, in] -> [in, out]
    return np.transpose(np.asarray(w), (1, 0))


def t_id(w):
    return np.asarray(w)


def t_conv3d(w):  # torch OITHW -> flax THWIO
    return np.transpose(np.asarray(w), (2, 3, 4, 1, 0))


def t_conv3d_1x1_dense(w):  # [O, I, 1, 1, 1] shortcut conv -> Dense [I, O]
    w = np.asarray(w)
    return w.reshape(w.shape[0], w.shape[1]).T


def t_patch_conv(w):
    """patch_embed Conv2d [D, C, p, p] -> Dense [p*p*C, D]: the DiTs
    flatten a patch in (p_h, p_w, C) order."""
    w = np.asarray(w)
    return w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0])


# each rule's transform -> its inverse (vdx layout -> torch layout)
_INVERSE = {
    t_conv: lambda w: np.transpose(np.asarray(w), (3, 2, 0, 1)),
    t_conv3d: lambda w: np.transpose(np.asarray(w), (4, 3, 0, 1, 2)),
    t_conv3d_1x1_dense: lambda w: np.asarray(w).T[:, :, None, None, None],
    t_dense: lambda w: np.transpose(np.asarray(w), (1, 0)),
    t_id: np.asarray,
}


def patch_conv(p: int, channels: int):
    """``t_patch_conv`` for patches of p x p x ``channels``, with its
    inverse registered (the flat [p*p*C, D] kernel does not say p)."""
    key = ("patch_conv", p, channels)
    if key not in _PATCH_CONV:
        def tr(w):
            return t_patch_conv(w)

        _INVERSE[tr] = lambda w: np.asarray(w).reshape(
            p, p, channels, -1).transpose(3, 2, 0, 1)
        _PATCH_CONV[key] = tr
    return _PATCH_CONV[key]


_PATCH_CONV: dict = {}

# ----------------------------------------------------------------------
# UNetMotion
# ----------------------------------------------------------------------

_ATTN_LEAF = {
    "to_q/kernel": ("attn{j}.to_q.weight", t_dense),
    "to_k/kernel": ("attn{j}.to_k.weight", t_dense),
    "to_v/kernel": ("attn{j}.to_v.weight", t_dense),
    "to_out/kernel": ("attn{j}.to_out.0.weight", t_dense),
    "to_out/bias": ("attn{j}.to_out.0.bias", t_id),
}


def _transformer_block_rules(prefix: str, hf_prefix: str) -> Rules:
    """One BasicTransformerBlock / TemporalBlock."""
    rules = {}
    for j, attn in ((1, "attn1"), (2, "attn2")):
        for leaf, (hf_leaf, tr) in _ATTN_LEAF.items():
            rules[f"{prefix}/{attn}/{leaf}"] = (
                f"{hf_prefix}.{hf_leaf.format(j=j)}", tr)
    for i in (1, 2, 3):
        rules[f"{prefix}/norm{i}/LayerNorm_0/scale"] = (
            f"{hf_prefix}.norm{i}.weight", t_id)
        rules[f"{prefix}/norm{i}/LayerNorm_0/bias"] = (
            f"{hf_prefix}.norm{i}.bias", t_id)
    rules[f"{prefix}/ff/net_0/proj/kernel"] = (f"{hf_prefix}.ff.net.0.proj.weight", t_dense)
    rules[f"{prefix}/ff/net_0/proj/bias"] = (f"{hf_prefix}.ff.net.0.proj.bias", t_id)
    rules[f"{prefix}/ff/net_2/kernel"] = (f"{hf_prefix}.ff.net.2.weight", t_dense)
    rules[f"{prefix}/ff/net_2/bias"] = (f"{hf_prefix}.ff.net.2.bias", t_id)
    return rules


def _resnet_rules(prefix: str, hf_prefix: str) -> Rules:
    rules = {}
    for ours, theirs, tr in [
        ("norm1/scale", "norm1.weight", t_id),
        ("norm1/bias", "norm1.bias", t_id),
        ("conv1/kernel", "conv1.weight", t_conv),
        ("conv1/bias", "conv1.bias", t_id),
        ("time_emb_proj/kernel", "time_emb_proj.weight", t_dense),
        ("time_emb_proj/bias", "time_emb_proj.bias", t_id),
        ("norm2/scale", "norm2.weight", t_id),
        ("norm2/bias", "norm2.bias", t_id),
        ("conv2/kernel", "conv2.weight", t_conv),
        ("conv2/bias", "conv2.bias", t_id),
        ("conv_shortcut/kernel", "conv_shortcut.weight", t_conv),
        ("conv_shortcut/bias", "conv_shortcut.bias", t_id),
    ]:
        rules[f"{prefix}/{ours}"] = (f"{hf_prefix}.{theirs}", tr)
    return rules


def _spatial_transformer_rules(prefix: str, hf_prefix: str,
                               depth: int = 1) -> Rules:
    rules = {
        f"{prefix}/norm/scale": (f"{hf_prefix}.norm.weight", t_id),
        f"{prefix}/norm/bias": (f"{hf_prefix}.norm.bias", t_id),
        f"{prefix}/proj_in/kernel": (f"{hf_prefix}.proj_in.weight", t_conv),
        f"{prefix}/proj_in/bias": (f"{hf_prefix}.proj_in.bias", t_id),
        f"{prefix}/proj_out/kernel": (f"{hf_prefix}.proj_out.weight", t_conv),
        f"{prefix}/proj_out/bias": (f"{hf_prefix}.proj_out.bias", t_id),
    }
    for d in range(depth):
        rules.update(_transformer_block_rules(
            f"{prefix}/blocks_{d}", f"{hf_prefix}.transformer_blocks.{d}"))
    return rules


def _motion_rules(prefix: str, hf_prefix: str, depth: int = 1) -> Rules:
    rules = {
        f"{prefix}/norm_scale": (f"{hf_prefix}.norm.weight", t_id),
        f"{prefix}/norm_bias": (f"{hf_prefix}.norm.bias", t_id),
        f"{prefix}/proj_in/kernel": (f"{hf_prefix}.proj_in.weight", t_dense),
        f"{prefix}/proj_in/bias": (f"{hf_prefix}.proj_in.bias", t_id),
        f"{prefix}/proj_out/kernel": (f"{hf_prefix}.proj_out.weight", t_dense),
        f"{prefix}/proj_out/bias": (f"{hf_prefix}.proj_out.bias", t_id),
    }
    for d in range(depth):
        rules.update(_transformer_block_rules(
            f"{prefix}/blocks_{d}", f"{hf_prefix}.transformer_blocks.{d}"))
    return rules


def _resample_rules(ours: str, hf: str) -> Rules:
    return {f"{ours}/conv/kernel": (f"{hf}.conv.weight", t_conv),
            f"{ours}/conv/bias": (f"{hf}.conv.bias", t_id)}


def unet_motion_rules(config) -> Rules:
    """vdx param path -> (diffusers state_dict key, transform), UNetMotion."""
    rules: Rules = {
        "conv_in/kernel": ("conv_in.weight", t_conv),
        "conv_in/bias": ("conv_in.bias", t_id),
        "time_embedding/linear_1/kernel": ("time_embedding.linear_1.weight", t_dense),
        "time_embedding/linear_1/bias": ("time_embedding.linear_1.bias", t_id),
        "time_embedding/linear_2/kernel": ("time_embedding.linear_2.weight", t_dense),
        "time_embedding/linear_2/bias": ("time_embedding.linear_2.bias", t_id),
        "conv_norm_out/scale": ("conv_norm_out.weight", t_id),
        "conv_norm_out/bias": ("conv_norm_out.bias", t_id),
        "conv_out/kernel": ("conv_out.weight", t_conv),
        "conv_out/bias": ("conv_out.bias", t_id),
    }
    n = len(config.block_out_channels)
    L = config.layers_per_block
    depth = config.transformer_depth
    for bi in range(n):
        for li in range(L):
            ours, hf = f"down_{bi}_{li}", f"down_blocks.{bi}"
            rules.update(_resnet_rules(f"{ours}_resnet", f"{hf}.resnets.{li}"))
            if config.down_block_has_attn[bi]:
                rules.update(_spatial_transformer_rules(
                    f"{ours}_attn", f"{hf}.attentions.{li}", depth))
            rules.update(_motion_rules(f"{ours}_motion", f"{hf}.motion_modules.{li}"))
        if bi < n - 1:
            rules.update(_resample_rules(f"down_{bi}_downsample",
                                         f"down_blocks.{bi}.downsamplers.0"))
    rules.update(_resnet_rules("mid_resnet_0", "mid_block.resnets.0"))
    rules.update(_resnet_rules("mid_resnet_1", "mid_block.resnets.1"))
    rules.update(_spatial_transformer_rules("mid_attn", "mid_block.attentions.0",
                                            depth))
    rules.update(_motion_rules("mid_motion", "mid_block.motion_modules.0"))
    for bi in range(n):
        for li in range(L + 1):
            ours, hf = f"up_{bi}_{li}", f"up_blocks.{bi}"
            rules.update(_resnet_rules(f"{ours}_resnet", f"{hf}.resnets.{li}"))
            if config.up_block_has_attn[bi]:
                rules.update(_spatial_transformer_rules(
                    f"{ours}_attn", f"{hf}.attentions.{li}", depth))
            rules.update(_motion_rules(f"{ours}_motion", f"{hf}.motion_modules.{li}"))
        if bi < n - 1:
            rules.update(_resample_rules(f"up_{bi}_upsample",
                                         f"up_blocks.{bi}.upsamplers.0"))
    return rules


# ----------------------------------------------------------------------
# AutoencoderKL
# ----------------------------------------------------------------------


def _vae_resnet_rules(prefix: str, hf_prefix: str) -> Rules:
    rules = {}
    for ours, theirs, tr in [
        ("norm1/scale", "norm1.weight", t_id),
        ("norm1/bias", "norm1.bias", t_id),
        ("conv1/kernel", "conv1.weight", t_conv),
        ("conv1/bias", "conv1.bias", t_id),
        ("norm2/scale", "norm2.weight", t_id),
        ("norm2/bias", "norm2.bias", t_id),
        ("conv2/kernel", "conv2.weight", t_conv),
        ("conv2/bias", "conv2.bias", t_id),
        ("conv_shortcut/kernel", "conv_shortcut.weight", t_conv),
        ("conv_shortcut/bias", "conv_shortcut.bias", t_id),
    ]:
        rules[f"{prefix}/{ours}"] = (f"{hf_prefix}.{theirs}", tr)
    return rules


def _vae_attn_rules(prefix: str, hf_prefix: str) -> Rules:
    """diffusers' post-0.18 linear attention layout."""
    rules = {
        f"{prefix}/group_norm/scale": (f"{hf_prefix}.group_norm.weight", t_id),
        f"{prefix}/group_norm/bias": (f"{hf_prefix}.group_norm.bias", t_id),
    }
    for ours, theirs in [("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                         ("to_out", "to_out.0")]:
        rules[f"{prefix}/{ours}/kernel"] = (f"{hf_prefix}.{theirs}.weight", t_dense)
        rules[f"{prefix}/{ours}/bias"] = (f"{hf_prefix}.{theirs}.bias", t_id)
    return rules


def vae_rules(config) -> Rules:
    """vdx AutoencoderKL path -> diffusers AutoencoderKL key: the encoder
    (vdx keeps quant_conv inside it) and the decoder."""
    n = len(config.block_out_channels)
    L = config.layers_per_block
    e = "encoder"
    rules: Rules = {
        f"{e}/conv_in/kernel": ("encoder.conv_in.weight", t_conv),
        f"{e}/conv_in/bias": ("encoder.conv_in.bias", t_id),
    }
    for bi in range(n):
        for li in range(L):
            rules.update(_vae_resnet_rules(
                f"{e}/down_{bi}_{li}", f"encoder.down_blocks.{bi}.resnets.{li}"))
        if bi < n - 1:
            hf = f"encoder.down_blocks.{bi}.downsamplers.0.conv"
            rules[f"{e}/down_{bi}_downsample/kernel"] = (f"{hf}.weight", t_conv)
            rules[f"{e}/down_{bi}_downsample/bias"] = (f"{hf}.bias", t_id)
    rules.update(_vae_resnet_rules(f"{e}/mid/resnet_0", "encoder.mid_block.resnets.0"))
    rules.update(_vae_resnet_rules(f"{e}/mid/resnet_1", "encoder.mid_block.resnets.1"))
    rules.update(_vae_attn_rules(f"{e}/mid/attn", "encoder.mid_block.attentions.0"))
    rules[f"{e}/conv_norm_out/scale"] = ("encoder.conv_norm_out.weight", t_id)
    rules[f"{e}/conv_norm_out/bias"] = ("encoder.conv_norm_out.bias", t_id)
    rules[f"{e}/conv_out/kernel"] = ("encoder.conv_out.weight", t_conv)
    rules[f"{e}/conv_out/bias"] = ("encoder.conv_out.bias", t_id)
    rules[f"{e}/quant_conv/kernel"] = ("quant_conv.weight", t_conv)
    rules[f"{e}/quant_conv/bias"] = ("quant_conv.bias", t_id)
    d = "decoder"
    rules.update({
        f"{d}/post_quant_conv/kernel": ("post_quant_conv.weight", t_conv),
        f"{d}/post_quant_conv/bias": ("post_quant_conv.bias", t_id),
        f"{d}/conv_in/kernel": ("decoder.conv_in.weight", t_conv),
        f"{d}/conv_in/bias": ("decoder.conv_in.bias", t_id),
    })
    rules.update(_vae_resnet_rules(f"{d}/mid/resnet_0", "decoder.mid_block.resnets.0"))
    rules.update(_vae_resnet_rules(f"{d}/mid/resnet_1", "decoder.mid_block.resnets.1"))
    rules.update(_vae_attn_rules(f"{d}/mid/attn", "decoder.mid_block.attentions.0"))
    for bi in range(n):
        for li in range(L + 1):
            rules.update(_vae_resnet_rules(
                f"{d}/up_{bi}_{li}", f"decoder.up_blocks.{bi}.resnets.{li}"))
        if bi < n - 1:
            rules.update(_resample_rules(f"{d}/up_{bi}_upsample",
                                         f"decoder.up_blocks.{bi}.upsamplers.0"))
    rules[f"{d}/conv_norm_out/scale"] = ("decoder.conv_norm_out.weight", t_id)
    rules[f"{d}/conv_norm_out/bias"] = ("decoder.conv_norm_out.bias", t_id)
    rules[f"{d}/conv_out/kernel"] = ("decoder.conv_out.weight", t_conv)
    rules[f"{d}/conv_out/bias"] = ("decoder.conv_out.bias", t_id)
    return rules


# ----------------------------------------------------------------------
# CLIP text tower
# ----------------------------------------------------------------------


def clip_text_rules(config) -> Rules:
    """vdx CLIPTextModel path -> transformers CLIPTextModel key."""
    P = "text_model"
    rules: Rules = {
        "token_embedding/embedding": (f"{P}.embeddings.token_embedding.weight", t_id),
        "position_embedding": (f"{P}.embeddings.position_embedding.weight", t_id),
        "final_layer_norm/scale": (f"{P}.final_layer_norm.weight", t_id),
        "final_layer_norm/bias": (f"{P}.final_layer_norm.bias", t_id),
    }
    for i in range(config.num_layers):
        lp = f"layers_{i}"
        hp = f"{P}.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            rules[f"{lp}/{ln}/scale"] = (f"{hp}.{ln}.weight", t_id)
            rules[f"{lp}/{ln}/bias"] = (f"{hp}.{ln}.bias", t_id)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rules[f"{lp}/self_attn/{proj}/kernel"] = (
                f"{hp}.self_attn.{proj}.weight", t_dense)
            rules[f"{lp}/self_attn/{proj}/bias"] = (
                f"{hp}.self_attn.{proj}.bias", t_id)
        for fc in ("fc1", "fc2"):
            rules[f"{lp}/{fc}/kernel"] = (f"{hp}.mlp.{fc}.weight", t_dense)
            rules[f"{lp}/{fc}/bias"] = (f"{hp}.mlp.{fc}.bias", t_id)
    return rules


# ----------------------------------------------------------------------
# ModelScope UNet3D (diffusers' UNet3DConditionModel)
# ----------------------------------------------------------------------


def _temporal_conv_rules(prefix: str, hf_prefix: str) -> Rules:
    """TemporalConvLayer: conv{1..4} = (GroupNorm, SiLU, Conv3d)."""
    rules = {}
    for i in range(4):
        rules[f"{prefix}/norm{i}/scale"] = (f"{hf_prefix}.conv{i + 1}.0.weight", t_id)
        rules[f"{prefix}/norm{i}/bias"] = (f"{hf_prefix}.conv{i + 1}.0.bias", t_id)
        rules[f"{prefix}/conv{i}/kernel"] = (f"{hf_prefix}.conv{i + 1}.2.weight", t_conv3d)
        rules[f"{prefix}/conv{i}/bias"] = (f"{hf_prefix}.conv{i + 1}.2.bias", t_id)
    return rules


def unet3d_rules(config) -> Rules:
    """vdx UNet3D path -> diffusers UNet3DConditionModel key: per layer
    resnet, temp_conv, attention, temp_attention, plus transformer_in."""
    rules: Rules = {
        "conv_in/kernel": ("conv_in.weight", t_conv),
        "conv_in/bias": ("conv_in.bias", t_id),
        "time_embedding/linear_1/kernel": ("time_embedding.linear_1.weight", t_dense),
        "time_embedding/linear_1/bias": ("time_embedding.linear_1.bias", t_id),
        "time_embedding/linear_2/kernel": ("time_embedding.linear_2.weight", t_dense),
        "time_embedding/linear_2/bias": ("time_embedding.linear_2.bias", t_id),
        "conv_norm_out/scale": ("conv_norm_out.weight", t_id),
        "conv_norm_out/bias": ("conv_norm_out.bias", t_id),
        "conv_out/kernel": ("conv_out.weight", t_conv),
        "conv_out/bias": ("conv_out.bias", t_id),
    }
    rules.update(_motion_rules("transformer_in", "transformer_in"))
    n = len(config.block_out_channels)
    L = config.layers_per_block

    def layer(ours, base, li, has_attn):
        rules.update(_resnet_rules(f"{ours}_resnet", f"{base}.resnets.{li}"))
        rules.update(_temporal_conv_rules(f"{ours}_tconv", f"{base}.temp_convs.{li}"))
        if has_attn:
            rules.update(_spatial_transformer_rules(f"{ours}_attn",
                                                    f"{base}.attentions.{li}"))
            rules.update(_motion_rules(f"{ours}_tattn",
                                       f"{base}.temp_attentions.{li}"))

    for bi in range(n):
        for li in range(L):
            layer(f"down_{bi}_{li}", f"down_blocks.{bi}", li,
                  config.down_block_has_attn[bi])
        if bi < n - 1:
            rules.update(_resample_rules(f"down_{bi}_downsample",
                                         f"down_blocks.{bi}.downsamplers.0"))
    layer("mid_0", "mid_block", 0, True)
    rules.update(_resnet_rules("mid_resnet_1", "mid_block.resnets.1"))
    rules.update(_temporal_conv_rules("mid_tconv_1", "mid_block.temp_convs.1"))
    for bi in range(n):
        for li in range(L + 1):
            layer(f"up_{bi}_{li}", f"up_blocks.{bi}", li,
                  config.up_block_has_attn[bi])
        if bi < n - 1:
            rules.update(_resample_rules(f"up_{bi}_upsample",
                                         f"up_blocks.{bi}.upsamplers.0"))
    return rules


# ----------------------------------------------------------------------
# SVD UNetSpatioTemporal (diffusers' UNetSpatioTemporalConditionModel)
# ----------------------------------------------------------------------


def _svd_res_rules(prefix: str, hf_prefix: str) -> Rules:
    """SpatioTemporalResBlock: spatial resnet, temporal 3x1x1 resnet, mixer."""
    rules = _resnet_rules(f"{prefix}/spatial", f"{hf_prefix}.spatial_res_block")
    for ours, theirs, tr in [
        ("tnorm1/scale", "temporal_res_block.norm1.weight", t_id),
        ("tnorm1/bias", "temporal_res_block.norm1.bias", t_id),
        ("tconv1/kernel", "temporal_res_block.conv1.weight", t_conv3d),
        ("tconv1/bias", "temporal_res_block.conv1.bias", t_id),
        ("ttime_emb_proj/kernel", "temporal_res_block.time_emb_proj.weight", t_dense),
        ("ttime_emb_proj/bias", "temporal_res_block.time_emb_proj.bias", t_id),
        ("tnorm2/scale", "temporal_res_block.norm2.weight", t_id),
        ("tnorm2/bias", "temporal_res_block.norm2.bias", t_id),
        ("tconv2/kernel", "temporal_res_block.conv2.weight", t_conv3d),
        ("tconv2/bias", "temporal_res_block.conv2.bias", t_id),
        ("mix/mix_factor", "time_mixer.mix_factor", t_id),
    ]:
        rules[f"{prefix}/{ours}"] = (f"{hf_prefix}.{theirs}", tr)
    return rules


def _svd_attn_rules(prefix: str, hf_prefix: str) -> Rules:
    """TransformerSpatioTemporal: the spatial and temporal block pair."""
    rules = {
        f"{prefix}/norm/scale": (f"{hf_prefix}.norm.weight", t_id),
        f"{prefix}/norm/bias": (f"{hf_prefix}.norm.bias", t_id),
        f"{prefix}/proj_in/kernel": (f"{hf_prefix}.proj_in.weight", t_dense),
        f"{prefix}/proj_in/bias": (f"{hf_prefix}.proj_in.bias", t_id),
        f"{prefix}/proj_out/kernel": (f"{hf_prefix}.proj_out.weight", t_dense),
        f"{prefix}/proj_out/bias": (f"{hf_prefix}.proj_out.bias", t_id),
        f"{prefix}/mix/mix_factor": (f"{hf_prefix}.time_mixer.mix_factor", t_id),
    }
    rules.update(_transformer_block_rules(
        f"{prefix}/spatial_block", f"{hf_prefix}.transformer_blocks.0"))
    rules.update(_transformer_block_rules(
        f"{prefix}/temporal_block", f"{hf_prefix}.temporal_transformer_blocks.0"))
    return rules


def svd_unet_rules(config) -> Rules:
    """vdx UNetSpatioTemporal path -> diffusers SVD UNet key."""
    rules: Rules = {
        "conv_in/kernel": ("conv_in.weight", t_conv),
        "conv_in/bias": ("conv_in.bias", t_id),
        "conv_norm_out/scale": ("conv_norm_out.weight", t_id),
        "conv_norm_out/bias": ("conv_norm_out.bias", t_id),
        "conv_out/kernel": ("conv_out.weight", t_conv),
        "conv_out/bias": ("conv_out.bias", t_id),
    }
    for emb in ("time_embedding", "add_embedding"):
        for i in (1, 2):
            rules[f"{emb}/linear_{i}/kernel"] = (f"{emb}.linear_{i}.weight", t_dense)
            rules[f"{emb}/linear_{i}/bias"] = (f"{emb}.linear_{i}.bias", t_id)
    n = len(config.block_out_channels)
    L = config.layers_per_block
    for bi in range(n):
        for li in range(L):
            rules.update(_svd_res_rules(f"down_{bi}_{li}_res",
                                        f"down_blocks.{bi}.resnets.{li}"))
            if config.down_block_has_attn[bi]:
                rules.update(_svd_attn_rules(f"down_{bi}_{li}_attn",
                                             f"down_blocks.{bi}.attentions.{li}"))
        if bi < n - 1:
            rules.update(_resample_rules(f"down_{bi}_downsample",
                                         f"down_blocks.{bi}.downsamplers.0"))
    rules.update(_svd_res_rules("mid_0_res", "mid_block.resnets.0"))
    rules.update(_svd_attn_rules("mid_0_attn", "mid_block.attentions.0"))
    rules.update(_svd_res_rules("mid_res_1", "mid_block.resnets.1"))
    for bi in range(n):
        for li in range(L + 1):
            rules.update(_svd_res_rules(f"up_{bi}_{li}_res",
                                        f"up_blocks.{bi}.resnets.{li}"))
            if config.up_block_has_attn[bi]:
                rules.update(_svd_attn_rules(f"up_{bi}_{li}_attn",
                                             f"up_blocks.{bi}.attentions.{li}"))
        if bi < n - 1:
            rules.update(_resample_rules(f"up_{bi}_upsample",
                                         f"up_blocks.{bi}.upsamplers.0"))
    return rules


# ----------------------------------------------------------------------
# SVD temporal decoder (diffusers' AutoencoderKLTemporalDecoder)
# ----------------------------------------------------------------------


def _tdec_res_rules(prefix: str, hf_prefix: str) -> Rules:
    """_DecoderSTResBlock: spatial resnet (no temb), temporal resnet, mixer."""
    rules = _vae_resnet_rules(f"{prefix}/spatial", f"{hf_prefix}.spatial_res_block")
    for ours, theirs, tr in [
        ("tnorm1/scale", "temporal_res_block.norm1.weight", t_id),
        ("tnorm1/bias", "temporal_res_block.norm1.bias", t_id),
        ("tconv1/kernel", "temporal_res_block.conv1.weight", t_conv3d),
        ("tconv1/bias", "temporal_res_block.conv1.bias", t_id),
        ("tnorm2/scale", "temporal_res_block.norm2.weight", t_id),
        ("tnorm2/bias", "temporal_res_block.norm2.bias", t_id),
        ("tconv2/kernel", "temporal_res_block.conv2.weight", t_conv3d),
        ("tconv2/bias", "temporal_res_block.conv2.bias", t_id),
        ("mix_factor", "time_mixer.mix_factor", t_id),
    ]:
        rules[f"{prefix}/{ours}"] = (f"{hf_prefix}.{theirs}", tr)
    return rules


def temporal_decoder_rules(config) -> Rules:
    """vdx TemporalDecoder path -> diffusers temporal-decoder key."""
    rules: Rules = {
        "conv_in/kernel": ("decoder.conv_in.weight", t_conv),
        "conv_in/bias": ("decoder.conv_in.bias", t_id),
        "conv_norm_out/scale": ("decoder.conv_norm_out.weight", t_id),
        "conv_norm_out/bias": ("decoder.conv_norm_out.bias", t_id),
        "conv_out/kernel": ("decoder.conv_out.weight", t_conv),
        "conv_out/bias": ("decoder.conv_out.bias", t_id),
        "time_conv_out/kernel": ("decoder.time_conv_out.weight", t_conv3d),
        "time_conv_out/bias": ("decoder.time_conv_out.bias", t_id),
    }
    rules.update(_tdec_res_rules("mid_resnet_0", "decoder.mid_block.resnets.0"))
    rules.update(_tdec_res_rules("mid_resnet_1", "decoder.mid_block.resnets.1"))
    rules.update(_vae_attn_rules("mid_attn", "decoder.mid_block.attentions.0"))
    n = len(config.block_out_channels)
    for bi in range(n):
        for li in range(config.layers_per_block + 1):
            rules.update(_tdec_res_rules(f"up_{bi}_{li}",
                                         f"decoder.up_blocks.{bi}.resnets.{li}"))
        if bi < n - 1:
            rules.update(_resample_rules(f"up_{bi}_upsample",
                                         f"decoder.up_blocks.{bi}.upsamplers.0"))
    return rules


# ----------------------------------------------------------------------
# CLIP vision tower (transformers' CLIPVisionModelWithProjection)
# ----------------------------------------------------------------------


def clip_vision_rules(config) -> Rules:
    V = "vision_model"
    rules: Rules = {
        "patch_embed/kernel": (f"{V}.embeddings.patch_embedding.weight", t_conv),
        "class_embedding": (f"{V}.embeddings.class_embedding", t_id),
        "position_embedding": (f"{V}.embeddings.position_embedding.weight", t_id),
        # transformers' historical key spelling is "pre_layrnorm"
        "pre_ln/scale": (f"{V}.pre_layrnorm.weight", t_id),
        "pre_ln/bias": (f"{V}.pre_layrnorm.bias", t_id),
        "post_ln/scale": (f"{V}.post_layernorm.weight", t_id),
        "post_ln/bias": (f"{V}.post_layernorm.bias", t_id),
        "visual_projection/kernel": ("visual_projection.weight", t_dense),
    }
    for i in range(config.num_layers):
        lp, hp = f"layers_{i}", f"{V}.encoder.layers.{i}"
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            rules[f"{lp}/{ours}/scale"] = (f"{hp}.{theirs}.weight", t_id)
            rules[f"{lp}/{ours}/bias"] = (f"{hp}.{theirs}.bias", t_id)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rules[f"{lp}/{proj}/kernel"] = (f"{hp}.self_attn.{proj}.weight", t_dense)
            rules[f"{lp}/{proj}/bias"] = (f"{hp}.self_attn.{proj}.bias", t_id)
        for fc in ("fc1", "fc2"):
            rules[f"{lp}/{fc}/kernel"] = (f"{hp}.mlp.{fc}.weight", t_dense)
            rules[f"{lp}/{fc}/bias"] = (f"{hp}.mlp.{fc}.bias", t_id)
    return rules


# ----------------------------------------------------------------------
# Latte DiT (diffusers' LatteTransformer3DModel, the adaLN excepted)
# ----------------------------------------------------------------------


def latte_dit_rules(config) -> Rules:
    """vdx LatteDiT path -> the port's key. diffusers' names throughout
    but the adaLN: vdx's per-block ``adaln/proj`` maps one to one onto the
    port-owned ``<block>.adaln.proj`` (vdx folds diffusers' global
    ``adaln_single.linear`` and each block's ``scale_shift_table`` into
    it, a two-tensor rule that does not run backwards;
    :func:`fold_latte_adaln` does that fold for a diffusers checkpoint)."""
    rules: Rules = {
        "patch_embed/kernel": ("pos_embed.proj.weight",
                               patch_conv(config.patch_size, config.in_channels)),
        "patch_embed/bias": ("pos_embed.proj.bias", t_id),
        "final_scale_shift_table": ("scale_shift_table", t_id),
        "final_proj/kernel": ("proj_out.weight", t_dense),
        "final_proj/bias": ("proj_out.bias", t_id),
    }
    te = "adaln_single.emb.timestep_embedder"
    for i in (1, 2):
        rules[f"t_proj_{i}/kernel"] = (f"{te}.linear_{i}.weight", t_dense)
        rules[f"t_proj_{i}/bias"] = (f"{te}.linear_{i}.bias", t_id)
    for i in range(config.depth):
        bp = f"blocks_{i}"
        hp = (f"transformer_blocks.{i // 2}" if i % 2 == 0
              else f"temporal_transformer_blocks.{i // 2}")
        rules[f"{bp}/adaln/proj/kernel"] = (f"{hp}.adaln.proj.weight", t_dense)
        rules[f"{bp}/adaln/proj/bias"] = (f"{hp}.adaln.proj.bias", t_id)
        for ours, theirs in (("attn", "attn1"), ("cross_attn", "attn2")):
            for proj in ("to_q", "to_k", "to_v"):
                rules[f"{bp}/{ours}/{proj}/kernel"] = (
                    f"{hp}.{theirs}.{proj}.weight", t_dense)
            rules[f"{bp}/{ours}/to_out/kernel"] = (
                f"{hp}.{theirs}.to_out.0.weight", t_dense)
            rules[f"{bp}/{ours}/to_out/bias"] = (f"{hp}.{theirs}.to_out.0.bias", t_id)
        rules[f"{bp}/mlp/net_0/proj/kernel"] = (f"{hp}.ff.net.0.proj.weight", t_dense)
        rules[f"{bp}/mlp/net_0/proj/bias"] = (f"{hp}.ff.net.0.proj.bias", t_id)
        rules[f"{bp}/mlp/net_2/kernel"] = (f"{hp}.ff.net.2.weight", t_dense)
        rules[f"{bp}/mlp/net_2/bias"] = (f"{hp}.ff.net.2.bias", t_id)
    return rules


def fold_latte_adaln(state_dict: Mapping, config) -> dict:
    """A diffusers Latte state_dict with its adaLN in the port's layout, as
    vdx's rule folds it: every block's ``adaln.proj.weight`` is the global
    ``adaln_single.linear.weight`` and its bias the global bias plus the
    block's ``scale_shift_table`` flattened. The folded keys leave the
    dict; a dict without ``adaln_single.linear.weight`` comes back as it
    is."""
    if "adaln_single.linear.weight" not in state_dict:
        return dict(state_dict)
    sd = dict(state_dict)
    w = sd.pop("adaln_single.linear.weight")
    b = sd.pop("adaln_single.linear.bias")
    for i in range(config.depth):
        hp = (f"transformer_blocks.{i // 2}" if i % 2 == 0
              else f"temporal_transformer_blocks.{i // 2}")
        table = sd.pop(f"{hp}.scale_shift_table")
        sd[f"{hp}.adaln.proj.weight"] = w
        sd[f"{hp}.adaln.proj.bias"] = b + table.reshape(-1)
    return sd


# ----------------------------------------------------------------------
# T5 encoder (transformers' T5EncoderModel), CogVideoX's text tower
# ----------------------------------------------------------------------


def t5_encoder_rules(config) -> Rules:
    rules: Rules = {
        "token_embedding/embedding": ("shared.weight", t_id),
        "final_norm/scale": ("encoder.final_layer_norm.weight", t_id),
    }
    for i in range(config.num_layers):
        lp, hb = f"layers_{i}", f"encoder.block.{i}"
        rules[f"{lp}/norm1/scale"] = (f"{hb}.layer.0.layer_norm.weight", t_id)
        rules[f"{lp}/norm2/scale"] = (f"{hb}.layer.1.layer_norm.weight", t_id)
        for p in ("q", "k", "v", "o"):
            rules[f"{lp}/attn/{p}/kernel"] = (
                f"{hb}.layer.0.SelfAttention.{p}.weight", t_dense)
        if i == 0:
            rules[f"{lp}/attn/relative_attention_bias"] = (
                f"{hb}.layer.0.SelfAttention.relative_attention_bias.weight", t_id)
        for ff in ("wi_0", "wi_1", "wo"):
            rules[f"{lp}/{ff}/kernel"] = (
                f"{hb}.layer.1.DenseReluDense.{ff}.weight", t_dense)
    return rules


# ----------------------------------------------------------------------
# CogVideoX DiT (diffusers' CogVideoXTransformer3DModel)
# ----------------------------------------------------------------------


def cogvideox_dit_rules(config) -> Rules:
    rules: Rules = {
        "patch_embed/kernel": ("patch_embed.proj.weight",
                               patch_conv(config.patch_size, config.in_channels)),
        "patch_embed/bias": ("patch_embed.proj.bias", t_id),
        "text_proj/kernel": ("patch_embed.text_proj.weight", t_dense),
        "text_proj/bias": ("patch_embed.text_proj.bias", t_id),
        "final_norm/scale": ("norm_final.weight", t_id),
        "final_norm/bias": ("norm_final.bias", t_id),
        "norm_out_linear/kernel": ("norm_out.linear.weight", t_dense),
        "norm_out_linear/bias": ("norm_out.linear.bias", t_id),
        "norm_out/scale": ("norm_out.norm.weight", t_id),
        "norm_out/bias": ("norm_out.norm.bias", t_id),
        "final_proj/kernel": ("proj_out.weight", t_dense),
        "final_proj/bias": ("proj_out.bias", t_id),
    }
    for i in (1, 2):
        rules[f"time_embedding/linear_{i}/kernel"] = (
            f"time_embedding.linear_{i}.weight", t_dense)
        rules[f"time_embedding/linear_{i}/bias"] = (
            f"time_embedding.linear_{i}.bias", t_id)
    for i in range(config.depth):
        bp, hp = f"blocks_{i}", f"transformer_blocks.{i}"
        for nz in ("norm1", "norm2"):
            rules[f"{bp}/{nz}/linear/kernel"] = (f"{hp}.{nz}.linear.weight", t_dense)
            rules[f"{bp}/{nz}/linear/bias"] = (f"{hp}.{nz}.linear.bias", t_id)
            rules[f"{bp}/{nz}/norm/scale"] = (f"{hp}.{nz}.norm.weight", t_id)
            rules[f"{bp}/{nz}/norm/bias"] = (f"{hp}.{nz}.norm.bias", t_id)
        for proj in ("to_q", "to_k", "to_v"):
            rules[f"{bp}/attn/{proj}/kernel"] = (f"{hp}.attn1.{proj}.weight", t_dense)
            rules[f"{bp}/attn/{proj}/bias"] = (f"{hp}.attn1.{proj}.bias", t_id)
        rules[f"{bp}/attn/to_out/kernel"] = (f"{hp}.attn1.to_out.0.weight", t_dense)
        rules[f"{bp}/attn/to_out/bias"] = (f"{hp}.attn1.to_out.0.bias", t_id)
        for qk in ("norm_q", "norm_k"):
            rules[f"{bp}/attn/{qk}/scale"] = (f"{hp}.attn1.{qk}.weight", t_id)
            rules[f"{bp}/attn/{qk}/bias"] = (f"{hp}.attn1.{qk}.bias", t_id)
        rules[f"{bp}/ff_in/kernel"] = (f"{hp}.ff.net.0.proj.weight", t_dense)
        rules[f"{bp}/ff_in/bias"] = (f"{hp}.ff.net.0.proj.bias", t_id)
        rules[f"{bp}/ff_out/kernel"] = (f"{hp}.ff.net.2.weight", t_dense)
        rules[f"{bp}/ff_out/bias"] = (f"{hp}.ff.net.2.bias", t_id)
    return rules


# ----------------------------------------------------------------------
# CogVideoX 3D causal VAE (diffusers' AutoencoderKLCogVideoX)
# ----------------------------------------------------------------------


def _causal_res_rules(prefix: str, hf_prefix: str) -> Rules:
    rules = {}
    for ours, theirs, tr in [
        ("norm1/scale", "norm1.weight", t_id),
        ("norm1/bias", "norm1.bias", t_id),
        ("conv1/conv/kernel", "conv1.conv.weight", t_conv3d),
        ("conv1/conv/bias", "conv1.conv.bias", t_id),
        ("norm2/scale", "norm2.weight", t_id),
        ("norm2/bias", "norm2.bias", t_id),
        ("conv2/conv/kernel", "conv2.conv.weight", t_conv3d),
        ("conv2/conv/bias", "conv2.conv.bias", t_id),
        ("shortcut/kernel", "conv_shortcut.weight", t_conv3d_1x1_dense),
        ("shortcut/bias", "conv_shortcut.bias", t_id),
    ]:
        rules[f"{prefix}/{ours}"] = (f"{hf_prefix}.{theirs}", tr)
    return rules


def _causal_conv_rules(ours: str, hf: str) -> Rules:
    return {f"{ours}/conv/kernel": (f"{hf}.conv.weight", t_conv3d),
            f"{ours}/conv/bias": (f"{hf}.conv.bias", t_id)}


def causal_vae_encoder_rules(config) -> Rules:
    rules: Rules = {
        "norm_out/scale": ("encoder.norm_out.weight", t_id),
        "norm_out/bias": ("encoder.norm_out.bias", t_id),
    }
    rules.update(_causal_conv_rules("conv_in", "encoder.conv_in"))
    rules.update(_causal_conv_rules("conv_out", "encoder.conv_out"))
    n = len(config.block_out_channels)
    for bi in range(n):
        for li in range(config.layers_per_block):
            rules.update(_causal_res_rules(
                f"down_{bi}_{li}", f"encoder.down_blocks.{bi}.resnets.{li}"))
        if bi < n - 1:
            rules.update(_causal_conv_rules(
                f"down_{bi}_ds", f"encoder.down_blocks.{bi}.downsamplers.0"))
    rules.update(_causal_res_rules("mid_0", "encoder.mid_block.resnets.0"))
    rules.update(_causal_res_rules("mid_1", "encoder.mid_block.resnets.1"))
    return rules


def causal_vae_decoder_rules(config) -> Rules:
    """vdx's decoder norms are plain GroupNorms; each maps onto diffusers'
    spatial norm's ``norm_layer`` at the output, as vdx's rule."""
    rules: Rules = {
        "norm_out/scale": ("decoder.norm_out.norm_layer.weight", t_id),
        "norm_out/bias": ("decoder.norm_out.norm_layer.bias", t_id),
    }
    rules.update(_causal_conv_rules("conv_in", "decoder.conv_in"))
    rules.update(_causal_conv_rules("conv_out", "decoder.conv_out"))
    rules.update(_causal_res_rules("mid_0", "decoder.mid_block.resnets.0"))
    rules.update(_causal_res_rules("mid_1", "decoder.mid_block.resnets.1"))
    n = len(config.block_out_channels)
    for bi in range(n):
        for li in range(config.layers_per_block + 1):
            rules.update(_causal_res_rules(
                f"up_{bi}_{li}", f"decoder.up_blocks.{bi}.resnets.{li}"))
        if bi < n - 1:
            rules.update(_causal_conv_rules(
                f"up_{bi}_us", f"decoder.up_blocks.{bi}.upsamplers.0"))
    return rules


# ----------------------------------------------------------------------
# application
# ----------------------------------------------------------------------

_COMPONENT_RULES = {"vae": vae_rules, "text": clip_text_rules,
                    "tdec": temporal_decoder_rules, "vision": clip_vision_rules,
                    "t5": t5_encoder_rules, "vae_enc": causal_vae_encoder_rules,
                    "vae_dec": causal_vae_decoder_rules}
# the denoiser's rules by its config's class (vdx's and the port's config
# classes share their names)
_DENOISER_RULES = {"UNetMotionConfig": unet_motion_rules,
                   "UNet3DConfig": unet3d_rules,
                   "SVDUNetConfig": svd_unet_rules,
                   "LatteConfig": latte_dit_rules,
                   "CogVideoXConfig": cogvideox_dit_rules}


def rules_for(denoiser) -> Rules:
    """The conversion rules of a built denoiser module (by its config's
    class: UNetMotion, UNet3D, the SVD UNet, Latte or CogVideoX)."""
    return _DENOISER_RULES[type(denoiser.config).__name__](denoiser.config)


def flatten_params(params: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested parameter mapping -> {slash/path: leaf}, dropping a leading
    'params' collection."""
    if not prefix and set(params) == {"params"}:
        params = params["params"]
    flat = {}
    for key, val in params.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_params(val, path))
        else:
            flat[path] = val
    return flat


def state_from_rules(flat_params: Mapping[str, np.ndarray],
                     rules: Rules) -> Dict[str, torch.Tensor]:
    """Flattened vdx leaves -> {torch key: fp32 tensor} through ``rules``
    run backwards. Every leaf needs a rule."""
    state, unmatched = {}, []
    for path, leaf in flat_params.items():
        if path not in rules:
            unmatched.append(path)
            continue
        hf_key, tr = rules[path]
        w = np.array(_INVERSE[tr](leaf), dtype=np.float32, order="C")
        state[hf_key] = torch.from_numpy(w)
    if unmatched:
        raise KeyError(f"no rule for {len(unmatched)} leaves, e.g. {unmatched[:5]}")
    return state


def params_from_jax(flat_params: Mapping[str, np.ndarray], component: str,
                    config) -> Dict[str, torch.Tensor]:
    """Flattened vdx parameters of one component ("unet" or "dit": the
    denoiser by ``config``'s class, UNetMotion, UNet3D, UNetSpatioTemporal,
    LatteDiT or CogVideoXDiT; "vae", "text", "tdec" for SVD's temporal
    decoder, "vision" for the CLIP vision tower, "t5", "vae_enc" and
    "vae_dec" for CogVideoX's T5 and causal VAE) -> the port module's
    state_dict (fp32 torch tensors, diffusers names)."""
    rules = (_DENOISER_RULES[type(config).__name__] if component in ("unet", "dit")
             else _COMPONENT_RULES[component])
    return state_from_rules(flat_params, rules(config))
