"""Weights between vdx's parameter trees and the port's modules.

The port's modules use diffusers/transformers state_dict names and
torch-native shapes, so vdx's conversion rules (vdx/core/convert.py) name
the bridge. This module keeps its own copy of the rule tables it needs —
UNetMotion, the AutoencoderKL and the CLIP text tower — and runs
them backwards: :func:`params_from_jax` turns a flattened vdx parameter
tree (numpy leaves) into a state_dict for the port's module. The
families: UNetMotion, UNet3D (ModelScope) and UNetSpatioTemporal (SVD)
denoisers, the AutoencoderKL, SVD's temporal decoder, and the CLIP text
and vision towers.

Layout transforms (vdx <- torch):
  * Conv:   torch OIHW     -> flax HWIO   (``t_conv``)
  * Conv3d: torch OITHW    -> flax THWIO  (``t_conv3d``: the (3, 1, 1)
    frame convs)
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


# each rule's transform -> its inverse (vdx layout -> torch layout)
_INVERSE = {
    t_conv: lambda w: np.transpose(np.asarray(w), (3, 2, 0, 1)),
    t_conv3d: lambda w: np.transpose(np.asarray(w), (4, 3, 0, 1, 2)),
    t_dense: lambda w: np.transpose(np.asarray(w), (1, 0)),
    t_id: np.asarray,
}

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
# application
# ----------------------------------------------------------------------

_COMPONENT_RULES = {"vae": vae_rules, "text": clip_text_rules,
                    "tdec": temporal_decoder_rules, "vision": clip_vision_rules}
# the "unet" component's rules by its config's class (vdx's and the port's
# config classes share their names)
_DENOISER_RULES = {"UNetMotionConfig": unet_motion_rules,
                   "UNet3DConfig": unet3d_rules,
                   "SVDUNetConfig": svd_unet_rules}


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
    """Flattened vdx parameters of one component ("unet": UNetMotion,
    UNet3D or UNetSpatioTemporal by ``config``'s class; "vae", "text",
    "tdec" for SVD's temporal decoder, "vision" for the CLIP vision tower)
    -> the port module's state_dict (fp32 torch tensors, diffusers names)."""
    rules = (_DENOISER_RULES[type(config).__name__] if component == "unet"
             else _COMPONENT_RULES[component])
    return state_from_rules(flat_params, rules(config))
