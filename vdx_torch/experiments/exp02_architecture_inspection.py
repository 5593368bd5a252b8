"""Experiment 02: architecture inspection (port of
experiments/02_architecture_inspection.py).

Counts the UNet's parameters, partitions them into the motion modules and
the rest, counts the spatial transformers and the motion module groups,
and prints one motion block's structure. The UNet is built on the meta
device (shapes only, no memory), and each weight is counted under vdx's
parameter path (the conversion rules name both), so the report is vdx's,
groupings included.

    python -m vdx_torch.experiments.exp02_architecture_inspection [--tiny]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    import torch

    from vdx_torch.core.convert import unet_motion_rules
    from vdx_torch.models.unet_motion import UNetMotion, UNetMotionConfig

    cfg = UNetMotionConfig.tiny() if args.tiny else UNetMotionConfig.sd15()
    with torch.device("meta"):
        model = UNetMotion(cfg)
    # vdx's flattened tree paths, the "params" collection first
    vdx_path = {hf: f"params/{path}"
                for path, (hf, _) in unet_motion_rules(cfg).items()}

    total = 0
    temporal = 0
    spatial_attn_modules = set()
    temporal_modules = set()
    for key, param in model.state_dict().items():
        n = param.numel()
        total += n
        name = vdx_path[key]
        if "motion" in name:
            temporal += n
            temporal_modules.add(name.rsplit("/", 2)[0])
        if "_attn/" in name or name.endswith("_attn"):
            spatial_attn_modules.add(name.split("/blocks_")[0])

    print("=" * 60)
    print("UNetMotion architecture inspection")
    print("=" * 60)
    print(f"Total parameters:      {total / 1e6:,.1f}M")
    print(f"  Spatial (SD UNet):   {(total - temporal) / 1e6:,.1f}M")
    print(f"  Motion modules:      {temporal / 1e6:,.1f}M")
    print(f"Spatial attention transformer blocks: {len(spatial_attn_modules)}")
    print(f"Temporal (motion) module groups:      {len(temporal_modules)}")
    print(f"\nBlock channels: {cfg.block_out_channels}")
    print(f"Layers per block: {cfg.layers_per_block}")
    print(f"Attention heads: {cfg.attention_heads} (head_dim = C/heads)")
    print(f"Motion heads: {cfg.motion_heads}, max seq {cfg.motion_max_seq}")

    print("\n--- First motion module structure ---")
    print("TemporalTransformer3D")
    print("  norm (GroupNorm, stats over F,H,W jointly)")
    print("  proj_in (Dense C->C)")
    print("  blocks_0 (TemporalBlock)")
    print("    norm1 -> +sinusoidal frame PE -> attn1 (temporal self-attn)")
    print("    norm2 -> +sinusoidal frame PE -> attn2 (temporal self-attn)")
    print("    norm3 -> ff (GEGLU)")
    print("  proj_out (Dense C->C)")
    print("  residual add")


if __name__ == "__main__":
    main()
