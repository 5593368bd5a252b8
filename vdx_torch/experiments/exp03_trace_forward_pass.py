"""Experiment 03: trace the UNet forward pass (port of
experiments/03_trace_forward_pass.py).

Drives the ForwardTracer (vdx_torch.tracing) over one UNet forward of
zeros, classifies spatial against temporal attention by module name,
checks the [B*H*W, F, C] layout of the temporal attention's input, and
prints the resnet / spatial / temporal execution interleave. The port's
modules carry diffusers' names, which nest four levels deeper than vdx's
Flax paths: the trace depth is 7 where vdx's is 3, so that both reach the
attention modules.

    python -m vdx_torch.experiments.exp03_trace_forward_pass \\
        [--tiny] [--output DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

# vdx's trace depth 3 ("down_0_0_attn/blocks_0/attn1") in diffusers' names
# ("down_blocks.0.attentions.0.transformer_blocks.0.attn1")
TRACE_DEPTH = 7


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--output", default="outputs/03_traces")
    p.add_argument("--device", default="cuda",
                   help="torch device of the UNet (default cuda)")
    args = p.parse_args(argv)

    import torch

    from vdx_torch.core.dtypes import FP32_POLICY
    from vdx_torch.models.unet_motion import UNetMotion, UNetMotionConfig
    from vdx_torch.pipelines.base import random_init_
    from vdx_torch.tracing.tracer import ForwardTracer

    if args.tiny:
        cfg = UNetMotionConfig.tiny()
        B, F, H, W = 1, 4, 16, 16
        S_text = 7
    else:
        cfg = UNetMotionConfig.sd15()
        B, F, H, W = 1, 16, 64, 64  # the reference's trace shape (03:79-98)
        S_text = 77

    dev = torch.device(args.device)
    with torch.device("meta"):
        model = UNetMotion(cfg, policy=FP32_POLICY)
    model = model.to_empty(device=dev).eval()
    sample = torch.zeros((B, F, H, W, cfg.in_channels), device=dev)
    t = torch.tensor([500], device=dev)
    ctx = torch.zeros((B, S_text, cfg.cross_attention_dim), device=dev)

    print("Initialising model...")
    random_init_(model, torch.Generator(device=dev).manual_seed(0))

    tracer = ForwardTracer(model, trace_depth=TRACE_DEPTH)
    print("Tracing forward pass...")
    with torch.inference_mode():
        tracer.trace(sample, t, ctx)

    # ---- attention classification (reference 03:124-169) ----
    spatial, temporal = [], []
    for name, tr in tracer.traces.items():
        if tr.class_name != "Attention":
            continue
        (temporal if "motion" in name else spatial).append((name, tr))

    print("\n" + "=" * 60)
    print("ATTENTION MODULE ANALYSIS")
    print("=" * 60)
    print(f"Spatial attention modules:  {len(spatial)}")
    print(f"Temporal attention modules: {len(temporal)}")

    if temporal:
        name, tr = temporal[0]
        print(f"\n--- First temporal attention: {name}")
        print(f"Input shape:  {tr.input_shapes}")
        if tr.input_shapes and len(tr.input_shapes[0]) == 3:
            B_HW, Fr, C = tr.input_shapes[0]
            print("Interpretation:")
            print(f"  Batch*Height*Width: {B_HW}")
            print(f"  Num frames:         {Fr}")
            print(f"  Channels:           {C}")
            print(f"  -> each spatial position attends across {Fr} frames")

    # ---- execution interleave (reference 03:215-241) ----
    print("\n" + "=" * 60)
    print("SPATIAL vs TEMPORAL EXECUTION ORDER (first 50)")
    print("=" * 60)
    for i, name in enumerate(tracer.execution_order[:50]):
        tr = tracer.traces[name]
        if "motion" in name:
            prefix = "[TEMPORAL]"
        elif "attn" in name:
            prefix = "[SPATIAL] "
        elif "resnet" in name:
            prefix = "[RESNET]  "
        else:
            prefix = "          "
        print(f"{i:3d}. {prefix} {name:<55} {tr.class_name}")

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    tracer.save_report(out_dir / "unet_trace.txt")
    tracer.save_json(out_dir / "unet_trace.json")
    print(f"\nFull trace saved to {out_dir}/unet_trace.txt")


if __name__ == "__main__":
    main()
