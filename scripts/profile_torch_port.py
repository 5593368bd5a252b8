#!/usr/bin/env python3
"""Where the time goes in vdx_torch's AnimateDiff workload, on one GPU.

    python3 scripts/profile_torch_port.py                      # 512x512, DDIM
    python3 scripts/profile_torch_port.py --size 768 --scheduler euler
    python3 scripts/profile_torch_port.py --video2video         # + an encode chunk

Builds the SD-1.5-width pipeline (bf16, random weights from seed 0), warms
it up, then traces with ``torch.profiler`` one denoising step of the given
sampler (one CFG-batched UNet call over 2 x 16 frames at size/8 latents)
and one VAE decode chunk (8 frames to size x size); with
``--video2video`` also one VAE encode chunk (8 frames of size x size, the
video2video path's encoder). Prints, per phase, the wall time, the
summed device-kernel time by category and the device idle share
(1 - kernel time / wall time), then the top kernels by device time. The
categories are read off the kernel names.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (category, substrings of the kernel name), first match wins. K1' exp runs
# as K4's instance (flash_sm90_runmax), so the K4 category also takes its
# launches: only the Python counters (kernels.flash_attention.launch_counts)
# tell them apart. No timed path launches a K1'/K5 form.
CATEGORIES = (
    ("K1 flash attention (ours)", ("flash_sm90_static",)),
    ("K4 flash attention (ours)", ("flash_sm90_runmax",)),
    ("K1'/K5 flash attention forms (ours)", ("flash_sm90f_", "flash_mma_bf16",
                                             "flash_f32")),
    ("K2/K3 GroupNorm (ours)", ("gn_cluster_kernel", "gn_stream_stats_kernel",
                                "gn_stream_apply_kernel")),
    ("convolution", ("conv", "fprop", "dgrad", "winograd", "implicit")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90_", "cublas",
                "matmul")),
    ("softmax / reductions", ("softmax", "reduce", "norm")),
    ("copies / layout", ("copy", "cat", "transpose", "permute", "index",
                         "fill", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def profile(fn, label):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = collections.Counter()
    cats = collections.Counter()
    counts = collections.Counter()
    for ev in prof.events():
        dev_us = getattr(ev, "device_time", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time", 0.0)
        if ev.device_type.name != "CUDA" or not dev_us:
            continue
        kernels[ev.name] += dev_us / 1e3
        counts[ev.name] += 1
        cats[category(ev.name)] += dev_us / 1e3
    busy = sum(cats.values())
    print(f"[{label}] wall_ms={wall_ms:.2f} device_kernel_ms={busy:.2f} "
          f"idle_share={max(0.0, 1 - busy / wall_ms):.3f}", flush=True)
    for cat, ms in cats.most_common():
        print(f"[{label}]   {cat:28s} {ms:9.2f} ms  {ms / busy:6.1%}")
    for name, ms in kernels.most_common(12):
        print(f"[{label}]   top {ms:8.2f} ms x{counts[name]:<4d} {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512, help="frame height and width")
    ap.add_argument("--scheduler", default="ddim")
    ap.add_argument("--video2video", action="store_true",
                    help="also trace one VAE encode chunk")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
        flush=True)

    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.pipelines import AnimateDiffPipeline
    from vdx_torch.schedulers import get_sampler, is_multistep

    pipe = AnimateDiffPipeline.with_random_params(
        seed=0, policy=BF16_POLICY, scheduler=args.scheduler, device="cuda")
    print(f"{args.size}x{args.size}, {args.scheduler}", flush=True)
    with torch.inference_mode():
        ctx = pipe.encode_prompt("a corgi walking on the beach", "blurry")
        tables = pipe._get_tables(args.scheduler, 25)
        hw = args.size // pipe.vae.config.downscale
        noise = pipe.initial_noise((1, 16, hw, hw, 4), 1234)
        lat = noise * tables.init_noise_sigma
        state = (get_sampler(args.scheduler).init_state(lat)
                 if is_multistep(args.scheduler) else None)
        z = noise[0, :8]
        frames = torch.rand((8, args.size, args.size, 3), device="cuda") * 2 - 1

        def step():
            pipe.denoise_step(lat, 0, ctx, 7.5, True, args.scheduler, tables,
                              state)

        def decode():
            pipe.vae.decode(z)

        def encode():
            pipe.vae.encode(frames)

        phases = [(step, "denoise step"), (decode, "decode chunk")]
        if args.video2video:
            phases.append((encode, "encode chunk"))
        for _ in range(2):  # warm-up: kernel build, cuDNN plans, allocator
            for fn, _ in phases:
                fn()
        for fn, label in phases:
            profile(fn, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
