#!/usr/bin/env python3
"""Where the time goes in vdx_torch's AnimateDiff workload, on one GPU.

    python3 scripts/profile_torch_port.py

Builds the SD-1.5-width pipeline (bf16, random weights from seed 0, DDIM),
warms it up, then traces with ``torch.profiler`` one denoising step (one
CFG-batched UNet call over 2 x 16 frames at 64x64 latents) and one VAE
decode chunk (8 frames to 512x512). Prints, per phase, the wall time, the
summed device-kernel time by category and the device idle share
(1 - kernel time / wall time), then the top kernels by device time. The
categories are read off the kernel names.
"""

from __future__ import annotations

import collections
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
CATEGORIES = (  # (category, substrings of the kernel name), first match wins
    ("K1 flash attention (ours)", ("flash_dt_staticmax",)),
    ("K2/K3 GroupNorm (ours)", ("gn_group_kernel", "gn_stats_kernel",
                                "gn_finalize_kernel", "gn_apply_kernel")),
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

    pipe = AnimateDiffPipeline.with_random_params(
        seed=0, policy=BF16_POLICY, scheduler="ddim", device="cuda")
    with torch.inference_mode():
        ctx = pipe.encode_prompt("a corgi walking on the beach", "blurry")
        tables = pipe._get_tables(25)
        lat = pipe.initial_noise((1, 16, 64, 64, 4), 1234)
        z = lat[0, :8]

        def step():
            pipe.denoise_step(lat, 0, ctx, 7.5, True, tables)

        def decode():
            pipe.vae.decode(z)

        for _ in range(2):  # warm-up: kernel build, cuDNN plans, allocator
            step()
            decode()
        profile(step, "denoise step")
        profile(decode, "decode chunk")
    return 0


if __name__ == "__main__":
    sys.exit(main())
