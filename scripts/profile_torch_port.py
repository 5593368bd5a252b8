#!/usr/bin/env python3
"""Where the time goes in vdx_torch's workloads, on one GPU.

    python3 scripts/profile_torch_port.py                      # 512x512, DDIM
    python3 scripts/profile_torch_port.py --size 768 --scheduler euler
    python3 scripts/profile_torch_port.py --video2video         # + an encode chunk
    python3 scripts/profile_torch_port.py --family modelscope   # 256x256, DDIM
    python3 scripts/profile_torch_port.py --family svd          # 576x1024, EDM

Builds the family's full-width pipeline (bf16, random weights from seed
0), warms it up, then traces with ``torch.profiler`` one denoising step of
the sampler (one CFG-batched UNet call, the CFG combine and the update)
and one decode chunk. AnimateDiff: 2 x 16 frames at size/8 latents, an
8-frame VAE decode chunk, and with ``--video2video`` one 8-frame VAE
encode chunk. ModelScope (UNet3D): 2 x 16 frames, an 8-frame chunk.
SVD: 2 x 25 frames at 576x1024 with the conditioning concatenated, a
5-frame temporal-decoder chunk, and the image's conditioning (VAE encode
and CLIP vision). Prints, per phase, the wall time, the summed
device-kernel time by category and the device idle share (1 - kernel
time / wall time), then the top kernels by device time. The categories
are read off the kernel names.
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


def phases_of(args, torch):
    """-> [(fn, label)] of the family's traced phases."""
    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.pipelines.base import _Carry, _Request
    from vdx_torch.schedulers import get_sampler, is_multistep

    if args.family == "svd":
        import numpy as np

        from vdx_torch.pipelines import SVDImg2VidPipeline

        scheduler = args.scheduler or "edm"
        pipe = SVDImg2VidPipeline.with_random_params(
            seed=0, policy=BF16_POLICY, scheduler=scheduler, device="cuda")
        F_, H, W, chunk = 25, 576, 1024, 5
        print(f"svd {F_} x {H}x{W}, {scheduler}", flush=True)
        img = torch.rand((1, H, W, 3), device="cuda") * 2 - 1
        cond = (img, 6.0, 127.0, 0.02)
        shape = (1, F_, H // 8, W // 8, 4)
        prep = pipe._prepare_cond(1234, cond, shape)
        gs = np.linspace(1.0, 3.0, F_, dtype=np.float32).reshape(1, F_, 1, 1, 1)
        scale = torch.as_tensor(gs, device="cuda")
        den_args, concat, key = prep["den_args"], prep["concat"], prep["key"]

        def decode():
            pipe.temporal_decoder(z, chunk)

        extra = [(lambda: pipe._prepare_cond(1234, cond, shape),
                  "conditioning (VAE encode + CLIP vision)")]
    else:
        from vdx_torch.pipelines import (AnimateDiffPipeline,
                                         TextToVideoMSPipeline)

        ms = args.family == "modelscope"
        cls = TextToVideoMSPipeline if ms else AnimateDiffPipeline
        scheduler = args.scheduler or "ddim"
        pipe = cls.with_random_params(seed=0, policy=BF16_POLICY,
                                      scheduler=scheduler, device="cuda")
        size = args.size or (256 if ms else 512)
        F_, H, W, chunk = 16, size, size, 8
        print(f"{args.family} {F_} x {H}x{W}, {scheduler}", flush=True)
        ctx = pipe.encode_prompt("a corgi walking on the beach", "blurry")
        shape = (1, F_, H // 8, W // 8, 4)
        den_args, concat, key, scale = (ctx,), None, 1234, 7.5
        frames = torch.rand((chunk, H, W, 3), device="cuda") * 2 - 1

        def decode():
            pipe.vae.decode(z)

        extra = ([(lambda: pipe.vae.encode(frames), "encode chunk")]
                 if args.video2video else [])
    tables = pipe._get_tables(scheduler, 25)
    noise = pipe.initial_noise(shape, key)
    lat = noise * tables.init_noise_sigma
    z = noise[0, :chunk]
    req = _Request(None, True, scale, scheduler, tables, None, 25,
                   den_args=den_args, concat=concat)
    sampler = get_sampler(scheduler)

    def step():
        carry = _Carry(lat, sampler.init_state(lat)
                       if is_multistep(scheduler) else None)
        pipe._step(req, carry, pipe._eval(req, lat, 0), 0)

    return [(step, "denoise step"), (decode, "decode chunk")] + extra


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="animatediff",
                    choices=["animatediff", "modelscope", "svd"])
    ap.add_argument("--size", type=int, default=0,
                    help="frame height and width (text families; default "
                         "512 AnimateDiff, 256 ModelScope)")
    ap.add_argument("--scheduler", default=None,
                    help="default ddim (text families), edm (SVD)")
    ap.add_argument("--video2video", action="store_true",
                    help="AnimateDiff: also trace one VAE encode chunk")
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

    with torch.inference_mode():
        phases = phases_of(args, torch)
        for _ in range(2):  # warm-up: kernel build, cuDNN plans, allocator
            for fn, _ in phases:
                fn()
        for fn, label in phases:
            profile(fn, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
