#!/usr/bin/env python3
"""Chip smoke run of vdx_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases, one flushed line each with its seconds:
  1. environment: torch, CUDA, nvidia-smi name and power limit
  2. build: one nvcc call over vdx_torch/csrc/*.cu (cached by source hash)
  3. kernels against their plain PyTorch versions at the main path's
     shapes: K1 (staticmax flash attention), K2 and K3 (fused GroupNorm);
     kernel, plain and library times (CUDA events) beside each bound
  4. init: full-width random weights generated on the card
  5. warm-up: the workload at 2 steps
  6. reference: one denoiser evaluation at the workload's first-step
     input, kernel path against the plain versions swapped in
  7. the timed call: AnimateDiff text-to-video at SD-1.5 width, 16 frames
     512x512, 25 DDIM steps, CFG 7.5, bf16, through
     AnimateDiffPipeline.__call__; launch counters reset just before it,
     read as the decode starts and again at its end, and checked
Then the kernels JSON line, the nvidia-smi line and, last, the contract
line {"ok": true, "device": {...}}.

Any failure raises and ends the run with a non-zero exit; a hang ends
with a stack trace (faulthandler). TF32 is off for every comparison
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32
= False). Nothing is written outside vdx_torch/_build/.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import pathlib
import subprocess
import sys
import time

# a hang ends with a stack trace well before any outer time limit; the
# whole run, build included, takes under a minute on an H100
HANG_BUDGET_S = 300
ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM published peaks at 700 W: bf16 dense tensor cores,
# fp32 outside the tensor cores, HBM3
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_BYTES_S = 3.35e12
WORKLOAD = dict(
    negative_prompt="bad quality, blurry, distorted",
    num_frames=16, height=512, width=512, guidance_scale=7.5,
    decode_chunk=8, seed=1234, output_type="np",
)
PROMPT = "a corgi walking on the beach, sunset lighting, high quality"
TIMED_STEPS = 25


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(flops: float, nbytes: float, peak: float):
    """Least time for the work: the larger of operations over the peak
    rate for their type and bytes (inputs read once, outputs written
    once) over the memory rate. -> (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def bf16_tol(ref) -> float:
    """One bf16 ulp at the largest reference magnitude: both sides compute
    in fp32 and round once to bf16, so summation order flips a last bit."""
    return 2.0 ** -7 * max(1.0, ref.float().abs().max().item())


def check_kernels(dev):
    """Phase 3: each kernel on the full main-path shape, its plain version
    on the first two batch entries (the plain K1 at the full level-0 batch
    would hold a 17 GB score tensor)."""
    import torch
    import torch.nn.functional as F

    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels import groupnorm as KG

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(shape, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) + mean).to(torch.bfloat16)

    for B, S, H, D in ((32, 4096, 8, 40), (32, 1024, 8, 80)):
        t0 = time.time()
        q, k, v = (randn((B, S, H, D)) for _ in range(3))
        scale = D ** -0.5
        out = KA.flash_attention_dt(q, k, v, scale=scale)
        ref = KA.flash_attention_dt_plain(q[:2], k[:2], v[:2], scale=scale)
        err = (out[:2].float() - ref.float()).abs()
        tol = bf16_tol(ref)

        def plain_full():
            for i in range(0, B, 2):
                KA.flash_attention_dt_plain(q[i:i + 2], k[i:i + 2], v[i:i + 2],
                                            scale=scale)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = cuda_ms(lambda: KA.flash_attention_dt(q, k, v, scale=scale))
        plain_ms = cuda_ms(plain_full, reps=3, warmup=1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                               scale=scale))
        b_ms, b_by = bound(4.0 * B * H * S * S * D, 4 * q.numel() * 2,
                           H100_BF16_FLOPS)
        rows.append(dict(
            name=f"K1 flash_attention_dt staticmax [{B},{S},{H},{D}]",
            kernel="K1", stage="denoise", route="cuda",
            source="vdx_torch/csrc/flash_attention.cu",
            replaces="vdx/kernels/flash_attention.py:204",
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
            tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library="F.scaled_dot_product_attention", bound_ms=b_ms,
            bound_by=b_by, seconds=time.time() - t0))
        del q, k, v, qt, kt, vt, out, ref

    gn_cases = (  # (kernel, shape, eps, silu, where on the main path, stage)
        ("K2", (32, 4096, 320), 1e-5, True, "UNet level-0 resnet GN-SiLU",
         "denoise"),
        ("K3", (2, 65536, 320), 1e-6, False, "level-0 motion-module GN",
         "denoise"),
        ("K3", (8, 262144, 128), 1e-6, True, "VAE decoder GN-SiLU at 512x512",
         "decode"),
    )
    for kname, (B, S, C), eps, silu, where, stage in gn_cases:
        t0 = time.time()
        fn = KG.fused_group_norm if kname == "K2" else KG.fused_group_norm_2phase
        x = randn((B, S, C), mean=0.5)
        scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bias = 0.1 * torch.randn(C, generator=gen, device=dev)
        kw = dict(num_groups=32, eps=eps, with_silu=silu)
        out = fn(x, scale, bias, **kw)
        ref = KG.group_norm_moments_plain(x[:2], scale, bias, **kw)
        err = (out[:2].float() - ref.float()).abs()
        tol = bf16_tol(ref)
        xt = x.view(B, S, C).transpose(1, 2)  # [B, C, S] view for F.group_norm

        def library():
            y = F.group_norm(xt, 32, scale.to(x.dtype), bias.to(x.dtype), eps)
            return F.silu(y) if silu else y

        ms = cuda_ms(lambda: fn(x, scale, bias, **kw))
        plain_ms = cuda_ms(lambda: KG.group_norm_moments_plain(x, scale, bias, **kw))
        lib_ms = cuda_ms(library)
        # ~8 fp32 operations per element (two moments, affine, SiLU)
        b_ms, b_by = bound(8.0 * x.numel(), 2 * x.numel() * 2, H100_FP32_FLOPS)
        rows.append(dict(
            name=f"{kname} {fn.__name__} [{B},{S},{C}] ({where})",
            kernel=kname, stage=stage, route="cuda",
            source="vdx_torch/csrc/groupnorm.cu",
            replaces=("vdx/kernels/groupnorm.py:117" if kname == "K2"
                      else "vdx/kernels/groupnorm.py:205"),
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
            tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library="F.group_norm" + (" + F.silu" if silu else ""),
            bound_ms=b_ms, bound_by=b_by, seconds=time.time() - t0))
        del x, out, ref, xt

    for r in rows:
        log(f"[kernels] {r['name']}: max_abs_err={r['max_abs_err']:.3e} "
            f"mean_abs_err={r['mean_abs_err']:.3e} tol={r['tol']:.3e} "
            f"(one bf16 ulp at max|plain|: fp32 sums in another order) "
            f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} ({r['library']}) "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"{r['seconds']:.1f}s")
    bad = [r["name"] for r in rows if not r["max_abs_err"] <= r["tol"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


@contextlib.contextmanager
def plain_versions():
    """Swap the plain PyTorch versions in for K1/K2/K3 on CUDA tensors
    (phase 6's reference only; the package itself has no such path)."""
    import torch

    import vdx_torch.ops.attention as A
    import vdx_torch.ops.groupnorm as G
    from vdx_torch.kernels.flash_attention import flash_attention_dt_plain
    from vdx_torch.kernels.groupnorm import group_norm_moments_plain

    def attn(q, k, v, *, scale):  # batch slices keep the score tensor small
        return torch.cat([
            flash_attention_dt_plain(q[i:i + 2], k[i:i + 2], v[i:i + 2],
                                     scale=scale)
            for i in range(0, q.shape[0], 2)])

    def gn(x, num_groups, scale, bias, eps=1e-5, with_silu=True):
        B, C = x.shape[0], x.shape[-1]
        y = group_norm_moments_plain(x.reshape(B, -1, C), scale, bias,
                                     num_groups=num_groups, eps=eps,
                                     with_silu=with_silu)
        return y.reshape(x.shape)

    saved = (A.flash_attention_dt, G.group_norm_silu_cuda)
    A.flash_attention_dt, G.group_norm_silu_cuda = attn, gn
    try:
        yield
    finally:
        A.flash_attention_dt, G.group_norm_silu_cuda = saved


def counters():
    from vdx_torch.kernels.flash_attention import flash_attention_dt
    from vdx_torch.kernels.groupnorm import (fused_group_norm,
                                             fused_group_norm_2phase)

    return {"K1": flash_attention_dt, "K2": fused_group_norm,
            "K3": fused_group_norm_2phase}


def reset_counters() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def main() -> int:
    faulthandler.dump_traceback_later(HANG_BUDGET_S, exit=True)
    t_start = time.time()
    if not (ROOT / "vdx_torch" / "csrc").is_dir():
        raise SystemExit(f"vdx_torch/csrc not found beside {__file__}: run "
                         "chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: chip_smoke.py "
                         "needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} | nvidia-smi: {smi} | tf32 off "
        f"| hang budget {HANG_BUDGET_S}s")

    # 2. build
    from vdx_torch.kernels import _lib

    t0 = time.time()
    _lib.lib()
    info = _lib.build_info
    log(f"[build] build_s={info['build_s']:.1f} cached={info['cached']} "
        f"lib={pathlib.Path(info['path']).relative_to(ROOT)} "
        f"({time.time() - t0:.1f}s)")
    if info.get("nvcc_output"):
        log("[build] nvcc: " + info["nvcc_output"].replace("\n", " | ")[:2000])

    # 3. kernels against their plain versions
    t0 = time.time()
    rows = check_kernels(dev)
    torch.cuda.empty_cache()
    log(f"[kernels] all within tolerance ({time.time() - t0:.1f}s)")

    # 4. init
    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.pipelines import AnimateDiffPipeline

    t0 = time.time()
    pipe = AnimateDiffPipeline.with_random_params(
        seed=0, policy=BF16_POLICY, scheduler="ddim", device="cuda")
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", pipe.unet), ("vae", pipe.vae),
                                ("text", pipe.text_encoder))}
    log(f"[init] params={sum(n_params.values())} {n_params} bf16 on the card "
        f"({time.time() - t0:.1f}s)")

    # 5. warm-up
    t0 = time.time()
    out = pipe(PROMPT, num_inference_steps=2, **WORKLOAD)
    log(f"[warmup] 2 steps, frames {out.frames[0].shape} "
        f"({time.time() - t0:.1f}s)")

    # 6. reference: one denoiser evaluation, kernels against plain versions
    t0 = time.time()
    with torch.inference_mode():
        ctx = pipe.encode_prompt(PROMPT, WORKLOAD["negative_prompt"])
        tables = pipe._get_tables(TIMED_STEPS)
        lat = pipe.initial_noise((1, 16, 64, 64, 4), WORKLOAD["seed"])
        model_in = torch.cat([lat, lat])
        t_b = tables.timesteps[0].expand(2)
        reset_counters()
        eps_k = pipe.unet(model_in, t_b, ctx)
        per_unet_call = read_counters()
        with plain_versions():
            eps_p = pipe.unet(model_in, t_b, ctx)
        rel = ((eps_k - eps_p).norm() / eps_p.norm()).item()
    finite = bool(torch.isfinite(eps_k).all())
    log(f"[reference] UNet eval at the first-step input: rel_l2(kernels vs "
        f"plain)={rel:.3e} (bound 5e-2: bf16 rounding flips compounding over "
        f"the network) finite={finite} launches_per_unet_call={per_unet_call} "
        f"({time.time() - t0:.1f}s)")
    if not (finite and rel < 5e-2):
        raise SystemExit("denoiser output disagrees with the plain versions")
    if per_unet_call["K1"] != 10:
        raise SystemExit(f"expected 10 K1 launches per UNet call, {per_unet_call}")
    del eps_k, eps_p, model_in

    # 7. the timed call. The counters are read once more as the decode
    # starts (a Python read, no synchronise), which splits each kernel's
    # launches between the denoise loop and the VAE decode.
    at_decode = {}
    decode = pipe._decode

    def counted_decode(latents, chunk):
        at_decode.update(read_counters())
        return decode(latents, chunk)

    pipe._decode = counted_decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    out = pipe(PROMPT, num_inference_steps=TIMED_STEPS, **WORKLOAD)
    frames = out.frames[0]  # numpy: the call has synchronised
    secs = time.time() - t0
    launches = read_counters()
    del pipe._decode
    by_stage = {"denoise": dict(at_decode),
                "decode": {k: n - at_decode[k] for k, n in launches.items()}}
    chunks = WORKLOAD["num_frames"] // WORKLOAD["decode_chunk"]
    peak = torch.cuda.max_memory_allocated()
    lat_finite = bool(torch.isfinite(out.latents).all())
    log(f"[timed] {TIMED_STEPS} DDIM steps + decode: {secs:.3f}s "
        f"frames/s={frames.shape[0] / secs:.4f} "
        f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB) "
        f"launches={launches} denoise={by_stage['denoise']} "
        f"decode={by_stage['decode']} frames {frames.shape} {frames.dtype} "
        f"min={int(frames.min())} max={int(frames.max())} "
        f"mean={float(frames.mean()):.2f} latents_finite={lat_finite}")
    if by_stage["denoise"]["K1"] != 10 * TIMED_STEPS or by_stage["decode"]["K1"]:
        raise SystemExit(f"launches {by_stage}: expected K1 {10 * TIMED_STEPS} "
                         "times in the denoise loop (10 per UNet call), none after")
    if any(by_stage[r["stage"]][r["kernel"]] == 0 for r in rows):
        raise SystemExit(f"a kernel never launched where its row says: {by_stage}")
    if frames.shape != (16, 512, 512, 3) or frames.dtype != np.uint8:
        raise SystemExit(f"bad frames {frames.shape} {frames.dtype}")
    if not lat_finite or frames.min() == frames.max():
        raise SystemExit("frames are constant or latents are not finite")

    # Counts are per kernel at every shape, within the row's stage of the
    # timed call: the denoise loop (per step) or the VAE decode (per chunk).
    def row_launches(r):
        n = by_stage[r["stage"]][r["kernel"]]
        per = (("launches_per_step", n / TIMED_STEPS) if r["stage"] == "denoise"
               else ("launches_per_chunk", n / chunks))
        return {"launches": n, "stage": r["stage"], per[0]: per[1]}

    summary = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | row_launches(r)
        | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}
        for r in rows
    ], "launches": launches, "launches_by_stage": by_stage,
        "timed_call_s": secs, "frames_per_s": frames.shape[0] / secs,
        "steps": TIMED_STEPS, "max_memory_allocated": peak,
        "build_s": info["build_s"], "total_s": time.time() - t_start}
    log(json.dumps(summary))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
