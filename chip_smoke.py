#!/usr/bin/env python3
"""Chip smoke run of vdx_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases, one flushed line each with its seconds:
  1. environment: torch, CUDA, nvidia-smi name and power limit, the SM
     count and clocks.max.sm (the exponential unit's rate in the bounds)
  2. build: one nvcc -c per vdx_torch/csrc/*.cu, started together, then a
     link (cached by source hash)
  3. kernels against their plain PyTorch versions at the main path's
     shapes: K1 (staticmax flash attention) and K4 (running max) on the
     wgmma + TMA kernel, K2 (one-pass cluster GroupNorm) and K3
     (streaming GroupNorm), each GN row on the kernel the launch plan
     gives its shape; kernel, plain and library times (CUDA events)
     beside each bound; the 2560-channel GN shapes that the first GN
     dispatch refused ([32,1024,2560] bf16, [32,576,2560] fp32), driven
     once through ops.groupnorm with the counters reset; then one [gn]
     line a path (a UNet call, a decode chunk, at 512 and 768): every
     GroupNorm of it through ops.groupnorm with the counters reset, its
     launches against the plan, the summed kernel, bound and
     F.group_norm ms (scripts/bench_gn_torch.py); the timed calls check
     the plan's K2 and K3 counts
  4. init: full-width random weights generated on the card; the seeded
     initial noise (vdx_torch.core.rng) on the card against the CPU
  5. warm-up: the workload at 2 steps
  6. reference: one denoiser evaluation at the workload's first-step
     input, kernel path against the plain versions swapped in; forward
     hooks keep q, k, v of the first motion-module attn1 at each level
     and count the temporal attention calls per level
  7. the timed call: AnimateDiff text-to-video at SD-1.5 width, 16 frames
     512x512, 25 DDIM steps, CFG 7.5, bf16, through
     AnimateDiffPipeline.__call__; launch counters reset just before it,
     read as the decode starts and again at its end, and checked
  8. warm-up of the 768x768 path: the pipeline's default sampler (Euler)
     at 2 steps
  9. reference at 768x768: one denoiser evaluation at the first Euler
     step's input, kernel path against the same call with only K4 swapped
     for its plain version; q, k, v kept as in 6
 10. the 768x768 timed call: 16 frames, 25 Euler steps (the pipeline's
     default sampler), CFG 7.5, bf16; counters as in 7 (K1 at levels 0
     and 1, K4 at level 2)
 11. every sampler at 512x512, 3 steps, through __call__
 12. the temporal family (K6, K7, K8, K9) at the eight motion-module
     sites kept in 6 and 9 ([P, 16, 8, D], P = 8192..288): driven once
     per site and entry point with the counters reset (K6 through
     ops.attention.dot_product_attention(impl="blockdiag"), K7, K8, K9
     through their kernels' functions), then each against its plain
     version, timed beside its bound, SDPA on the same views and the
     eager xla_bf16p path that impl="auto" runs at those sites today
     (bf16 K6-K8 on the tensor-core kernel, K9 on the SIMT kernel)
 13. the attention forms: flash_attention_dt in vdx's exp_impl forms
     exp, exp2, fastexp2, noexp, mxu_only (K1'), staticaug (K5) and
     staticmax (K1) at [32,4096,8,40], [32,576,8,160] and [32,576,8,256],
     and K4 (flash_attention) at [32,576,8,256], all on the wgmma + TMA
     pipeline, each driven through the chained loop of the attention
     micro-benchmark (scripts/bench_attn_torch.py, K = 16) with the
     counters reset, then against its plain version, timed beside its
     bound and a library call (SDPA; two matmuls for mxu_only; none for
     noexp)
Phase 3 also checks the wgmma + TMA pipeline at its edges (Sq and Skv off
the tiles, Skv under one tile, q/k/v as views into one fused projection,
rows whose every scaled logit is below -46; every form at each head-dim
instance, D = 168, 200 and 256 on the DP = 256 one, fastexp2 and noexp
over several periods, noexp with Skv not a multiple of the period), the
template at its routes (K4 at D = 20 and 252; every form on rows 8 bytes
past 16-byte alignment), K1/K4 with fp32 operands, every exp_impl form in
fp32 at ragged key counts, and K6-K9 at D = 160 with 16, 24 and 32 frames,
on strided and unaligned views and in fp32; every counter of
kernels.flash_attention.launch_counts() has to take a launch there. Bounds: the largest of the operations over the peak
rate, the bytes over the memory rate and, for attention, the exp2 calls
over 16 a clock per SM at clocks.max.sm, and for fastexp2 the cubic's
instructions (counted from the SASS by scripts/sass_forms.py) at their
pipes' rates (a report, not a check). Then the kernels JSON line (each
row's launches from the run of its own path), the nvidia-smi line and,
last, the contract line {"ok": true, "device": ...}.

Any failure raises and ends the run with a non-zero exit; a hang ends
with a stack trace (faulthandler). TF32 is off for every comparison
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32
= False). Nothing is written outside vdx_torch/_build/.
"""

from __future__ import annotations

import contextlib
import faulthandler
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
from functools import partial

# a hang ends with a stack trace well before any outer time limit; the
# whole run, build included, takes under two minutes on an H100
HANG_BUDGET_S = 300
ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM published peaks at 700 W: bf16 dense tensor cores,
# fp32 outside the tensor cores, HBM3
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_BYTES_S = 3.35e12
# SM clocks a second (the SM count times clocks.max.sm, both read on the
# card in phase 1); exp2 calls run at 16 a clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0)
SM_CLOCKS_PER_S = {"rate": None}
EXP2_PER_CLOCK = 16
WORKLOAD = dict(
    negative_prompt="bad quality, blurry, distorted",
    num_frames=16, height=512, width=512, guidance_scale=7.5,
    decode_chunk=8, seed=1234, output_type="np",
)
WORKLOAD_768 = dict(WORKLOAD, height=768, width=768)  # default scheduler
PROMPT = "a corgi walking on the beach, sunset lighting, high quality"
TIMED_STEPS = 25
SAMPLER_STEPS = 3
# fp32 operands: both sides sum fp32 products (up to ~10^3 terms) in
# different orders, ~1e-6 apart on O(1) outputs; 1e-4 leaves margin and
# still catches any bf16 rounding (~4e-3).
FP32_TOL = 1e-4
# [B, S, C] of the 2560-channel GN rows (CFG batch 2 x 16 frames)
GN2560_SHAPES = ((32, 1024, 2560), (32, 576, 2560))
# the seeded noise on the card against the CPU: the same int64 threefry
# bits; the fp32 erfinv polynomial's log1p and sqrt may round differently
# on the two (a few ulps of values up to ~6, ulp 4.8e-7)
RNG_TOL = 4e-6


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


def bound(flops: float, nbytes: float, peak: float, exps: float = 0.0,
          alu_clocks: float = 0.0):
    """Least time for the work: the largest of operations over the peak
    rate for their type, bytes (inputs read once, outputs written once)
    over the memory rate, exp2 calls over the special-function units'
    rate, and ``alu_clocks`` SM clocks of FMA and integer pipe work over
    every SM. -> (ms, which term sets it: "operations", "bytes", "exp2"
    or "alu"; the kernels line reports exp2 and alu as "operations")."""
    sm = SM_CLOCKS_PER_S["rate"]
    terms = {"operations": flops / peak, "bytes": nbytes / H100_BYTES_S,
             "exp2": exps / (EXP2_PER_CLOCK * sm) if exps else 0.0,
             "alu": alu_clocks / sm if alu_clocks else 0.0}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, term


def ptxas_summary(text: str) -> str:
    """One entry per kernel instantiation from nvcc's ``-Xptxas -v``."""
    import re

    out, name, spill = [], None, ""
    for line in text.splitlines():
        # the kernel's name follows its length in the mangled symbol
        m = re.search(r"entry function '.*?(?<=\d)((?:flash|gn|temporal)_\w+?_kernel)"
                      r"(I[^v]*)?", line)
        if m:
            name = m.group(1) + (m.group(2) or "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)}r spill {spill}")
            name = None
    return "; ".join(out)


def bf16_tol(ref) -> float:
    """One bf16 ulp at the largest reference magnitude: both sides compute
    in fp32 and round once to bf16, so summation order flips a last bit."""
    return 2.0 ** -7 * max(1.0, ref.float().abs().max().item())


def check_kernels(dev):
    """Phase 3: each kernel on the full main-path shape of its path (the
    512x512 DDIM call or the 768x768 Euler call), its plain version on the
    first two batch entries (the plain K1 at the full level-0 batch would
    hold a 17 GB score tensor at 512, 87 GB at 768)."""
    import torch
    import torch.nn.functional as F

    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels import groupnorm as KG

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(shape, mean=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) + mean).to(dtype)

    attn_cases = (  # (kernel, shape, path, site, plain timed on one slice)
        ("K1", (32, 4096, 8, 40), "512", "level-0 self-attn", False),
        ("K1", (32, 1024, 8, 80), "512", "level-1 self-attn", False),
        ("K1", (32, 9216, 8, 40), "768", "level-0 self-attn", True),
        ("K1", (32, 2304, 8, 80), "768", "level-1 self-attn", True),
        ("K4", (32, 576, 8, 160), "768", "level-2 self-attn", False),
    )
    static = dict(exp_impl="staticmax")
    for kname, (B, S, H, D), path, site, one_slice in attn_cases:
        t0 = time.time()
        fn, plain = ((partial(KA.flash_attention_dt, **static),
                      partial(KA.flash_attention_dt_plain, **static))
                     if kname == "K1" else
                     (KA.flash_attention, KA.flash_attention_plain))
        q, k, v = (randn((B, S, H, D)) for _ in range(3))
        scale = D ** -0.5
        out = fn(q, k, v, scale=scale)
        ref = plain(q[:2], k[:2], v[:2], scale=scale)
        err = (out[:2].float() - ref.float()).abs()
        tol = bf16_tol(ref)
        del ref

        def plain_full():
            for i in range(0, 2 if one_slice else B, 2):
                plain(q[i:i + 2], k[i:i + 2], v[i:i + 2], scale=scale)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = cuda_ms(lambda: fn(q, k, v, scale=scale))
        plain_ms = cuda_ms(plain_full, reps=3, warmup=1) * (B // 2 if one_slice else 1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                               scale=scale))
        b_ms, b_by = bound(4.0 * B * H * S * S * D, 4 * q.numel() * 2,
                                   H100_BF16_FLOPS,
                                   float(B * H * S * S))  # one exp2 a score
        label = {"K1": "flash_attention_dt staticmax",
                 "K4": "flash_attention running-max"}[kname]
        rows.append(dict(
            name=f"{kname} {label} [{B},{S},{H},{D}] ({site}, {path}x{path})",
            kernel=kname, path=path, stage="denoise", route="cuda",
            source="vdx_torch/csrc/flash_attention_sm90.cu",
            replaces=("vdx/kernels/flash_attention.py:204" if kname == "K1"
                      else "vdx/kernels/flash_attention.py:135"),
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
            tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library="F.scaled_dot_product_attention", bound_ms=b_ms,
            bound_by=b_by, seconds=time.time() - t0,
            note=("plain_ms: one two-entry slice timed, times 16" if one_slice
                  else "")))
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()

    # the launch plan: K2 where a cluster holds a stripe with two CTAs an
    # SM (the 768 level-0 resnet GN: a 1.47 MB stripe on 16 CTAs), K3
    # where not (the 768 level-0 motion GN, a 47 MB stripe)
    if KG.gn_plan(32, 9216, 320, 32, 2).route != "K2" \
            or KG.gn_plan(2, 147456, 320, 32, 2).route != "K3":
        raise SystemExit("GN plan: [32, 9216, 320] bf16 should go to K2, "
                         "[2, 147456, 320] to K3")
    bf16, fp32 = torch.bfloat16, torch.float32
    gpu_ms = load_script("bench_gn_torch").gpu_ms
    gn_cases = (  # (kernel, shape, dtype, eps, silu, where, path, stage)
        ("K2", (32, 4096, 320), bf16, 1e-5, True,
         "UNet level-0 resnet GN-SiLU", "512", "denoise"),
        ("K2", (32, 4096, 960), bf16, 1e-5, True,
         "UNet up-block-3 resnet GN-SiLU, 960 channels", "512", "denoise"),
        ("K3", (2, 65536, 320), bf16, 1e-6, False,
         "level-0 motion-module GN", "512", "denoise"),
        ("K3", (8, 262144, 128), bf16, 1e-6, True,
         "VAE decoder GN-SiLU at 512x512", "512", "decode"),
        ("K2", (32, 9216, 320), bf16, 1e-5, True,
         "UNet level-0 resnet GN-SiLU at 768x768", "768", "denoise"),
        ("K3", (32, 9216, 960), bf16, 1e-5, True,
         "UNet up-block-3 resnet GN-SiLU at 768x768 (a 16-CTA stripe, "
         "one CTA an SM: K3 by the plan)", "768", "denoise"),
        ("K3", (2, 147456, 320), bf16, 1e-6, False,
         "level-0 motion-module GN at 768x768", "768", "denoise"),
        ("K3", (8, 589824, 128), bf16, 1e-6, True,
         "VAE decoder GN-SiLU at 768x768", "768", "decode"),
        ("K3", (8, 589824, 256), bf16, 1e-6, True,
         "VAE decoder GN-SiLU at 768x768, 256 channels (4.8 GB)", "768",
         "decode"),
        # the up-block-1 resnet GN: 1024x1024 in bf16, 768x768 under the
        # fp32 policy (both over the first GN kernels' slab gate)
        ("K2", GN2560_SHAPES[0], bf16, 1e-5, True,
         "up-block-1 resnet GN-SiLU at 1024x1024", "gn2560", "dispatch"),
        ("K2", GN2560_SHAPES[1], fp32, 1e-5, True,
         "up-block-1 resnet GN-SiLU at 768x768, fp32", "gn2560", "dispatch"),
    )
    for kname, (B, S, C), dtype, eps, silu, where, path, stage in gn_cases:
        t0 = time.time()
        fn = KG.fused_group_norm if kname == "K2" else KG.fused_group_norm_2phase
        plan = KG.gn_plan(B, S, C, 32, dtype.itemsize)
        if plan.route != kname:  # the row's kernel is the one its path runs
            raise SystemExit(f"GN plan: {[B, S, C]} goes to {plan.route}, "
                             f"not {kname}")
        x = randn((B, S, C), mean=0.5, dtype=dtype)
        scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bias = 0.1 * torch.randn(C, generator=gen, device=dev)
        kw = dict(num_groups=32, eps=eps, with_silu=silu)
        out = fn(x, scale, bias, **kw)
        ref = KG.group_norm_moments_plain(x[:2], scale, bias, **kw)
        err = (out[:2].float() - ref.float()).abs()
        tol = bf16_tol(ref) if dtype == bf16 else FP32_TOL
        xt = x.view(B, S, C).transpose(1, 2)  # [B, C, S] view for F.group_norm

        def library():
            y = F.group_norm(xt, 32, scale.to(x.dtype), bias.to(x.dtype), eps)
            return F.silu(y) if silu else y

        # a GN launch takes 0.01-2.5 ms, near the host's time to make one:
        # the kernel and library calls are timed queued behind a sleep
        # kernel (bench_gn_torch.gpu_ms), so the host's share does not show
        ms = gpu_ms(lambda: fn(x, scale, bias, **kw))
        plain_ms = cuda_ms(lambda: KG.group_norm_moments_plain(x, scale, bias, **kw))
        lib_ms = gpu_ms(library, reps=4)
        # ~8 fp32 operations per element (two moments, affine, SiLU)
        b_ms, b_by = bound(8.0 * x.numel(),
                                   2 * x.numel() * x.element_size(),
                                   H100_FP32_FLOPS)
        rows.append(dict(
            name=f"{kname} {fn.__name__} [{B},{S},{C}] {str(dtype)[6:]} "
                 f"({where})",
            kernel=kname, path=path, stage=stage, route="cuda",
            source="vdx_torch/csrc/groupnorm.cu",
            replaces=("vdx/kernels/groupnorm.py:117" if kname == "K2"
                      else "vdx/kernels/groupnorm.py:205"),
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
            tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library="F.group_norm" + (" + F.silu" if silu else ""),
            bound_ms=b_ms, bound_by=b_by,
            seconds=time.time() - t0,
            note=(f"cluster {plan.cluster} x {plan.rows_per_cta} rows, "
                  f"stripe {plan.stripe_channels} channels"
                  if kname == "K2" else
                  f"{plan.n_chunks} chunks of {plan.rows_per_chunk} rows")
            + "; ms and library_ms queued behind a sleep kernel"))
        del x, out, ref, xt
        torch.cuda.empty_cache()

    for r in rows:
        log(f"[kernels] {r['name']}: max_abs_err={r['max_abs_err']:.3e} "
            f"mean_abs_err={r['mean_abs_err']:.3e} tol={r['tol']:.3e} "
            f"(bf16: one ulp at max|plain|, fp32: {FP32_TOL}; fp32 sums in "
            f"another order) "
            f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} ({r['library']}) "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"{r['note'] + ' ' if r['note'] else ''}{r['seconds']:.1f}s")
    bad = [r["name"] for r in rows if not r["max_abs_err"] <= r["tol"]]
    before = KA.launch_counts()
    bad += check_sm90_edges(dev)
    bad += check_attention_edges(dev)
    edges = {n: c - before[n] for n, c in KA.launch_counts().items()}
    bad += check_temporal_edges(dev)
    log(f"[kernels] edge launches by counter: {edges}")
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    idle = [n for n, c in edges.items() if not c]
    if idle:
        raise SystemExit(f"routes never launched at the edges: {idle}")
    return rows, edges


def check_sm90_edges(dev):
    """The wgmma + TMA kernel (csrc/flash_attention_sm90.cu) in both forms
    at its edges, each launch counted on it (K1 in
    flash_attention_dt.launches, K4 in flash_attention.launches): Sq and
    Skv off the query and key tiles at each instance's head dim (D = 168,
    200 and 256 on the DP = 256 instance), Skv under one tile, q/k/v as views into one fused [B, S, 3, H, D]
    projection, staticmax at D = 160, and at D = 40 two rows whose every
    scaled logit is below -46 (about -95: p underflows to 0 and the row is
    zeros; about -53: p is subnormal, as in the plain version). K1 is
    held to kernels.flash_attention.plain_err_tol, K4 to the same bar
    against flash_attention_plain. -> the names of the cases that fail."""
    import torch

    from vdx_torch.kernels import flash_attention as KA

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(form, B, Sq, Skv, H, D, fused)
             for form in ("K1", "K4")
             for B, Sq, Skv, H, D, fused in (
                 (2, 300, 333, 3, 40, False), (2, 300, 333, 3, 80, False),
                 (2, 300, 333, 3, 160, False), (1, 64, 70, 2, 40, False),
                 (1, 200, 100, 2, 160, False), (2, 640, 640, 4, 40, True),
                 (2, 577, 577, 8, 80, True), (2, 600, 600, 2, 160, True),
                 # DP = 256 (one consumer warpgroup): D = 168, 200, 256,
                 # Skv under one 64-key tile, fused-projection views
                 (2, 300, 333, 3, 168, False), (2, 300, 333, 3, 200, False),
                 (2, 300, 333, 3, 256, False), (1, 65, 50, 2, 256, False),
                 (2, 600, 600, 2, 256, True))]
    cases.append(("K1 below -46", 2, 256, 300, 2, 40, False))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    bad = []
    for form, B, Sq, Skv, H, D, fused in cases:
        if fused:
            qkv = randn(B, Sq, 3, H, D)
            q, k, v = qkv.unbind(dim=2)
        else:
            q, k, v = randn(B, Sq, H, D), randn(B, Skv, H, D), randn(B, Skv, H, D)
        if form == "K1 below -46":
            # k > 0, so a row of q at -8 (-4.5) scores about -95 (-53)
            k = (k.float().abs() + 0.5).to(torch.bfloat16)
            q[:, 0], q[:, 1] = -8.0, -4.5
        scale = D ** -0.5
        static = form.startswith("K1")
        counter = KA.flash_attention_dt if static else KA.flash_attention
        n0 = counter.launches
        if static:
            out = KA.flash_attention_dt(q, k, v, scale=scale, exp_impl="staticmax")
            err, _, tol, mag = KA.plain_err_tol(out, q, k, v, scale=scale,
                                                exp_impl="staticmax")
        else:
            out = KA.flash_attention(q, k, v, scale=scale)
            ref = KA.flash_attention_plain(q, k, v, scale=scale)
            err = (out.float() - ref.float()).abs().max().item()
            mag = ref.float().abs().max().item()
            tol = bf16_tol(ref)
        torch.cuda.synchronize()
        launched = counter.launches - n0
        name = (f"{form} sm90 [{B},{Sq}/{Skv},{H},{D}]"
                + (" fused-projection views" if fused else ""))
        extra = ""
        if form == "K1 below -46":
            extra = (f" row -95 max|out|={out[:, 0].float().abs().max().item():.3e}"
                     f" row -53 max|out|={out[:, 1].float().abs().max().item():.3e}")
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"max|plain|={mag:.3e} launches on the kernel {launched}{extra}")
        if not (err <= tol and launched == 1):
            bad.append(name)
    return bad


def check_attention_edges(dev):
    """K4 at shapes off the main path (D % 8 != 0 at 20 and 252, D = 256,
    a multi-tile ragged Skv) in bf16, K1/K4 with fp32 operands, and every
    form of flash_attention_dt: in bf16 on the wgmma + TMA pipeline at
    ragged Sq and Skv at each head-dim instance (DP = 48, 80, 128, 160 and
    256, the last at D = 168, 200 and 256), fastexp2 and noexp over
    several periods with Skv a multiple of the period and not, K5 on rows
    whose every scaled logit is below -46 (D = 40 and 256); on the
    template (" template" counters, "K1 static") on rows 8 bytes past
    16-byte alignment at D = 40, 160 and 256; in fp32 (the SIMT kernel) at
    a ragged Skv. Each against its plain version with
    KA.plain_err_tol, each launch counted once on the counter
    KA.counter_for names and on no other; -> the names of the cases that
    fail."""
    import torch

    from vdx_torch.kernels import flash_attention as KA

    gen = torch.Generator(device=dev).manual_seed(1)
    bad = []

    def operands(dtype, B, Sq, Skv, H, D, aligned=True):
        """q, k, v; unaligned: views whose base is 8 bytes past a 16-byte
        boundary (every row then starts off it)."""
        def one(S):
            shape, n = (B, S, H, D), B * S * H * D
            if aligned:
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            flat = torch.randn(n + 4, generator=gen, device=dev).to(dtype)
            return flat[8 // flat.element_size():][:n].view(shape)
        return one(Sq), one(Skv), one(Skv)

    def counted(name, want, before):
        """The launch landed on counter ``want`` once, on no other."""
        after = KA.launch_counts()
        moved = {n: after[n] - c for n, c in before.items() if after[n] != c}
        if moved != {want: 1}:
            log(f"[kernels] edge {name}: launches {moved}, expected {want} 1")
            bad.append(name + " (counter)")

    cases = (  # (kernel, dtype, B, Sq, Skv, H, D)
        ("K4", torch.bfloat16, 2, 300, 300, 2, 20),
        ("K4", torch.bfloat16, 2, 300, 700, 2, 252),
        ("K4", torch.bfloat16, 2, 300, 700, 2, 256),
        ("K4", torch.bfloat16, 2, 1000, 1000, 2, 160),
        ("K1", torch.float32, 2, 1024, 1024, 2, 40),
        ("K1", torch.float32, 2, 1024, 1024, 2, 80),
        ("K4", torch.float32, 2, 576, 576, 8, 160),
        ("K4", torch.float32, 2, 300, 300, 2, 20),
    )
    static = dict(exp_impl="staticmax")
    for kname, dtype, B, Sq, Skv, H, D in cases:
        fn, plain = ((partial(KA.flash_attention_dt, **static),
                      partial(KA.flash_attention_dt_plain, **static))
                     if kname == "K1" else
                     (KA.flash_attention, KA.flash_attention_plain))
        q, k, v = operands(dtype, B, Sq, Skv, H, D)
        before = KA.launch_counts()
        out = fn(q, k, v, scale=D ** -0.5)
        name = f"{kname} {str(dtype)[6:]} [{B},{Sq}/{Skv},{H},{D}]"
        counted(name, KA.counter_for("staticmax" if kname == "K1" else None,
                                     dtype, D, True), before)
        ref = plain(q, k, v, scale=D ** -0.5)
        err = (out.float() - ref.float()).abs().max().item()
        fp32 = dtype == torch.float32
        tol = FP32_TOL if fp32 else bf16_tol(ref)
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            + ("(fp32: sums of up to 10^3 products in another order)" if fp32
               else "(one bf16 ulp at max|plain|)"))
        if not err <= tol:
            bad.append(name)
    bf16, fp32 = torch.bfloat16, torch.float32
    # (form, dtype, B, Sq, Skv, H, D, block_k, aligned rows, below -46)
    # the wgmma + TMA pipeline: ragged Sq and Skv at each instance (D =
    # 168, 200 and 256 on DP = 256)
    form_cases = [(form, bf16, 2, 300, Skv, 3, D, 1024, True, False)
                  for form in KA.EXP_IMPLS
                  for Skv, D in ((300, 40), (333, 80), (333, 128), (700, 160),
                                 (333, 168), (700, 200), (700, 256))]
    # fastexp2 and noexp over several periods of 256 keys at each
    # instance: Skv = 1100, not a multiple of the period (noexp runs to
    # 1280, its padded keys entering l), and Skv = 1024, a multiple (no
    # padded keys)
    form_cases += [(form, dtype, 2, Sq, Skv, 2, D, 256, True, False)
                   for form in ("fastexp2", "noexp")
                   for dtype, Sq, Skv, D in (
                       *((bf16, 200, 1100, D) for D in (40, 80, 128, 160, 256)),
                       *((dtype, 300, 1024, D) for dtype in (bf16, fp32)
                         for D in (40, 160, 256)))]
    form_cases += [("noexp", bf16, 2, 300, 300, 2, 40, 128, True, False),
                   ("noexp", bf16, 2, 300, 1100, 2, 256, 1024, True, False),
                   ("staticaug", bf16, 2, 256, 300, 2, 40, 1024, True, True),
                   ("staticaug", bf16, 2, 256, 300, 2, 256, 1024, True, True)]
    # the template: every form on rows the pipeline does not take
    form_cases += [(form, bf16, 2, 300, Skv, 2, D, 1024, False, False)
                   for form in KA.EXP_IMPLS
                   for Skv, D in ((333, 40), (700, 160), (333, 256))]
    # fp32: the SIMT kernel
    form_cases += [(form, fp32, 2, 300, Skv, 2, D, 1024, True, False)
                   for form in KA.EXP_IMPLS for Skv, D in ((300, 40), (700, 160))]
    for form, dtype, B, Sq, Skv, H, D, block_k, aligned, below in form_cases:
        q, k, v = operands(dtype, B, Sq, Skv, H, D, aligned)
        if below:
            # k > 0, so a row of q at -8 (-4.5) scores about -95 (-53)
            k = (k.float().abs() + 0.5).to(dtype)
            q[:, 0], q[:, 1] = -8.0, -4.5
        kw = dict(scale=D ** -0.5, exp_impl=form, block_k=block_k)
        want = KA.counter_for(form, dtype, D, aligned)
        name = (f"{form} ({want}) {str(dtype)[6:]} "
                f"[{B},{Sq}/{Skv},{H},{D}] block_k {block_k}"
                + ("" if aligned else " rows 8 bytes past 16-byte alignment")
                + (" rows below -46" if below else ""))
        before = KA.launch_counts()
        out = KA.flash_attention_dt(q, k, v, **kw)
        counted(name, want, before)
        err, _, tol, mag = KA.plain_err_tol(out, q, k, v, **kw)
        extra = ""
        if below:
            extra = (f" row -95 max|out|={out[:, 0].float().abs().max().item():.3e}"
                     f" row -53 max|out|={out[:, 1].float().abs().max().item():.3e}")
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"max|plain|={mag:.3e} (KA.plain_err_tol){extra}")
        if not err <= tol:
            bad.append(name)
    return bad


def check_temporal_edges(dev):
    """K6-K9 (csrc/temporal_attention.cu) at their edges: bf16 K6-K8 on
    the tensor-core kernel and K9 on the SIMT kernel at D = 160 with 16, 24
    and 32 frames (one and two m16 row tiles), at the site head dims 40
    and 80, on q/k/v views into one fused [P, F, 3, H, D] projection and on
    rows 8 bytes past 16-byte alignment (element staging), K9 at
    D % 8 != 0, and fp32 K6, K7, K9 (the SIMT kernel). Each against its
    plain version (one bf16 ulp at max|plain|; fp32 FP32_TOL), each launch
    counted once on its own wrapper. -> the names of the cases that fail."""
    import torch

    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels import temporal_attention_cp as KT

    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, fp32 = torch.bfloat16, torch.float32
    kernels = {  # name -> (wrapper, plain, mode)
        "K6": (KA.flash_attention_blockdiag, KA.flash_attention_blockdiag_plain,
               "blockdiag"),
        "K7": (KA.flash_attention_blockdiag_tc,
               KA.flash_attention_blockdiag_tc_plain, "tc"),
        "K8": (KA.flash_attention_blockdiag_tc2,
               KA.flash_attention_blockdiag_tc_plain, "tc"),
        "K9": (KT.temporal_attention_cp, KT.temporal_attention_cp_plain, "cp")}
    cases = [(kname, bf16, 300, F, 8, 160, "contiguous")
             for kname in kernels for F in (16, 24, 32)]
    cases += [(kname, bf16, 500, 16, 8, D, "contiguous")
              for kname in ("K6", "K9") for D in (40, 80)]
    cases += [(kname, bf16, 200, 16, 8, 160, layout)
              for kname in ("K6", "K7", "K9")
              for layout in ("fused-projection views",
                             "rows 8 bytes past 16-byte alignment")]
    cases += [("K9", bf16, 64, 16, 2, 20, "contiguous")]
    cases += [(kname, fp32, 200, 16, 8, 160, "contiguous")
              for kname in ("K6", "K7", "K9")]
    bad = []
    for kname, dtype, P, F, H, D, layout in cases:
        fn, plain, mode = kernels[kname]
        if layout.startswith("fused"):
            q, k, v = torch.randn((P, F, 3, H, D), generator=gen,
                                  device=dev).to(dtype).unbind(dim=2)
        else:
            n = P * F * H * D
            # 8 bytes in elements
            shift = 64 // torch.finfo(dtype).bits if layout.startswith("rows") else 0
            flat = torch.randn(3 * n + shift, generator=gen, device=dev).to(dtype)
            q, k, v = (flat[shift + i * n:shift + (i + 1) * n].view(P, F, H, D)
                       for i in range(3))
        scale = D ** -0.5
        kw = ({"block_p": 1} if kname == "K9" else
              {"block": math.lcm(128, F), **({"heads": H} if kname != "K6" else {})})
        n0 = fn.launches
        out = fn(q, k, v, scale=scale, **kw)
        torch.cuda.synchronize()
        launched = fn.launches - n0
        ref = plain(q, k, v, scale=scale)
        err = (out.float() - ref.float()).abs().max().item()
        tol = bf16_tol(ref) if dtype == bf16 else FP32_TOL
        name = (f"{kname} {KA.temporal_kernel_for(mode, dtype)} "
                f"{str(dtype)[6:]} [{P},{F},{H},{D}] {layout}")
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"launches {launched}")
        if not (err <= tol and launched == 1):
            bad.append(name)
    return bad


@contextlib.contextmanager
def plain_versions(*kernels: str):
    """Swap the plain PyTorch versions in for the named kernels (of K1,
    K2/K3, K4) on CUDA tensors (the references of phases 6 and 9 only; the
    package itself has no such path)."""
    import torch

    import vdx_torch.ops.attention as A
    import vdx_torch.ops.groupnorm as G
    from vdx_torch.kernels.flash_attention import (flash_attention_dt_plain,
                                                   flash_attention_plain)
    from vdx_torch.kernels.groupnorm import group_norm_moments_plain

    def attn(q, k, v, *, scale, exp_impl, block_k, **_):
        # batch slices keep the score tensor small
        return torch.cat([
            flash_attention_dt_plain(q[i:i + 2], k[i:i + 2], v[i:i + 2],
                                     scale=scale, exp_impl=exp_impl,
                                     block_k=block_k)
            for i in range(0, q.shape[0], 2)])

    def gn(x, num_groups, scale, bias, eps=1e-5, with_silu=True):
        B, C = x.shape[0], x.shape[-1]
        y = group_norm_moments_plain(x.reshape(B, -1, C), scale, bias,
                                     num_groups=num_groups, eps=eps,
                                     with_silu=with_silu)
        return y.reshape(x.shape)

    swaps = {"K1": (A, "flash_attention_dt", attn),
             "K2/K3": (G, "group_norm_silu_cuda", gn),
             "K4": (A, "flash_attention", flash_attention_plain)}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in
             (swaps[k] for k in kernels)]
    for k in kernels:
        mod, attr, fn = swaps[k]
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def counters():
    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels.groupnorm import (fused_group_norm,
                                             fused_group_norm_2phase)
    from vdx_torch.kernels.temporal_attention_cp import temporal_attention_cp

    return {"K1": KA.flash_attention_dt, "K2": fused_group_norm,
            "K3": fused_group_norm_2phase, "K4": KA.flash_attention,
            "K6": KA.flash_attention_blockdiag,
            "K7": KA.flash_attention_blockdiag_tc,
            "K8": KA.flash_attention_blockdiag_tc2,
            "K9": temporal_attention_cp}


def form_counters() -> dict:
    """Every flash attention count but K1's and K4's on the wgmma + TMA
    pipeline, by KA.counter_for's names: K1' per form and K5 on that
    pipeline, and off it (the template and SIMT kernels) each form's
    " template" name, staticmax as "K1 static" and K4 as "K4 template"."""
    from vdx_torch.kernels import flash_attention as KA

    return {n: c for n, c in KA.launch_counts().items() if n not in ("K1", "K4")}


def reset_counters() -> None:
    from vdx_torch.kernels import flash_attention as KA

    for fn in counters().values():
        fn.launches = 0
    forms = KA.flash_attention_dt.form_launches
    for name in forms:
        forms[name] = 0
    KA.flash_attention.template_launches = 0


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()} | form_counters()


def timed_call(pipe, label: str, **kw):
    """One __call__ with the counters reset just before it and read once
    more as the VAE decode starts (a Python read, no synchronise), which
    splits each kernel's launches between the denoise loop and the
    decode. -> (seconds, frames, latents, launches by stage, peak bytes)."""
    import torch

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
    out = pipe(PROMPT, **kw)
    frames = out.frames[0]  # numpy: the call has synchronised
    secs = time.time() - t0
    launches = read_counters()
    del pipe._decode
    by_stage = {"denoise": dict(at_decode),
                "decode": {k: n - at_decode[k] for k, n in launches.items()}}
    peak = torch.cuda.max_memory_allocated()
    lat_finite = bool(torch.isfinite(out.latents).all())
    log(f"[{label}] {kw['num_inference_steps']} "
        f"{(kw.get('scheduler') or pipe.scheduler).upper()} steps + decode: "
        f"{secs:.3f}s frames/s={frames.shape[0] / secs:.4f} "
        f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB) "
        f"launches={launches} denoise={by_stage['denoise']} "
        f"decode={by_stage['decode']} frames {frames.shape} {frames.dtype} "
        f"min={int(frames.min())} max={int(frames.max())} "
        f"mean={float(frames.mean()):.2f} latents_finite={lat_finite}")
    return secs, frames, lat_finite, by_stage, peak


def check_no_forms(by_stage: dict, what: str) -> None:
    """The pipeline's attention is K1 and K4 on the wgmma + TMA pipeline
    only: no K1' or K5 launch on either kernel, no template staticmax ("K1
    static") or template K4 ("K4 template") in a timed call, so the K1 and
    K4 counts prove which kernel ran."""
    ran = {n: d[n] for d in by_stage.values() for n in form_counters() if d[n]}
    if ran:
        raise SystemExit(f"{what}: forms-kernel launches in the pipeline: "
                         f"{ran}")


def check_frames(frames, shape, lat_finite, what: str) -> None:
    import numpy as np

    if frames.shape != shape or frames.dtype != np.uint8:
        raise SystemExit(f"{what}: bad frames {frames.shape} {frames.dtype}")
    if not lat_finite or frames.min() == frames.max():
        raise SystemExit(f"{what}: frames are constant or latents are not finite")


def record_temporal_sites(unet, hw: int, sites: dict, calls: dict):
    """Forward hooks on every motion-module attention (attn1 and attn2 of
    each TemporalBlock): count the calls per (hw, P) and keep, on the
    host, q, k and v [P, F, H, D] of the first call at each P, which is
    the first motion module's attn1 at that level. -> the hook handles."""
    from vdx_torch.nn.temporal import TemporalBlock

    def hook(mod, args, out):
        x = args[0]  # [P, F, C]: norm(x) + frame PE, as attn's forward got it
        P, F_ = x.shape[:2]
        calls[(hw, P)] = calls.get((hw, P), 0) + 1
        if (hw, P) not in sites:
            sites[(hw, P)] = tuple(
                proj(x).view(P, F_, mod.heads, mod.head_dim).cpu()
                for proj in (mod.to_q, mod.to_k, mod.to_v))

    return [attn.register_forward_hook(hook)
            for m in unet.modules() if isinstance(m, TemporalBlock)
            for attn in (m.attn1, m.attn2)]


def reference_eval(pipe, scheduler: str, hw: int, swap, per_call: dict,
                   sites: dict, calls: dict):
    """One denoiser evaluation at the first step's input of ``scheduler``
    at hw x hw, kernel path against the same call with the ``swap``
    kernels replaced by their plain versions; checks the launches of the
    kernel call and the agreement. The kernel call also fills ``sites``
    and ``calls`` (:func:`record_temporal_sites`)."""
    import torch

    from vdx_torch.schedulers import get_sampler

    t0 = time.time()
    with torch.inference_mode():
        ctx = pipe.encode_prompt(PROMPT, WORKLOAD["negative_prompt"])
        tables = pipe._get_tables(scheduler, TIMED_STEPS)
        lat = pipe.initial_noise((1, 16, hw // 8, hw // 8, 4), WORKLOAD["seed"])
        lat = lat * tables.init_noise_sigma
        model_in = get_sampler(scheduler).scale_model_input(
            torch.cat([lat, lat]), 0, tables)
        t_b = tables.timesteps[0].expand(2)
        hooks = record_temporal_sites(pipe.unet, hw, sites, calls)
        reset_counters()
        eps_k = pipe.unet(model_in, t_b, ctx)
        launches = read_counters()
        for h in hooks:
            h.remove()
        with plain_versions(*swap):
            eps_p = pipe.unet(model_in, t_b, ctx)
        rel = ((eps_k.float() - eps_p.float()).norm() / eps_p.float().norm()).item()
    finite = bool(torch.isfinite(eps_k).all())
    log(f"[reference{hw}] UNet eval at the first {scheduler} step's input, "
        f"{hw}x{hw}: rel_l2(kernels vs plain {'+'.join(swap)})={rel:.3e} "
        f"(bound 5e-2: bf16 rounding flips compounding over the network) "
        f"finite={finite} launches_per_unet_call={launches} "
        f"({time.time() - t0:.1f}s)")
    if not (finite and rel < 5e-2):
        raise SystemExit(f"{hw}: denoiser output disagrees with the plain versions")
    bad = {k: n for k, n in per_call.items() if launches[k] != n}
    if bad:
        raise SystemExit(f"{hw}: expected launches per UNet call {per_call}, "
                         f"got {launches}")


def drive_gn2560(dev) -> dict:
    """The GN dispatch that a resnet block calls (ops.groupnorm
    .group_norm_silu) once at each 2560-channel shape, the counters reset
    just before. -> {"dispatch": launches}"""
    import torch

    from vdx_torch.ops.groupnorm import group_norm_silu

    xs = [torch.randn(shape, device=dev).to(dtype)
          for shape, dtype in zip(GN2560_SHAPES, (torch.bfloat16, torch.float32))]
    scale, bias = torch.ones(2560, device=dev), torch.zeros(2560, device=dev)
    torch.cuda.synchronize()
    reset_counters()
    for x in xs:
        group_norm_silu(x, 32, scale, bias, 1e-5)
    launches = read_counters()
    torch.cuda.synchronize()
    log(f"[gn2560] ops.groupnorm.group_norm_silu at {GN2560_SHAPES} "
        f"(bf16, fp32): launches={launches}")
    if launches["K2"] != 2 or launches["K3"]:
        raise SystemExit(f"gn2560: expected K2 twice, K3 never: {launches}")
    return {"dispatch": launches}


def check_gn_sites(dev) -> dict:
    """Every GroupNorm of one UNet call (CFG batch 2 x 16 frames) and one
    8-frame decode chunk at 512x512 and 768x768, traced on the meta device
    (scripts/bench_gn_torch.py), each driven through ops.groupnorm as
    often as the path runs it with the GN counters reset: one [gn] line a
    path with the launches (checked against the launch plan, kernels
    .groupnorm.gn_plan), the summed kernel ms, the summed bound and the
    summed F.group_norm (+ F.silu) ms. -> {(size, "unet" or "decode"):
    launches by counter}"""
    import torch

    from vdx_torch.kernels import groupnorm as KG

    bench = load_script("bench_gn_torch")
    expected = {}
    for size in (512, 768):
        for path, sites in bench.gn_sites(size, size).items():
            t0 = time.time()
            want = {"K2": 0, "K3": 0}
            for (B, S, C, G, _, _), n in sites.items():
                want[KG.gn_plan(B, S, C, G, 2).route] += n
            launches = bench.drive(sites, dev)
            sums = bench.path_sums(bench.time_sites(sites, dev))
            log(f"[gn] {path} {size}x{size}: {sums['sites']} GroupNorms "
                f"through ops.groupnorm, launches {launches} (plan {want}) "
                f"kernel_ms={sums['ms']:.4f} bound_ms={sums['bound_ms']:.4f} "
                f"library_ms={sums['library_ms']:.4f} (F.group_norm + F.silu "
                f"where the site has it; each site's ms times its count) "
                f"({time.time() - t0:.1f}s)")
            if launches != want:
                raise SystemExit(f"[gn] {path} {size}: launches {launches}, "
                                 f"the plan says {want}")
            expected[(str(size), path)] = want
            torch.cuda.empty_cache()
    return expected


def check_gn_launches(by_stage: dict, per_call: dict, size: str,
                      chunks: int) -> None:
    """A timed call's GroupNorm launches: the plan's K2 and K3 counts per
    UNet call times the steps, per decode chunk times the chunks."""
    for stage, times, path in (("denoise", TIMED_STEPS, "unet"),
                               ("decode", chunks, "decode")):
        want = {k: n * times for k, n in per_call[(size, path)].items()}
        got = {k: by_stage[stage][k] for k in want}
        if got != want:
            raise SystemExit(f"{size}: GroupNorm launches in the {stage} "
                             f"{got}, the plan says {want}")


def check_noise_on_card(pipe, dev) -> None:
    """The seeded initial noise (vdx's jax.random.normal, computed by
    vdx_torch.core.rng) on the card against the CPU, at both paths'
    latent shapes: the bits equal, the normals within RNG_TOL."""
    import torch

    from vdx_torch.core import rng

    seed = WORKLOAD["seed"]
    for hw in (512, 768):
        shape = (1, 16, hw // 8, hw // 8, 4)
        bits_equal = torch.equal(rng.random_bits(seed, shape, dev).cpu(),
                                 rng.random_bits(seed, shape))
        noise = pipe.initial_noise(shape, seed)
        err = (noise.cpu() - rng.normal(seed, shape)).abs().max().item()
        log(f"[rng] seed {seed} latents {list(shape)}: card bits == cpu "
            f"bits {bits_equal}, max |card - cpu| normal {err:.3e} "
            f"(tol {RNG_TOL}), std {noise.std().item():.4f}")
        if not (bits_equal and err <= RNG_TOL and noise.device.type == "cuda"):
            raise SystemExit("the seeded noise differs between the card and the CPU")


TEMPORAL = (  # kernel, entry point, the TPU kernel it replaces
    ("K6", "ops.attention.dot_product_attention(impl='blockdiag') -> "
     "flash_attention_blockdiag", "vdx/kernels/flash_attention.py:490"),
    ("K7", "flash_attention_blockdiag_tc", "vdx/kernels/flash_attention.py:556"),
    ("K8", "flash_attention_blockdiag_tc2", "vdx/kernels/flash_attention.py:684"),
    ("K9", "temporal_attention_cp", "vdx/kernels/temporal_attention_cp.py:62"),
)


# each temporal kernel's mode of csrc/temporal_attention.cu
TEMPORAL_MODE = {"K6": "blockdiag", "K7": "tc", "K8": "tc", "K9": "cp"}


def temporal_entries(P: int, H: int, D: int) -> dict:
    """kernel -> (its entry point, its plain version), each f(q, k, v), at
    a [P, F, H, D] site; K9 with block_p = gcd(P, 128), vdx's 128 except
    at the 768 level-3 site (P = 288: 32)."""
    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels import temporal_attention_cp as KT
    from vdx_torch.ops.attention import dot_product_attention

    scale = D ** -0.5
    block_p = math.gcd(P, 128)
    tc_plain = lambda q, k, v: KA.flash_attention_blockdiag_tc_plain(  # noqa: E731
        q, k, v, scale=scale)
    return {
        "K6": (lambda q, k, v: dot_product_attention(q, k, v, impl="blockdiag"),
               lambda q, k, v: KA.flash_attention_blockdiag_plain(
                   q, k, v, scale=scale)),
        "K7": (lambda q, k, v: KA.flash_attention_blockdiag_tc(
            q, k, v, scale=scale, heads=H), tc_plain),
        "K8": (lambda q, k, v: KA.flash_attention_blockdiag_tc2(
            q, k, v, scale=scale, heads=H), tc_plain),
        "K9": (lambda q, k, v: KT.temporal_attention_cp(
            q, k, v, scale=scale, block_p=block_p),
            lambda q, k, v: KT.temporal_attention_cp_plain(q, k, v, scale=scale)),
    }


def check_temporal(dev, sites: dict, calls: dict):
    """Phase 12. The motion-module sites kept in phases 6 and 9, on the
    card: every entry point once per site with the counters reset (the
    run whose counts the kernels line reports), then per site and entry
    point the kernel against its plain version, the kernel, plain, SDPA
    and eager xla_bf16p times, and the kernel's agreement with xla_bf16p
    (what impl="auto" runs there). -> (rows, launches, per-UNet-call ms)"""
    import torch
    import torch.nn.functional as F

    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.ops.attention import dot_product_attention

    keys = sorted(sites, key=lambda key: (key[0], -key[1]))  # 512 first, L0 first
    level = {key: sum(1 for o in keys if o[0] == key[0] and o[1] > key[1])
             for key in keys}
    rows, per_call = [], {}
    with torch.inference_mode():
        on_dev = {key: tuple(t.to(dev) for t in sites[key]) for key in keys}
        torch.cuda.synchronize()
        reset_counters()
        for key in keys:
            q, k, v = on_dev[key]
            for call, _ in temporal_entries(q.shape[0], q.shape[2],
                                            q.shape[3]).values():
                call(q, k, v)
        launches = read_counters()
        torch.cuda.synchronize()
        log(f"[temporal] every entry point once at each of {len(keys)} sites "
            f"{[list(on_dev[key][0].shape) for key in keys]}: "
            f"launches={launches}")
        for kname, _, _ in TEMPORAL:
            if launches[kname] != len(keys):
                raise SystemExit(f"temporal: {kname} launched {launches[kname]} "
                                 f"times over {len(keys)} sites")
        for key in keys:
            t0 = time.time()
            hw, P = key
            q, k, v = on_dev[key]
            _, F_, H, D = q.shape
            where = f"L{level[key]} motion attn1, {hw}x{hw}"
            eager = lambda: dot_product_attention(  # noqa: E731
                q, k, v, impl="xla_bf16p")
            eager_out = eager()
            eager_ms = cuda_ms(eager)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [P, H, F, D]
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=D ** -0.5))
            site_calls = calls[key]
            per_call.setdefault(str(hw), {"eager_xla_bf16p_ms": 0.0,
                                          "sites": 0})
            per_call[str(hw)]["eager_xla_bf16p_ms"] += eager_ms * site_calls
            per_call[str(hw)]["sites"] += site_calls
            for kname, entry, replaces in TEMPORAL:
                call, plain = temporal_entries(P, H, D)[kname]
                out, ref = call(q, k, v), plain(q, k, v)
                err = (out.float() - ref.float()).abs()
                tol = bf16_tol(ref)
                agree = (out.float() - eager_out.float()).abs().max().item()
                agree_tol = 4 * bf16_tol(eager_out)
                ms = cuda_ms(lambda: call(q, k, v))
                plain_ms = cuda_ms(lambda: plain(q, k, v), reps=3, warmup=1)
                per_call[str(hw)][f"{kname}_ms"] = \
                    per_call[str(hw)].get(f"{kname}_ms", 0.0) + ms * site_calls
                # two F x F x D products; K9's arithmetic is fp32 (FMA
                # pipes), K6-K8's operands bf16
                peak = H100_FP32_FLOPS if kname == "K9" else H100_BF16_FLOPS
                b_ms, b_by = bound(
                    4.0 * P * H * F_ * F_ * D, 4 * q.numel() * q.element_size(),
                    peak, float(P * H * F_ * F_))  # one exponential a score
                route = KA.temporal_kernel_for(TEMPORAL_MODE[kname], q.dtype)
                rows.append(dict(
                    name=f"{kname} {entry.rsplit(' ', 1)[-1]} "
                         f"[{P},{F_},{H},{D}] ({where}; {route})",
                    kernel=kname, path="temporal", stage="sites", route="cuda",
                    source="vdx_torch/csrc/temporal_attention.cu",
                    replaces=replaces, max_abs_err=err.max().item(),
                    mean_abs_err=err.mean().item(), tol=tol, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms,
                    library="F.scaled_dot_product_attention on [P, H, F, D] "
                            "views", bound_ms=b_ms, bound_by=b_by,
                    xla_bf16p_ms=eager_ms, xla_bf16p_max_abs_diff=agree,
                    xla_bf16p_tol=agree_tol, calls_per_unet_call=site_calls,
                    seconds=time.time() - t0,
                    note=(f"block_p={math.gcd(P, 128)} (128 does not divide "
                          f"P)" if kname == "K9" and P % 128 else "")))
                del out, ref, err
            log(f"[temporal] {where} [{P},{F_},{H},{D}] x{site_calls} per UNet "
                f"call: eager xla_bf16p {eager_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
                + ", ".join(f"{r['kernel']} {r['ms']:.4f} ms (plain "
                            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
                            f"{r['bound_by']}, err {r['max_abs_err']:.2e} tol "
                            f"{r['tol']:.2e}, vs xla_bf16p "
                            f"{r['xla_bf16p_max_abs_diff']:.2e} tol "
                            f"{r['xla_bf16p_tol']:.2e})"
                            for r in rows[-len(TEMPORAL):])
                + f" ({time.time() - t0:.1f}s)")
            del on_dev[key], eager_out, qt, kt, vt
            torch.cuda.empty_cache()
    log(f"[temporal] per UNet call (sum over its temporal sites, ms): {per_call}")
    bad = [r["name"] for r in rows if not (r["max_abs_err"] <= r["tol"] and
           r["xla_bf16p_max_abs_diff"] <= r["xla_bf16p_tol"])]
    if bad:
        raise SystemExit(f"temporal kernels disagree with their plain versions "
                         f"or with xla_bf16p: {bad}")
    return rows, {"sites": launches}, per_call


# phase 13: the attention micro-benchmark's shapes, [32, 4096, 8, 40] (the
# 512 level-0 self-attention, scripts/bench_attention.py's), the 768
# level-2 [32, 576, 8, 160] and the same length at D = 256 (the pipeline's
# one-consumer-warpgroup instance; no SD-1.5 site), every form at each,
# all on the wgmma + TMA pipeline (staticmax: K1; the others K1' and K5),
# and K4 (form None, the bench's k4 spec) at D = 256
FORM_SHAPES = ((32, 4096, 8, 40), (32, 576, 8, 160), (32, 576, 8, 256))
FORM_ROWS = [(form, shape) for shape in FORM_SHAPES
             for form in ("exp", "exp2", "fastexp2", "staticaug", "noexp",
                          "mxu_only", "staticmax")]
FORM_ROWS.append((None, (32, 576, 8, 256)))
# exp2 calls per score in each form (fastexp2 and noexp: none on the
# special-function unit; mxu_only: no softmax); fastexp2's cubic takes
# the FMA and integer pipes instead (bound term "alu", its SM clocks a
# score counted from the SASS: scripts/sass_forms.py)
FORM_EXPS = {"exp": 1, "exp2": 1, "fastexp2": 0, "staticmax": 1,
             "staticaug": 1, "noexp": 0, "mxu_only": 0, None: 1}
BENCH_ITERS = 16  # vdx's K in scripts/bench_attention.py


def load_script(name: str):
    """scripts/<name>.py as a module (bench_attn_torch: make_fn, fresh and
    chain; sass_forms: cubic_per_score)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_forms(dev):
    """Phase 13. Each row of FORM_ROWS: the micro-benchmark's chained loop
    (spec dt:1024:1024:<form>, k4 for K4; K = 16) on fresh seeded bf16
    inputs with the counters reset, the run whose counts the kernels line
    reports; then flash_attention_dt in that form (K4: flash_attention)
    against its plain version (same block_k) on the first two batch
    entries, and the kernel, plain and library times beside the bound.
    -> (rows, {stage: launches})"""
    import torch

    from vdx_torch.kernels import flash_attention as KA

    from vdx_torch.kernels import _lib

    bench = load_script("bench_attn_torch")
    sass = load_script("sass_forms")
    cubic, cubic_clocks, evals, diff = sass.cubic_per_score(
        _lib.build_info["path"])
    log(f"[forms] fastexp2's cubic from the SASS (scripts/sass_forms.py, "
        f"DP = {sass.DP}; fastexp2 - noexp {diff} over {evals} "
        f"evaluations): per score {cubic}, {cubic_clocks:.5f} SM clocks a score (fp32 128, "
        f"integer/compare 64, conversion 16 a clock per SM; issue 128)")
    rows, runs = [], {}
    for i, (form, (B, S, H, D)) in enumerate(FORM_ROWS):
        t0 = time.time()
        kname = KA.counter_for(form, torch.bfloat16, D, True)
        scale = D ** -0.5
        q, k, v = bench.fresh((B, S, H, D), S, 100 + i, dev, torch.bfloat16)
        spec = "k4" if form is None else f"dt:1024:1024:{form}"
        fn = bench.make_fn(spec, scale)
        torch.cuda.synchronize()
        reset_counters()
        looped = bench.chain(fn, q, k, v, BENCH_ITERS)
        launches = read_counters()
        torch.cuda.synchronize()
        stage = f"{form or 'K4'} [{B},{S},{H},{D}]"
        runs[stage] = launches
        others = {n: c for n, c in launches.items() if n != kname and c}
        if launches[kname] != BENCH_ITERS or others:
            raise SystemExit(f"forms: the loop of {stage} launched {launches}, "
                             f"expected {kname} {BENCH_ITERS} times, no other")
        if form is None:  # K4: one bf16 ulp at max|plain|
            kw = dict(scale=scale)
            call, plain = KA.flash_attention, KA.flash_attention_plain
            out = call(q, k, v, **kw)
            ref = plain(q[:2], k[:2], v[:2], **kw)
            e = (out[:2].float() - ref.float()).abs()
            err, mean_err = e.max().item(), e.mean().item()
            tol, mag = bf16_tol(ref), ref.float().abs().max().item()
            del ref, e
        else:
            kw = dict(scale=scale, block_k=1024, exp_impl=form)
            call = KA.flash_attention_dt
            plain = KA.flash_attention_dt_plain
            out = call(q, k, v, **kw)
            err, mean_err, tol, mag = KA.plain_err_tol(out[:2], q[:2], k[:2],
                                                       v[:2], **kw)
        finite = bool(torch.isfinite(looped).all() and torch.isfinite(out).all())
        del looped
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if form == "mxu_only":  # the scores rounded to bf16 by the matmul
            qf = (q.float() * (scale * KA.LOG2E)).to(q.dtype).transpose(1, 2)
            library = "two torch.matmul, bf16 scores"
            lib_fn = lambda: torch.matmul(torch.matmul(qf, kt.transpose(-1, -2)),  # noqa: E731
                                          vt)
        elif form == "noexp":
            library, lib_fn = "none (no library call computes noexp)", None
        else:
            library = "F.scaled_dot_product_attention"
            lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, scale=scale)

        def plain_slice():  # one two-entry slice, timed and scaled
            plain(q[:2], k[:2], v[:2], **kw)

        ms = cuda_ms(lambda: call(q, k, v, **kw))
        plain_ms = cuda_ms(plain_slice, reps=3, warmup=1) * (B // 2)
        lib_ms = cuda_ms(lib_fn, reps=5) if lib_fn else None
        scores = float(B * H * S * S)
        b_ms, b_by = bound(4.0 * scores * D, 4 * q.numel() * 2,
                           H100_BF16_FLOPS, FORM_EXPS[form] * scores,
                           cubic_clocks * scores if form == "fastexp2" else 0.0)
        note = "plain_ms: one two-entry slice timed, times 16"
        if form in ("fastexp2", "noexp"):
            note += ("; the kernel also sweeps q.k once more for each "
                     "1024-key period's max (2*B*H*S*S*D operations more, "
                     "the form's own cost, not in the bound)")
        if form == "fastexp2":
            note += (f"; bound term alu: the cubic's {cubic} instructions a "
                     f"score from the SASS, {cubic_clocks:.5f} SM clocks")
        entry = ("flash_attention" if form is None else
                 f"flash_attention_dt exp_impl={form}")
        rows.append(dict(
            name=f"{kname} {entry} [{B},{S},{H},{D}] (attention "
                 f"micro-benchmark, {spec})",
            kernel=kname, path="forms", stage=stage, route="cuda",
            source=f"vdx_torch/csrc/{KA.kernel_for(form, torch.bfloat16, D, True)}.cu",
            replaces=("vdx/kernels/flash_attention.py:393" if form == "staticaug"
                      else "vdx/kernels/flash_attention.py:135" if form is None
                      else "vdx/kernels/flash_attention.py:204"),
            max_abs_err=err, mean_abs_err=mean_err, tol=tol, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, library=library,
            bound_ms=b_ms, bound_by=b_by,
            seconds=time.time() - t0, note=note))
        r = rows[-1]
        log(f"[forms] {r['name']}: launches {launches[kname]} in the loop "
            f"(K={BENCH_ITERS}) max_abs_err={err:.3e} "
            f"mean_abs_err={mean_err:.3e} tol={tol:.3e} max|plain|={mag:.3e} "
            f"(one bf16 ulp at max|plain|, KA.plain_err_tol) "
            f"finite={finite} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms="
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} ({library}) "
            f"bound_ms={b_ms:.4f} ({r['bound_by']}) ({r['seconds']:.1f}s)")
        if not (finite and err <= tol):
            raise SystemExit(f"forms: {r['name']} disagrees with its plain "
                             f"version or is not finite")
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    return rows, runs


def main() -> int:
    faulthandler.dump_traceback_later(HANG_BUDGET_S, exit=True)
    t_start = time.time()
    if not (ROOT / "vdx_torch" / "csrc").is_dir():
        raise SystemExit(f"vdx_torch/csrc not found beside {__file__}: run "
                         "chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SM_CLOCKS_PER_S["rate"] = sms * clock_mhz * 1e6
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} | nvidia-smi: {smi} | SMs {sms} "
        f"clocks.max.sm {clock_mhz:.0f} MHz: exp2 bound rate "
        f"{EXP2_PER_CLOCK * SM_CLOCKS_PER_S['rate']:.4e}/s (16 a clock per "
        f"SM) | tf32 off "
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
        log("[build] " + " | ".join(
            line for line in info["nvcc_output"].splitlines()
            if line.startswith("$ ")))
        log("[build] ptxas per kernel (registers, spill stores/loads): "
            + ptxas_summary(info["nvcc_output"]))

    # 3. kernels against their plain versions
    t0 = time.time()
    rows, edge_launches = check_kernels(dev)
    torch.cuda.empty_cache()
    log(f"[kernels] all within tolerance ({time.time() - t0:.1f}s)")
    # each row's launches come from the run of its own path: a timed call
    # ("512", "768"), the GN dispatch at 2560 channels, the temporal sites
    runs = {"gn2560": drive_gn2560(dev)}
    torch.cuda.empty_cache()
    gn_per_call = check_gn_sites(dev)

    # 4. init: the pipeline with its defaults (Euler; the 512 path asks
    # for DDIM per call)
    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.pipelines import AnimateDiffPipeline

    t0 = time.time()
    pipe = AnimateDiffPipeline.with_random_params(seed=0, policy=BF16_POLICY)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", pipe.unet), ("vae", pipe.vae),
                                ("text", pipe.text_encoder))}
    log(f"[init] params={sum(n_params.values())} {n_params} bf16 on the card "
        f"default scheduler={pipe.scheduler} device={pipe.device} "
        f"({time.time() - t0:.1f}s)")
    if pipe.scheduler != "euler" or pipe.device.type != "cuda":
        raise SystemExit("the pipeline's defaults should be euler on cuda")
    check_noise_on_card(pipe, dev)

    # 5. warm-up
    t0 = time.time()
    out = pipe(PROMPT, num_inference_steps=2, scheduler="ddim", **WORKLOAD)
    log(f"[warmup] 2 steps, frames {out.frames[0].shape} "
        f"({time.time() - t0:.1f}s)")

    # 6. reference: one denoiser evaluation, kernels against plain versions
    sites, site_calls = {}, {}  # the motion-module sites, for phase 12
    reference_eval(pipe, "ddim", 512, ("K1", "K2/K3"),
                   {"K1": 10, "K4": 0} | gn_per_call[("512", "unet")],
                   sites, site_calls)
    torch.cuda.empty_cache()

    # 7. the timed call (512x512, DDIM)
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "timed", num_inference_steps=TIMED_STEPS, scheduler="ddim",
        **WORKLOAD)
    if by_stage["denoise"]["K1"] != 10 * TIMED_STEPS or by_stage["decode"]["K1"]:
        raise SystemExit(f"launches {by_stage}: expected K1 {10 * TIMED_STEPS} "
                         "times in the denoise loop (10 per UNet call), none after")
    check_no_forms(by_stage, "512x512 DDIM")
    chunks = WORKLOAD["num_frames"] // WORKLOAD["decode_chunk"]
    check_gn_launches(by_stage, gn_per_call, "512", chunks)
    check_frames(frames, (16, 512, 512, 3), lat_finite, "512x512 DDIM")
    paths = {"512": dict(secs=secs, by_stage=by_stage, peak=peak,
                         frames=frames.shape[0])}

    # 8. warm-up of the 768x768 path (the pipeline's default sampler)
    t0 = time.time()
    out = pipe(PROMPT, num_inference_steps=2, **WORKLOAD_768)
    log(f"[warmup768] 2 {pipe.scheduler} steps, frames {out.frames[0].shape} "
        f"({time.time() - t0:.1f}s)")
    del out
    torch.cuda.empty_cache()

    # 9. reference at 768x768: only K4 swapped for its plain version
    reference_eval(pipe, pipe.scheduler, 768, ("K4",),
                   {"K1": 10, "K4": 5} | gn_per_call[("768", "unet")],
                   sites, site_calls)
    torch.cuda.empty_cache()

    # 10. the timed call (768x768, the default sampler: Euler)
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "timed768", num_inference_steps=TIMED_STEPS, **WORKLOAD_768)
    want = {"K1": 10 * TIMED_STEPS, "K4": 5 * TIMED_STEPS}
    if any(by_stage["denoise"][k] != n or by_stage["decode"][k]
           for k, n in want.items()):
        raise SystemExit(f"launches {by_stage}: expected {want} in the denoise "
                         "loop (K1 10, K4 5 per UNet call), none in the decode")
    check_no_forms(by_stage, "768x768 Euler")
    check_gn_launches(by_stage, gn_per_call, "768", chunks)
    check_frames(frames, (16, 768, 768, 3), lat_finite, "768x768 Euler")
    paths["768"] = dict(secs=secs, by_stage=by_stage, peak=peak,
                        frames=frames.shape[0])
    del frames
    torch.cuda.empty_cache()

    # 11. every sampler on the card: tables on the device, the loop's carry
    from vdx_torch.schedulers import _SAMPLERS

    t0 = time.time()
    sampler_runs = {}
    for name in sorted(set(m.__name__.rsplit(".", 1)[1] for m in _SAMPLERS.values())):
        t1 = time.time()
        out = pipe(PROMPT, num_inference_steps=SAMPLER_STEPS, scheduler=name,
                   **WORKLOAD)
        f = out.frames[0]
        check_frames(f, (16, 512, 512, 3), bool(torch.isfinite(out.latents).all()),
                     f"sampler {name}")
        sampler_runs[name] = dict(s=time.time() - t1, mean=float(f.mean()),
                                  std=float(f.std()))
    log(f"[samplers] {SAMPLER_STEPS} steps at 512x512 through __call__, "
        f"finite latents, non-constant frames: {sampler_runs} "
        f"({time.time() - t0:.1f}s)")

    # 12. the temporal family at the motion-module sites of 6 and 9
    t0 = time.time()
    t_rows, runs["temporal"], temporal_per_call = check_temporal(
        dev, sites, site_calls)
    rows += t_rows
    del sites
    torch.cuda.empty_cache()
    log(f"[temporal] all within tolerance ({time.time() - t0:.1f}s)")

    # 13. the attention forms: every K1'/K5 form through the
    # micro-benchmark's loop (scripts/bench_attn_torch.py)
    t0 = time.time()
    f_rows, runs["forms"] = check_forms(dev)
    rows += f_rows
    torch.cuda.empty_cache()
    log(f"[forms] all within tolerance ({time.time() - t0:.1f}s)")

    # Counts are per kernel at every shape, within the row's stage of its
    # path's run: the denoise loop of a timed call (per step), its VAE
    # decode (per chunk), the GN dispatch at 2560 channels, the temporal
    # sites (per site), or the micro-benchmark's loop of its form and shape.
    runs.update({p: d["by_stage"] for p, d in paths.items()})
    per = {"denoise": ("launches_per_step", TIMED_STEPS),
           "decode": ("launches_per_chunk", chunks),
           "sites": ("launches_per_site", len(t_rows) // len(TEMPORAL))}
    for r in rows:
        if runs[r["path"]][r["stage"]][r["kernel"]] == 0:
            raise SystemExit(f"{r['name']} never launched in its stage of its "
                             f"path's run: {runs[r['path']]}")

    def row_launches(r):
        n = runs[r["path"]][r["stage"]][r["kernel"]]
        out = {"launches": n, "path": r["path"], "stage": r["stage"]}
        if r["stage"] in per:
            out[per[r["stage"]][0]] = n / per[r["stage"]][1]
        return out

    summary = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | row_launches(r)
        | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "library_ms")}
        | {"bound_by": "bytes" if r["bound_by"] == "bytes" else "operations",
           "bound_term": r["bound_by"]}
        | {k: r[k] for k in ("xla_bf16p_ms", "xla_bf16p_max_abs_diff",
                             "calls_per_unet_call") if k in r}
        | ({"note": r["note"]} if r["note"] else {})
        for r in rows
    ], "temporal_per_unet_call_ms": temporal_per_call, "paths": {
        p: {"timed_call_s": d["secs"], "frames_per_s": d["frames"] / d["secs"],
            "steps": TIMED_STEPS, "max_memory_allocated": d["peak"],
            "launches_by_stage": d["by_stage"]}
        for p, d in paths.items()},
        "samplers": sampler_runs,
        # every flash attention counter (kernels.flash_attention
        # .launch_counts) with its launches at phase 3's edges
        "edge_launches": edge_launches,
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
