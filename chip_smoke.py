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
  8. warm-up of the 768x768 path: the pipeline's default sampler (Euler)
     at 2 steps
  9. reference at 768x768: one denoiser evaluation at the first Euler
     step's input, kernel path against the same call with only K4 swapped
     for its plain version
 10. the 768x768 timed call: 16 frames, 25 Euler steps (the pipeline's
     default sampler), CFG 7.5, bf16; counters as in 7 (K1 at levels 0
     and 1, K4 at level 2)
 11. every sampler at 512x512, 3 steps, through __call__
Phase 3 also checks K4 at edge shapes (D = 20, D = 256, a ragged
multi-tile Skv) and K1/K4 with fp32 operands. Then the kernels JSON line
(each row's launches from the timed call of its own path), the
nvidia-smi line and, last, the contract line {"ok": true, "device": ...}.

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
# whole run, build included, takes under two minutes on an H100
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
WORKLOAD_768 = dict(WORKLOAD, height=768, width=768)  # default scheduler
PROMPT = "a corgi walking on the beach, sunset lighting, high quality"
TIMED_STEPS = 25
SAMPLER_STEPS = 3
# fp32 operands: both sides sum fp32 products (up to ~10^3 terms) in
# different orders, ~1e-6 apart on O(1) outputs; 1e-4 leaves margin and
# still catches any bf16 rounding (~4e-3).
FP32_TOL = 1e-4


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


def ptxas_summary(text: str) -> str:
    """One entry per kernel instantiation from nvcc's ``-Xptxas -v``."""
    import re

    out, name, spill = [], None, ""
    for line in text.splitlines():
        # the kernel's name follows its length in the mangled symbol
        m = re.search(r"entry function '.*?(?<=\d)((?:flash|gn)_\w+?_kernel)"
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
    for kname, (B, S, H, D), path, site, one_slice in attn_cases:
        t0 = time.time()
        fn, plain = ((KA.flash_attention_dt, KA.flash_attention_dt_plain)
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
                           H100_BF16_FLOPS)
        label = {"K1": "flash_attention_dt staticmax",
                 "K4": "flash_attention running-max"}[kname]
        rows.append(dict(
            name=f"{kname} {label} [{B},{S},{H},{D}] ({site}, {path}x{path})",
            kernel=kname, path=path, stage="denoise", route="cuda",
            source=("vdx_torch/csrc/flash_attention.cu" if kname == "K1"
                    else "vdx_torch/csrc/flash_attention_runmax.cu"),
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

    # the gate sends the 768 level-0 resnet GN (a 184 KB group slab) to K3
    if KG.k2_viable(9216, 320, 32, 2) or not KG.k3_viable(9216, 320, 32, 2):
        raise SystemExit("GN gate: [32, 9216, 320] bf16 should go to K3")
    gn_cases = (  # (kernel, shape, eps, silu, where on its path, path, stage)
        ("K2", (32, 4096, 320), 1e-5, True, "UNet level-0 resnet GN-SiLU",
         "512", "denoise"),
        ("K3", (2, 65536, 320), 1e-6, False, "level-0 motion-module GN",
         "512", "denoise"),
        ("K3", (8, 262144, 128), 1e-6, True, "VAE decoder GN-SiLU at 512x512",
         "512", "decode"),
        ("K3", (32, 9216, 320), 1e-5, True,
         "UNet level-0 resnet GN-SiLU at 768x768", "768", "denoise"),
        ("K3", (8, 589824, 128), 1e-6, True, "VAE decoder GN-SiLU at 768x768",
         "768", "decode"),
    )
    for kname, (B, S, C), eps, silu, where, path, stage in gn_cases:
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
            kernel=kname, path=path, stage=stage, route="cuda",
            source="vdx_torch/csrc/groupnorm.cu",
            replaces=("vdx/kernels/groupnorm.py:117" if kname == "K2"
                      else "vdx/kernels/groupnorm.py:205"),
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
            tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library="F.group_norm" + (" + F.silu" if silu else ""),
            bound_ms=b_ms, bound_by=b_by, seconds=time.time() - t0, note=""))
        del x, out, ref, xt
        torch.cuda.empty_cache()

    for r in rows:
        log(f"[kernels] {r['name']}: max_abs_err={r['max_abs_err']:.3e} "
            f"mean_abs_err={r['mean_abs_err']:.3e} tol={r['tol']:.3e} "
            f"(one bf16 ulp at max|plain|: fp32 sums in another order) "
            f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} ({r['library']}) "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"{r['note'] + ' ' if r['note'] else ''}{r['seconds']:.1f}s")
    bad = [r["name"] for r in rows if not r["max_abs_err"] <= r["tol"]]
    bad += check_attention_edges(dev)
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


def check_attention_edges(dev):
    """K4 at shapes off the main path (D % 8 != 0, D = 256, a multi-tile
    ragged Skv) in bf16, and K1/K4 with fp32 operands, each against its
    plain version; -> the names of the cases that disagree."""
    import torch

    from vdx_torch.kernels import flash_attention as KA

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = (  # (kernel, dtype, B, Sq, Skv, H, D)
        ("K4", torch.bfloat16, 2, 300, 300, 2, 20),
        ("K4", torch.bfloat16, 2, 300, 700, 2, 256),
        ("K4", torch.bfloat16, 2, 1000, 1000, 2, 160),
        ("K1", torch.float32, 2, 1024, 1024, 2, 40),
        ("K1", torch.float32, 2, 1024, 1024, 2, 80),
        ("K4", torch.float32, 2, 576, 576, 8, 160),
        ("K4", torch.float32, 2, 300, 300, 2, 20),
    )
    bad = []
    for kname, dtype, B, Sq, Skv, H, D in cases:
        fn, plain = ((KA.flash_attention_dt, KA.flash_attention_dt_plain)
                     if kname == "K1" else
                     (KA.flash_attention, KA.flash_attention_plain))
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
                   for S in (Sq, Skv, Skv))
        out = fn(q, k, v, scale=D ** -0.5)
        ref = plain(q, k, v, scale=D ** -0.5)
        err = (out.float() - ref.float()).abs().max().item()
        fp32 = dtype == torch.float32
        tol = FP32_TOL if fp32 else bf16_tol(ref)
        name = f"{kname} {str(dtype)[6:]} [{B},{Sq}/{Skv},{H},{D}]"
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            + ("(fp32: sums of up to 10^3 products in another order)" if fp32
               else "(one bf16 ulp at max|plain|)"))
        if not err <= tol:
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
    from vdx_torch.kernels.flash_attention import (flash_attention,
                                                   flash_attention_dt)
    from vdx_torch.kernels.groupnorm import (fused_group_norm,
                                             fused_group_norm_2phase)

    return {"K1": flash_attention_dt, "K2": fused_group_norm,
            "K3": fused_group_norm_2phase, "K4": flash_attention}


def reset_counters() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


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


def check_frames(frames, shape, lat_finite, what: str) -> None:
    import numpy as np

    if frames.shape != shape or frames.dtype != np.uint8:
        raise SystemExit(f"{what}: bad frames {frames.shape} {frames.dtype}")
    if not lat_finite or frames.min() == frames.max():
        raise SystemExit(f"{what}: frames are constant or latents are not finite")


def reference_eval(pipe, scheduler: str, hw: int, swap, per_call: dict):
    """One denoiser evaluation at the first step's input of ``scheduler``
    at hw x hw, kernel path against the same call with the ``swap``
    kernels replaced by their plain versions; checks the launches of the
    kernel call and the agreement."""
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
        reset_counters()
        eps_k = pipe.unet(model_in, t_b, ctx)
        launches = read_counters()
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
        log("[build] " + " | ".join(
            line for line in info["nvcc_output"].splitlines()
            if line.startswith("$ ")))
        log("[build] ptxas per kernel (registers, spill stores/loads): "
            + ptxas_summary(info["nvcc_output"]))

    # 3. kernels against their plain versions
    t0 = time.time()
    rows = check_kernels(dev)
    torch.cuda.empty_cache()
    log(f"[kernels] all within tolerance ({time.time() - t0:.1f}s)")

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

    # 5. warm-up
    t0 = time.time()
    out = pipe(PROMPT, num_inference_steps=2, scheduler="ddim", **WORKLOAD)
    log(f"[warmup] 2 steps, frames {out.frames[0].shape} "
        f"({time.time() - t0:.1f}s)")

    # 6. reference: one denoiser evaluation, kernels against plain versions
    reference_eval(pipe, "ddim", 512, ("K1", "K2/K3"), {"K1": 10, "K4": 0})
    torch.cuda.empty_cache()

    # 7. the timed call (512x512, DDIM)
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "timed", num_inference_steps=TIMED_STEPS, scheduler="ddim",
        **WORKLOAD)
    if by_stage["denoise"]["K1"] != 10 * TIMED_STEPS or by_stage["decode"]["K1"]:
        raise SystemExit(f"launches {by_stage}: expected K1 {10 * TIMED_STEPS} "
                         "times in the denoise loop (10 per UNet call), none after")
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
    reference_eval(pipe, pipe.scheduler, 768, ("K4",), {"K1": 10, "K4": 5})
    torch.cuda.empty_cache()

    # 10. the timed call (768x768, the default sampler: Euler)
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "timed768", num_inference_steps=TIMED_STEPS, **WORKLOAD_768)
    want = {"K1": 10 * TIMED_STEPS, "K4": 5 * TIMED_STEPS}
    if any(by_stage["denoise"][k] != n or by_stage["decode"][k]
           for k, n in want.items()):
        raise SystemExit(f"launches {by_stage}: expected {want} in the denoise "
                         "loop (K1 10, K4 5 per UNet call), none in the decode")
    check_frames(frames, (16, 768, 768, 3), lat_finite, "768x768 Euler")
    paths["768"] = dict(secs=secs, by_stage=by_stage, peak=peak,
                        frames=frames.shape[0])
    del frames
    torch.cuda.empty_cache()
    for r in rows:
        if paths[r["path"]]["by_stage"][r["stage"]][r["kernel"]] == 0:
            raise SystemExit(f"{r['name']} never launched in its stage of its "
                             f"path's timed call: {paths[r['path']]['by_stage']}")

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

    # Counts are per kernel at every shape, within the row's stage of its
    # path's timed call: the denoise loop (per step) or the VAE decode
    # (per chunk).
    chunks = WORKLOAD["num_frames"] // WORKLOAD["decode_chunk"]

    def row_launches(r):
        n = paths[r["path"]]["by_stage"][r["stage"]][r["kernel"]]
        per = (("launches_per_step", n / TIMED_STEPS) if r["stage"] == "denoise"
               else ("launches_per_chunk", n / chunks))
        return {"launches": n, "path": r["path"], "stage": r["stage"],
                per[0]: per[1]}

    summary = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | row_launches(r)
        | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}
        | ({"note": r["note"]} if r["note"] else {})
        for r in rows
    ], "paths": {
        p: {"timed_call_s": d["secs"], "frames_per_s": d["frames"] / d["secs"],
            "steps": TIMED_STEPS, "max_memory_allocated": d["peak"],
            "launches_by_stage": d["by_stage"]}
        for p, d in paths.items()},
        "samplers": sampler_runs,
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
