#!/usr/bin/env python3
"""GroupNorm sites of vdx_torch's AnimateDiff workload, timed on one GPU.

    python3 scripts/bench_gn_torch.py [--sizes 512,768] [--kernels]
                                      [--root DIR] [--json FILE]

Traces every GroupNorm that one full-width UNet call (CFG batch 2 x 16
frames), one 8-frame VAE decode chunk and one 8-frame VAE encode chunk
(video2video) run at each size, on the meta device (shapes only), then
drives each distinct site on the card through
``ops.groupnorm`` (the dispatch the models call, K2 or K3 by the launch
plan) on seeded bf16 inputs, and prints per site and per path (the UNet
call, the decode chunk) the kernel ms, the bytes bound (x read once, y
written once, at 3.35 TB/s) and ``F.group_norm`` (+ ``F.silu``) on the
same [B, C, S] view, each summed over the site's count (a path: the UNet
call, the decode chunk, the encode chunk). ``--kernels``
also times K2 (``fused_group_norm``) and K3 (``fused_group_norm_2phase``)
on their own at every site each takes. ``--root DIR`` imports
``vdx_torch`` from DIR (another checkout, e.g. the parent commit's, so
two trees are timed by one script on one card). Times: CUDA events
around REPS back-to-back calls queued behind a ``torch.cuda._sleep``, so
the host's dispatch does not show; the median of three such runs.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
H100_BYTES_S = 3.35e12
REPS = 20
TRIALS = 3


def gn_sites(height: int, width: int, frames: int = 16, chunk: int = 8,
             videos: int = 1):
    """{"unet": Counter, "decode": Counter, "encode": Counter} of
    (B, S, C, G, eps, silu) over every GroupNorm of one UNet call (CFG
    batch 2 x ``videos``), one decode chunk and one encode chunk at
    height x width, traced on the meta device. (A checkout whose VAE has
    no encoder gives no "encode" path.)"""
    import torch

    from vdx_torch.models.unet_motion import UNetMotion, UNetMotionConfig
    from vdx_torch.models.vae import AutoencoderKL, VAEConfig
    from vdx_torch.nn.resnet import GroupNormModule

    sites = collections.defaultdict(collections.Counter)
    where = []

    def record(mod, args):
        x = args[0]
        sites[where[-1]][(x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1],
                          mod.num_groups, mod.eps, mod.with_silu)] += 1

    h, w = height // 8, width // 8
    with torch.device("meta"), torch.inference_mode():
        unet, vae = UNetMotion(UNetMotionConfig()), AutoencoderKL(VAEConfig())
        for net in (unet, vae):
            for m in net.modules():
                if isinstance(m, GroupNormModule):
                    m.register_forward_pre_hook(record)
        where.append("unet")
        unet(torch.empty(2 * videos, frames, h, w, 4), torch.empty(2 * videos),
             torch.empty(2 * videos, 77, 768))
        where.append("decode")
        vae.decode(torch.empty(chunk, h, w, 4))
        if hasattr(vae, "encode"):
            where.append("encode")
            vae.encode(torch.empty(chunk, height, width, 3))
    return dict(sites)


def gpu_ms(fn, reps: int = REPS, trials: int = TRIALS) -> float:
    """Device ms per call of ``fn()``: ``reps`` calls queued behind a
    sleep kernel between two CUDA events; the median of ``trials``."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000 * reps)  # ~0.1 ms a call to queue behind
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def family_gn_sites(family: str, height: int, width: int, frames: int,
                    chunk: int):
    """The same for the other families at full width, traced on the meta
    device: "modelscope" (one UNet3D call, CFG batch 2 x ``frames``; one
    SD VAE decode chunk of ``chunk`` frames) or "svd" (one
    UNetSpatioTemporal call; one temporal-decoder chunk of ``chunk``
    frames; the VAE encode of the one conditioning image)."""
    import torch

    from vdx_torch.models.vae import AutoencoderKL, TemporalDecoder, VAEConfig
    from vdx_torch.nn.resnet import GroupNormModule

    sites = collections.defaultdict(collections.Counter)
    where = []

    def record(mod, args):
        x = args[0]
        sites[where[-1]][(x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1],
                          mod.num_groups, mod.eps, mod.with_silu)] += 1

    h, w = height // 8, width // 8
    with torch.device("meta"), torch.inference_mode():
        vae = AutoencoderKL(VAEConfig())
        if family == "modelscope":
            from vdx_torch.models.unet3d import UNet3D, UNet3DConfig

            unet, nets = UNet3D(UNet3DConfig()), ()
        else:
            from vdx_torch.models.svd_unet import (SVDUNetConfig,
                                                   UNetSpatioTemporal)

            unet, nets = UNetSpatioTemporal(SVDUNetConfig()), \
                (TemporalDecoder(VAEConfig()),)
        for net in (unet, vae) + nets:
            for m in net.modules():
                if isinstance(m, GroupNormModule):
                    m.register_forward_pre_hook(record)
        where.append("unet")
        if family == "modelscope":
            unet(torch.empty(2, frames, h, w, 4), torch.empty(2),
                 torch.empty(2, 77, 1024))
            where.append("decode")
            vae.decode(torch.empty(chunk, h, w, 4))
        else:
            unet(torch.empty(2, frames, h, w, 8), torch.empty(2),
                 torch.empty(2, 1, 1024), torch.empty(2, 3))
            where.append("decode")
            nets[0](torch.empty(chunk, h, w, 4), chunk)
            where.append("encode")
            vae.encode_moments(torch.empty(1, height, width, 3))
    return dict(sites)


def site_inputs(site, dev, seed: int = 0):
    import torch

    B, S, C, G, eps, silu = site
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((B, S, C), generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev)
    bias = 0.1 * torch.randn(C, generator=gen, device=dev)
    return x, scale, bias


def read_counts() -> dict:
    from vdx_torch.kernels.groupnorm import (fused_group_norm,
                                             fused_group_norm_2phase)

    return {"K2": fused_group_norm.launches, "K3": fused_group_norm_2phase.launches}


def drive(sites, dev) -> dict:
    """Every site of ``sites`` (a Counter) through ops.groupnorm, each as
    often as the path runs it, with the GN counters reset just before.
    -> launches by counter."""
    import torch

    from vdx_torch.kernels.groupnorm import (fused_group_norm,
                                             fused_group_norm_2phase)
    from vdx_torch.ops.groupnorm import group_norm, group_norm_silu

    inputs = {s: site_inputs(s, dev) for s in sites}
    torch.cuda.synchronize()
    fused_group_norm.launches = fused_group_norm_2phase.launches = 0
    for site, n in sites.items():
        x, scale, bias = inputs[site]
        fn = group_norm_silu if site[5] else group_norm
        for _ in range(n):
            fn(x, site[3], scale, bias, site[4])
    launches = read_counts()
    torch.cuda.synchronize()
    return launches


def time_sites(sites, dev, kernels: bool = False) -> list:
    """One row per distinct site: its count, the route the dispatch took,
    kernel / bound / library ms (and K2's and K3's own with ``kernels``)."""
    import torch
    import torch.nn.functional as F

    from vdx_torch.kernels import groupnorm as KG
    from vdx_torch.ops.groupnorm import group_norm, group_norm_silu

    rows = []
    for site, n in sorted(sites.items()):
        B, S, C, G, eps, silu = site
        x, scale, bias = site_inputs(site, dev)
        op = group_norm_silu if silu else group_norm
        before = read_counts()
        op(x, G, scale, bias, eps)
        route = [k for k, c in read_counts().items() if c != before[k]]
        xt = x.view(B, S, C).transpose(1, 2)
        sc16, b16 = scale.to(x.dtype), bias.to(x.dtype)

        def library():
            y = F.group_norm(xt, G, sc16, b16, eps)
            return F.silu(y) if silu else y

        row = dict(site=[B, S, C, G], eps=eps, silu=silu, count=n,
                   route=route[0] if len(route) == 1 else route,
                   ms=gpu_ms(lambda: op(x, G, scale, bias, eps)),
                   bound_ms=2 * x.numel() * x.element_size() / H100_BYTES_S * 1e3,
                   library_ms=gpu_ms(library, reps=4))
        if kernels:
            kw = dict(num_groups=G, eps=eps, with_silu=silu)
            for name, fn in (("k2_ms", KG.fused_group_norm),
                             ("k3_ms", KG.fused_group_norm_2phase)):
                try:
                    fn(x, scale, bias, **kw)
                except ValueError:  # the kernel does not take the site
                    row[name] = None
                    continue
                row[name] = gpu_ms(lambda: fn(x, scale, bias, **kw))
        rows.append(row)
        del x, xt
        torch.cuda.empty_cache()
    return rows


def path_sums(rows) -> dict:
    out = {k: sum(r["count"] * r[k] for r in rows)
           for k in ("ms", "bound_ms", "library_ms")}
    for k in ("k2_ms", "k3_ms"):
        if rows and k in rows[0]:
            # each site on the kernel that takes it, else the dispatch's
            out[k] = sum(r["count"] * (r[k] if r[k] is not None else r["ms"])
                         for r in rows)
    out["sites"] = sum(r["count"] for r in rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="512,768")
    ap.add_argument("--kernels", action="store_true",
                    help="also time K2 and K3 on their own at each site")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose vdx_torch is timed")
    ap.add_argument("--json", default=None, help="write the rows here too")
    a = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(a.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: bench_gn_torch.py times the card")
    import vdx_torch

    dev = torch.device("cuda", 0)
    print(f"device={torch.cuda.get_device_name(0)} "
          f"vdx_torch={pathlib.Path(vdx_torch.__file__).parent}", flush=True)
    out = {}
    for size in (int(s) for s in a.sizes.split(",")):
        for path, sites in gn_sites(size, size).items():
            launches = drive(sites, dev)
            rows = time_sites(sites, dev, a.kernels)
            sums = path_sums(rows)
            for r in rows:
                extra = "".join(
                    f" {k}={r[k]:.4f}" if r[k] is not None else f" {k}=n/a"
                    for k in ("k2_ms", "k3_ms") if k in r)
                print(f"[site] {path} {size} {r['site']} x{r['count']} "
                      f"{r['route']} ms={r['ms']:.4f} "
                      f"bound_ms={r['bound_ms']:.4f} "
                      f"library_ms={r['library_ms']:.4f}{extra}", flush=True)
            print(f"[gn] {path} {size}: {sums['sites']} sites, launches "
                  f"{launches}, kernel_ms={sums['ms']:.4f} "
                  f"bound_ms={sums['bound_ms']:.4f} "
                  f"library_ms={sums['library_ms']:.4f}"
                  + "".join(f" {k}={sums[k]:.4f}" for k in ("k2_ms", "k3_ms")
                            if k in sums), flush=True)
            out[f"{path}{size}"] = dict(sums=sums, launches=launches, rows=rows)
    if a.json:
        pathlib.Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.json).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
