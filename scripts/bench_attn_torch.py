#!/usr/bin/env python
"""Attention micro-benchmark of vdx_torch, the PyTorch/CUDA port: the port
of vdx's scripts/bench_attention.py and scripts/bench_attn_shapes.py.

Each spec runs vdx's chained loop, c = (c + 0.01 * attention(c, k, v))
in c's dtype, K times, and prints the milliseconds per attention as the
best of two runs on fresh seeded inputs (CUDA events around the loop),
after a first run on its own inputs.

Usage:
    python scripts/bench_attn_torch.py [B,S,H,D[,Skv]] [spec ...] \\
        [--iters K] [--device cuda|cpu]

The shape defaults to the UNet's level-0 self-attention at 512x512,
[32, 4096, 8, 40]; the spec to dt:1024:1024. Specs:
  xla                  exact fp32 softmax (ops.attention ``xla``)
  bf16p                fp32 statistics, probs in bf16 (``xla_bf16p``)
  bf16ps               the max-free static softmax, probs in bf16
  packed               ``xla_bf16p_packed`` (128 // S rows per block)
  dt:BQ:BK[:exp_impl]  kernels.flash_attention.flash_attention_dt with
                       those blocks and form (default exp, vdx's default)
  k4                   kernels.flash_attention.flash_attention (K4, the
                       UNet's route at 768x768 level 2)
The inputs are bf16 standard normals, as vdx's. It runs on the card;
``--device cpu`` runs the same loop on the CPU at a small shape, for the
tests (its times are CPU times).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

DEFAULT_SHAPE = (32, 4096, 8, 40)
DEFAULT_SPEC = "dt:1024:1024"
ITERS = 16


def make_fn(spec: str, scale: float):
    """spec -> f(q, k, v) over [B, S, H, D] tensors."""
    from vdx_torch.kernels.flash_attention import (flash_attention,
                                                   flash_attention_dt)
    from vdx_torch.ops import attention as A

    eager = {
        "xla": lambda q, k, v: A._xla_attention(q, k, v, scale, None),
        "bf16p": lambda q, k, v: A._xla_attention_bf16probs(q, k, v, scale),
        "bf16ps": lambda q, k, v: A._xla_attention_bf16probs_static(
            q, k, v, scale),
        "packed": lambda q, k, v: A.dot_product_attention(
            q, k, v, scale=scale, impl="xla_bf16p_packed"),
    }
    if spec in eager:
        return eager[spec]
    if spec == "k4":
        return lambda q, k, v: flash_attention(q, k, v, scale=scale)
    parts = spec.split(":")
    if parts[0] != "dt" or len(parts) not in (3, 4):
        raise ValueError(f"unknown spec {spec!r}: xla, bf16p, bf16ps, packed, "
                         "k4 or dt:BQ:BK[:exp_impl]")
    bq, bk = int(parts[1]), int(parts[2])
    exp_impl = parts[3] if len(parts) == 4 else "exp"
    return lambda q, k, v: flash_attention_dt(
        q, k, v, scale=scale, block_q=bq, block_k=bk, exp_impl=exp_impl)


def chain(fn, q, k, v, iters: int = ITERS):
    """vdx's loop: K attentions, each feeding the next query."""
    c = q
    for _ in range(iters):
        c = (c + 0.01 * fn(c, k, v)).to(c.dtype)
    return c


def fresh(shape, skv: int, seed: int, device, dtype):
    """Seeded standard-normal q [B, S, H, D], k and v [B, Skv, H, D]."""
    B, S, H, D = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(sh, generator=gen, device=device).to(dtype)
                 for sh in ((B, S, H, D), (B, skv, H, D), (B, skv, H, D)))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_spec(spec: str, shape, skv: int, iters: int, device) -> dict:
    """One spec: a first run, then the best of two on fresh inputs (seeds
    0, 1, 2). -> {"spec", "ms" (per attention), "first_s", "finite",
    "peak_gib" (the card's peak allocation over the three runs; None on
    the CPU)}"""
    fn = make_fn(spec, shape[3] ** -0.5)
    q, k, v = fresh(shape, skv, 0, device, torch.bfloat16)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = chain(fn, q, k, v, iters)
    _sync(device)
    first_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(out).all())
    times = []
    for i in (1, 2):
        q, k, v = fresh(shape, skv, i, device, torch.bfloat16)
        _sync(device)
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            chain(fn, q, k, v, iters)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            chain(fn, q, k, v, iters)
            times.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    return {"spec": spec, "ms": min(times) / iters, "first_s": first_s,
            "finite": finite, "peak_gib": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="[B,S,H,D[,Skv]] then specs")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    rest = list(a.args)
    dims = ([int(x) for x in rest.pop(0).split(",")]
            if rest and "," in rest[0] else list(DEFAULT_SHAPE))
    shape, skv = tuple(dims[:4]), dims[4] if len(dims) > 4 else dims[1]
    specs = rest or [DEFAULT_SPEC]
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass --device cpu")
    device = torch.device(a.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"device={where} shape={list(shape)} Skv={skv} dtype=bf16 "
          f"K={a.iters}", flush=True)
    for spec in specs:
        r = time_spec(spec, shape, skv, a.iters, device)
        peak = ("" if r["peak_gib"] is None
                else f", peak {r['peak_gib']:.2f} GiB allocated")
        print(f"[{spec}] {r['ms']:.4f} ms/attention (K={a.iters}, best of 2; "
              f"first run {r['first_s']:.2f} s, finite={r['finite']}{peak})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
