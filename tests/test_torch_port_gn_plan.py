"""The Hopper GroupNorm kernels' launch plan and summation order, on the CPU.

* The launch plan (``kernels.groupnorm.gn_plan``: route, stripe, cluster,
  rows a CTA, shared bytes) at every GroupNorm site of the SD-1.5
  AnimateDiff UNet, VAE decoder and VAE encoder at 512x512, 768x768,
  1024x576 and 1024x1024, and of the ModelScope UNet3D (256x256, 16
  frames) and the SVD UNet, temporal decoder and encoder (576x1024, 25
  frames, 5-frame decode chunks), in bf16 and fp32: stripes are whole groups on 16-byte
  boundaries, the shared bytes fit 227 KB, the cluster is within its
  limit, and the 512 and 768 paths route as ``chip_smoke.py`` checks on
  the card (STREAMED below).
* A plain emulation of each kernel's partition and summation order
  (K2: per-CTA row chunks, per-thread stripe partials, the warp's
  xor-shuffle tree, warps then cluster ranks in order; K3: per-thread
  chunk sums, row groups then channels in order, chunks in order) at
  small shapes against vdx's Pallas K2/K3 in interpret mode, and at the
  main path's partitions (the widest stripe on the largest cluster)
  against the plain version.

Inputs come from numpy with a seed. Tolerance: fp32 2e-5 absolute (the
same arithmetic summed in another order), bf16 one bf16 ulp at the
largest magnitude (both round once from fp32).
"""

import math

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_ops import _gn_sites
from vdx.kernels.groupnorm import fused_group_norm as jax_k2
from vdx.kernels.groupnorm import fused_group_norm_2phase as jax_k3
from vdx_torch.kernels import groupnorm as KG

BF16, FP32 = 2, 4


def _k2_emulated(x, scale, bias, G, eps, silu, plan):
    """K2's arithmetic in its order (csrc/groupnorm.cu, gn_cluster_kernel)
    for ``plan``: fp32 on the CPU, cast to x's dtype once."""
    B, S, C = x.shape
    cpg, st = C // G, plan.stripe_channels
    gps, nst = st // cpg, C // st
    epv = 16 // x.element_size()
    vpr = st // epv
    T, n, R = plan.threads, plan.cluster, plan.rows_per_cta
    RY = T // vpr
    xs = x.float().reshape(B, S, nst, st).permute(0, 2, 1, 3)  # [B, nst, S, st]
    tot = torch.zeros(2, B, nst, gps)
    for rank in range(n):
        r0 = rank * R
        nr = max(0, min(S - r0, R))
        iters = -(-nr // RY)
        rows = torch.zeros(B, nst, iters * RY, st)
        rows[:, :, :nr] = xs[:, :, r0:r0 + nr]
        rows = rows.reshape(B, nst, iters, RY, vpr, epv)
        s = torch.zeros(2, B, nst, RY, vpr, epv)
        for k in range(iters):  # each thread's rows in row order
            v = rows[:, :, k]
            s = s + torch.stack([v, v * v])
        g = torch.zeros(2, B, nst, RY, vpr, gps)
        for col in range(vpr):  # the thread's elements in channel order
            for j in range(epv):
                gi = (col * epv + j) // cpg
                g[..., col, gi] = g[..., col, gi] + s[..., col, j]
        g = g.reshape(2, B, nst, T // 32, 32, gps)  # thread t = ry * vpr + col
        lanes = torch.arange(32)
        for off in (16, 8, 4, 2, 1):  # the warp's xor-shuffle tree
            g = g + g[..., lanes ^ off, :]
        part = torch.zeros(2, B, nst, gps)
        for w in range(T // 32):  # the warps in order
            part = part + g[:, :, :, w, 0]
        tot = tot + part  # the ranks in order
    return _normalise(x, scale, bias, G, eps, silu,
                      tot.reshape(2, B, G), S * cpg)


def _k3_emulated(x, scale, bias, G, eps, silu, plan):
    """K3's arithmetic in its order (gn_stream_stats_kernel, then
    gn_stream_apply_kernel's prologue) for ``plan``."""
    B, S, C = x.shape
    cpg = C // G
    RY = KG.K3_THREADS // min(C // 8, KG.K3_THREADS)
    rows = plan.rows_per_chunk
    xf = x.float()
    tot = torch.zeros(2, B, G)
    for k in range(plan.n_chunks):  # the chunks in order
        r0, r1 = k * rows, min(S, (k + 1) * rows)
        iters = -(-(r1 - r0) // RY)
        d = torch.zeros(B, iters * RY, C)
        d[:, :r1 - r0] = xf[:, r0:r1]
        d = d.reshape(B, iters, RY, C)
        s = torch.zeros(2, B, RY, C)
        for it in range(iters):  # each thread's rows in row order
            v = d[:, it]
            s = s + torch.stack([v, v * v])
        s = s.reshape(2, B, RY, G, cpg)
        acc = torch.zeros(2, B, G)
        for q in range(RY):  # row groups, then the group's channels
            for c in range(cpg):
                acc = acc + s[:, :, q, :, c]
        tot = tot + acc
    return _normalise(x, scale, bias, G, eps, silu, tot, S * cpg)


def _normalise(x, scale, bias, G, eps, silu, tot, count):
    B, S, C = x.shape
    cnt = torch.tensor(float(count), dtype=torch.float32)
    mean = tot[0] / cnt
    var = torch.clamp_min(tot[1] / cnt - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)  # [B, G]
    sc = scale.float().reshape(1, G, C // G) * inv[:, :, None]
    off = bias.float().reshape(1, G, C // G) - mean[:, :, None] * sc
    y = x.float() * sc.reshape(B, 1, C) + off.reshape(B, 1, C)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _inputs(B, S, C, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, C)).astype(np.float32) + 0.5
    scale = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    return tx, torch.from_numpy(scale), torch.from_numpy(bias)


def _tol(want, dtype):
    if dtype == torch.float32:
        return 2e-5
    return 2.0 ** -7 * max(1.0, float(np.abs(want).max()))


def _check_plan(B, S, C, G, itemsize):
    plan = KG.gn_plan(B, S, C, G, itemsize)
    assert plan is not None, (B, S, C, G, itemsize)
    cpg = C // G
    k2 = KG.k2_plan(S, C, G, itemsize)
    # the dispatch takes K2 exactly where two of its CTAs fit an SM
    assert (plan.route == "K2") == (k2 is not None and k2.pair)
    if k2 is not None:
        st = k2.stripe_channels
        assert st == k2.groups_per_stripe * cpg and C % st == 0
        assert st * itemsize % 16 == 0  # every stripe starts on 16 bytes
        assert k2.smem_bytes + KG.K2_STATIC_SMEM <= KG.SMEM_MAX == 232448
        assert 1 <= k2.cluster <= KG.K2_MAX_CLUSTER == 16
        R = k2.rows_per_cta
        assert (k2.cluster - 1) * R < S <= k2.cluster * R  # no empty rank
        vpr = st * itemsize // 16
        assert k2.threads % 32 == 0 and k2.threads % vpr == 0
        assert k2.threads <= KG.K2_MAX_THREADS
        assert k2.box_rows % 8 == 0 and 8 <= k2.box_rows <= 256
        assert -(-R // k2.box_rows) <= KG.K2_MAX_BOXES
    if plan.route == "K3":
        assert plan.smem_bytes <= 48 * 1024
        rows = plan.rows_per_chunk
        assert (plan.n_chunks - 1) * rows < S <= plan.n_chunks * rows
        assert plan.n_chunks <= KG.K3_MAX_CHUNKS
    return plan


# The sites the plan streams (K3) on the 512 and 768 paths, in bf16 and
# fp32; every other site goes to K2. The motion-module GN of levels 0 and
# 1 ([2, 16 * hw, 320], [2, 4 * hw, 640]) and the VAE GN but its first
# ([8, hw, 512] at 512) hold no stripe with two CTAs an SM, nor does the
# 768 up-block-3 resnet GN's 960 channels (a 2.2 MB stripe: 16 CTAs, one
# an SM), where K3 measured faster on an H100. The VAE encoder's GN sites
# above the lowest level stream too ([8, 4 * hw, 128] and [8, hw, 256] are
# the encoder's own shapes).
STREAMED = {
    512: {(2, 65536, 320), (2, 16384, 640), (8, 16384, 512), (8, 65536, 256),
          (8, 65536, 512), (8, 262144, 128), (8, 262144, 256),
          (8, 16384, 256), (8, 65536, 128)},
    768: {(2, 147456, 320), (2, 36864, 640), (32, 9216, 960), (8, 9216, 512),
          (8, 36864, 512), (8, 147456, 256), (8, 147456, 512),
          (8, 589824, 128), (8, 589824, 256), (8, 36864, 256),
          (8, 147456, 128)},
}


def _family_sites() -> dict:
    """{(family, path): Counter of (B, S, C, G, eps, silu)} traced on the
    meta device by scripts/bench_gn_torch.py (what chip_smoke.py checks
    the launches against)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "bench_gn_torch.py"
    spec = importlib.util.spec_from_file_location("bench_gn_torch", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    out = {}
    for family, args in (("modelscope", (256, 256, 16, 8)),
                         ("svd", (576, 1024, 25, 5))):
        for p, sites in bench.family_gn_sites(family, *args).items():
            out[(family, p)] = sites
    return out


def test_launch_plan_at_every_site():
    sizes = ((512, 512), (768, 768), (576, 1024), (1024, 1024))
    n_sites = 0
    for (height, width), sites in _gn_sites(sizes).items():
        n_sites += len(sites)
        for B, S, C, G in sites:
            for itemsize in (BF16, FP32):
                plan = _check_plan(B, S, C, G, itemsize)
                if height == width and height in STREAMED:
                    want = "K3" if (B, S, C) in STREAMED[height] else "K2"
                    assert plan.route == want, (height, B, S, C, itemsize)
        if height == width and height in STREAMED:
            assert STREAMED[height] <= {s[:3] for s in sites}
    assert n_sites > 60
    # the other families at full width (chip_smoke.py phases 23-24): the
    # UNet3D call and SD VAE decode chunk at ModelScope's 16 x 256x256, the
    # SVD UNet call (its frame-spanning tnorms over 25 frames), the
    # temporal decoder's 5-frame chunk and the conditioning image's
    # encode at 576x1024
    family = _family_sites()
    for path, sites in family.items():
        for B, S, C, G, _, _ in sites:
            for itemsize in (BF16, FP32):
                _check_plan(B, S, C, G, itemsize)
    assert (2, 16 * 1024, 320, 32) in {s[:4] for s in family[("modelscope", "unet")]}
    assert (1, 5 * 576 * 1024, 128, 32) in {s[:4] for s in family[("svd", "decode")]}
    assert sum(len(v) for v in family.values()) > 60
    # the widest stripe (4 groups of 30 channels) needs 16 CTAs at 768
    wide = KG.k2_plan(9216, 960, 32, BF16)
    assert (wide.cluster, wide.stripe_channels, wide.pair) == (16, 120, False)
    # what neither kernel takes raises in the dispatch (the CUDA tests
    # check the raise): C % 8, C > 4096, G > 128
    for B, S, C, G in ((1, 70000, 100, 4), (1, 70000, 4104, 8),
                       (2, 4096, 2048, 256)):
        for itemsize in (BF16, FP32):
            assert KG.gn_plan(B, S, C, G, itemsize) is None


# (B, S, C): cpg = 10, 30, 60 and C = 2560 at G = 32, on K2 clusters of
# 2-4 CTAs; S not a multiple of a CTA's rows, and a multiple of 8 (vdx's
# K3 tiles S in 8-row chunks); the first case's K3 chunks are ragged too
ORDER_CASES = [(2, 2664, 320), (1, 1000, 960), (2, 1000, 1920),
               (2, 1000, 2560)]


def test_emulated_summation_order_matches_pallas():
    for i, (B, S, C) in enumerate(ORDER_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            x, scale, bias = _inputs(B, S, C, dtype, seed=10 + i)
            silu, eps = i % 2 == 0, (1e-5, 1e-6)[i % 2]
            kw = dict(num_groups=32, eps=eps, with_silu=silu)
            jx = jnp.asarray(x.float().numpy()).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
            with pltpu.force_tpu_interpret_mode():
                want2, want3 = (np.asarray(fn(jx, jnp.asarray(scale.numpy()),
                                              jnp.asarray(bias.numpy()), **kw)
                                           .astype(jnp.float32))
                                for fn in (jax_k2, jax_k3))
            isz = x.element_size()
            plan = KG.k2_plan(S, C, 32, isz)
            assert plan.cluster > 1 and plan.pair, plan
            assert S % plan.rows_per_cta  # a ragged last rank
            got = _k2_emulated(x, scale, bias, 32, eps, silu, plan)
            np.testing.assert_allclose(got.float().numpy(), want2,
                                       atol=_tol(want2, dtype))
            plan = KG.k3_plan(B, S, C, 32, isz)
            got = _k3_emulated(x, scale, bias, 32, eps, silu, plan)
            np.testing.assert_allclose(got.float().numpy(), want3,
                                       atol=_tol(want3, dtype))
    # the ragged last chunk is exercised
    plan = KG.k3_plan(2, 2664, 320, 32, BF16)
    assert 2664 % plan.rows_per_chunk


def test_emulation_at_main_path_partitions():
    """The widest 16-CTA stripe (4 groups of 30 channels, 240 bytes, 576
    rows a CTA) that K2 takes when called, the 512 level-0 resnet GN's
    8 x 512 rows of 8-group stripes, and K3 at the 2560-channel column
    passes, one sample each, against the plain version."""
    cases = [("K2", 9216, 960, 16), ("K2", 4096, 320, 8), ("K3", 1024, 2560, 0)]
    for route, S, C, n in cases:
        x, scale, bias = _inputs(1, S, C, torch.bfloat16, seed=S)
        plan = (KG.k2_plan(S, C, 32, BF16) if route == "K2"
                else KG.k3_plan(32, S, C, 32, BF16))
        if route == "K2":
            assert plan.cluster == n and plan.rows_per_cta * n >= S
            got = _k2_emulated(x, scale, bias, 32, 1e-5, True, plan)
        else:
            got = _k3_emulated(x, scale, bias, 32, 1e-5, True, plan)
        want = KG.group_norm_moments_plain(x, scale, bias, num_groups=32,
                                           eps=1e-5, with_silu=True)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _tol(want.float().numpy(), torch.bfloat16), (route, S, C, err)
        assert math.isfinite(err)
