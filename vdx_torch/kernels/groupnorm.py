"""K2 and K3 — fused GroupNorm(+SiLU) (CUDA, ``csrc/groupnorm.cu``).

Port of vdx/kernels/groupnorm.py: ``fused_group_norm`` (K2, one program
per sample) and ``fused_group_norm_2phase`` (K3, moments over row chunks,
then a chunked normalise). Both take a channels-last [B, S, C] tensor
(S folds every non-batch axis) and compute, per (sample, group), fp32
moments var = E[x^2] - mean^2, rsqrt(var + eps), the affine and an
optional SiLU.

On Hopper the two are redesigned around what crosses device memory:

* K2 is a one-pass cluster kernel. A *stripe* is the fewest whole groups
  whose channels fill a multiple of 16 bytes; one thread-block cluster
  holds one sample's stripe in shared memory (TMA loads, partial moments
  exchanged through distributed shared memory in rank order), so x is
  read once, in one launch.
* K3 is a streaming kernel for stripes that no cluster holds: partial
  moments per row chunk, then a normalise whose prologue reduces them in
  chunk order. Two launches; x is read twice.

:func:`gn_plan` is the launch plan of both, pure Python, so the CPU tests
check it at every GroupNorm site of the model. The dispatch
(:func:`group_norm_silu_cuda`) takes K2 where a plan for it exists, else
K3; a shape neither takes raises.

Each wrapper launches its kernel for a CUDA tensor and raises on anything
the kernel does not take; for a CPU tensor it computes
:func:`group_norm_moments_plain`, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernels against.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from vdx_torch.kernels import _lib

SM_COUNT = 132  # H100 SXM
SMEM_MAX = 232448  # bytes of shared memory a block may use (227 KB)
# An SM has 228 KB of shared memory and reserves 1 KB a CTA: two K2 CTAs
# fit where each takes at most this much (dynamic and static).
SMEM_PAIR = 228 * 1024 // 2 - 1024
# K2's static shared memory: 32 mbarriers, the warps' partial moments
# [16][16], the rank's partials and the totals (csrc/groupnorm.cu)
K2_STATIC_SMEM = 32 * 8 + 16 * 16 * 4 + 2 * 16 * 4
K2_MAX_STRIPE_CHANNELS = 256  # a TMA box dimension's limit
K2_MAX_BOXES = 32
K2_MAX_CLUSTER = 16  # above 8: a non-portable cluster size
K2_MAX_THREADS = 512
# A stripe is the fewest whole groups whose channels fill a multiple of 16
# bytes and at least K2_STRIPE_BYTES a row (up to 8 groups and 256
# channels): on an H100, 160-byte rows ran faster than 80-byte ones.
K2_STRIPE_BYTES = 160
# What either kernel takes: C % 8 == 0 (16-byte rows), C <= 4096 (K3: 8
# channels a thread in column passes of 256 threads), G <= 128
MAX_CHANNELS = 4096
MAX_GROUPS = 128
K3_THREADS = 256
# K3 row chunks: K3_TARGET_BLOCKS (chunk, sample) blocks, at most
# K3_MAX_CHUNKS a sample (each apply CTA reduces all its sample's chunks)
K3_TARGET_BLOCKS = 4 * SM_COUNT
K3_MAX_CHUNKS = SM_COUNT


@dataclass(frozen=True)
class GNPlan:
    """One GroupNorm launch. ``route`` "K2" (one-pass cluster) or "K3"
    (streaming); ``threads`` a CTA; ``smem_bytes`` its dynamic shared
    memory. K2: ``stripe_channels`` (``groups_per_stripe`` whole groups),
    ``cluster`` CTAs a stripe, ``rows_per_cta`` (the last rank takes the
    rest), TMA boxes of ``box_rows`` rows. K3: ``rows_per_chunk`` rows a
    (chunk, sample) block, ``n_chunks`` of them a sample."""
    route: str
    threads: int
    smem_bytes: int
    stripe_channels: int = 0
    groups_per_stripe: int = 0
    cluster: int = 0
    rows_per_cta: int = 0
    box_rows: int = 0
    rows_per_chunk: int = 0
    n_chunks: int = 0

    @property
    def pair(self) -> bool:
        """Two K2 CTAs fit an SM, so one's stores overlap another's loads."""
        return _pair(self.smem_bytes)


def _pair(smem: int) -> bool:
    return smem + K2_STATIC_SMEM <= SMEM_PAIR


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _k2_geometry(S: int, row_bytes: int, n: int):
    """(rows a CTA, box rows, dynamic shared bytes) for a cluster of n
    CTAs over S rows of ``row_bytes``, or None when a rank would be empty
    or the boxes do not fit."""
    rows = _cdiv(_cdiv(S, n), 8) * 8
    if (n - 1) * rows >= S:
        return None
    n_box = _cdiv(rows, 256)
    box_rows = _cdiv(_cdiv(rows, n_box), 8) * 8
    smem = 128 + _cdiv(rows, box_rows) * box_rows * row_bytes  # 128: alignment
    if _cdiv(rows, box_rows) > K2_MAX_BOXES \
            or smem + K2_STATIC_SMEM > SMEM_MAX:
        return None
    return rows, box_rows, smem


def _k2_threads(row_bytes: int) -> int:
    """A multiple of the warp and of the 16-byte vectors a row, >= 256."""
    threads = math.lcm(row_bytes // 16, 32)
    while threads < 256:
        threads *= 2
    return threads


@functools.lru_cache(maxsize=None)
def k2_plan(S: int, C: int, G: int, itemsize: int) -> GNPlan | None:
    """K2's launch plan for [B, S, C] (one cluster per stripe and sample,
    whatever B), or None where no cluster of up to K2_MAX_CLUSTER CTAs
    holds a stripe (or C % 8, C > MAX_CHANNELS, G > MAX_GROUPS). Stripes
    of 1, 2, 4 or 8 groups (the kernel's limit). The cluster is the
    smallest power of two whose CTAs' rows fit two CTAs an SM
    (``GNPlan.pair``), else one; a one-CTA stripe that would leave room
    for twice its rows is widened to twice the groups (fewer, fuller
    CTAs)."""
    if C % G or C % 8 or C > MAX_CHANNELS or G > MAX_GROUPS:
        return None
    cpg = C // G
    widths = [k for k in (1, 2, 4, 8)
              if G % k == 0 and k * cpg * itemsize % 16 == 0
              and k * cpg <= K2_MAX_STRIPE_CHANNELS
              and _k2_threads(k * cpg * itemsize) <= K2_MAX_THREADS]
    if not widths:
        return None
    i = next((j for j, k in enumerate(widths)
              if k * cpg * itemsize >= K2_STRIPE_BYTES), len(widths) - 1)
    geos = [(m, _k2_geometry(S, widths[i] * cpg * itemsize, m))
            for m in (1, 2, 4, 8, 16)]
    geos = [(m, g) for m, g in geos if g is not None]
    if not geos:
        return None
    n, geo = next(((m, g) for m, g in geos if _pair(g[2])), geos[0])
    while n == 1 and i + 1 < len(widths):
        wider = _k2_geometry(S, widths[i + 1] * cpg * itemsize, 1)
        if wider is None or not _pair(wider[2]):
            break
        i, geo = i + 1, wider
    gps = widths[i]
    rows, box_rows, smem = geo
    return GNPlan("K2", _k2_threads(gps * cpg * itemsize), smem,
                  stripe_channels=gps * cpg, groups_per_stripe=gps,
                  cluster=n, rows_per_cta=rows, box_rows=box_rows)


@functools.lru_cache(maxsize=None)
def k3_plan(B: int, S: int, C: int, G: int, itemsize: int) -> GNPlan | None:
    """K3's launch plan, or None where C % 8, C > MAX_CHANNELS or
    G > MAX_GROUPS. Row chunks: K3_TARGET_BLOCKS (chunk, sample) blocks
    over the batch, at most K3_MAX_CHUNKS a sample."""
    del itemsize
    if C % G or C % 8 or C > MAX_CHANNELS or G > MAX_GROUPS:
        return None
    n_chunks = max(1, min(S, K3_MAX_CHUNKS, _cdiv(K3_TARGET_BLOCKS, B)))
    rows = _cdiv(S, n_chunks)
    tn = min(C // 8, K3_THREADS)
    return GNPlan("K3", K3_THREADS, 2 * 4 * (K3_THREADS // tn) * C,
                  rows_per_chunk=rows, n_chunks=_cdiv(S, rows))


def gn_plan(B: int, S: int, C: int, G: int, itemsize: int) -> GNPlan | None:
    """The dispatch's plan: K2 where a cluster holds a stripe with two CTAs
    an SM, else K3; None where neither kernel takes the shape. (Where a
    stripe needs one CTA an SM, the 768 path's 960-channel up-block GN,
    a 2.2 MB stripe on 16 CTAs, K3 measured faster on an H100.)"""
    plan = k2_plan(S, C, G, itemsize)
    if plan is not None and plan.pair:
        return plan
    return k3_plan(B, S, C, G, itemsize)


def k2_viable(S: int, C: int, G: int, itemsize: int) -> bool:
    """The dispatch sends [B, S, C] to K2 (whatever B)."""
    plan = k2_plan(S, C, G, itemsize)
    return plan is not None and plan.pair


def k3_viable(S: int, C: int, G: int, itemsize: int) -> bool:
    """K3 takes [B, S, C]."""
    return k3_plan(1, S, C, G, itemsize) is not None


def group_norm_moments_plain(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, *, num_groups: int,
                             eps: float, with_silu: bool) -> torch.Tensor:
    """Plain PyTorch version of K2/K3 on [B, S, C]: fp32 moments
    (E[x^2] - mean^2), affine, optional SiLU, cast back to x's dtype."""
    B, S, C = x.shape
    G = num_groups
    xg = x.float().reshape(B, S, G, C // G)
    n = S * (C // G)
    mean = xg.sum(dim=(1, 3)) / n  # [B, G]
    var = torch.clamp_min((xg * xg).sum(dim=(1, 3)) / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    sc = scale.float().reshape(1, G, C // G) * inv[:, :, None]  # [B, G, cpg]
    off = bias.float().reshape(1, G, C // G) - mean[:, :, None] * sc
    y = xg * sc[:, None] + off[:, None]
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.reshape(B, S, C).to(x.dtype)


def _check(x, scale, bias, num_groups):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"GN kernels take fp32 or bf16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"GN kernels take a contiguous [B, S, C], got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, S, C = x.shape
    if C % num_groups:
        raise ValueError(f"C={C} not divisible by {num_groups} groups")
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError("scale/bias must be [C]")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale/bias must be on x's device")
    if x.data_ptr() % 16:
        raise ValueError("GN kernels need a 16-byte aligned x")
    return B, S, C


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, num_groups: int, eps: float = 1e-5,
                     with_silu: bool = False) -> torch.Tensor:
    """K2: [B, S, C] GroupNorm(+SiLU) in one pass, one thread-block
    cluster per (stripe, sample) holding the stripe in shared memory."""
    if x.device.type == "cpu":
        return group_norm_moments_plain(x, scale, bias, num_groups=num_groups,
                                        eps=eps, with_silu=with_silu)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, got {x.device}")
    B, S, C = _check(x, scale, bias, num_groups)
    plan = k2_plan(S, C, num_groups, x.element_size())
    if plan is None:
        raise ValueError(f"K2: no cluster holds a stripe of [B={B}, S={S}, "
                         f"C={C}], G={num_groups} in {x.dtype}")
    y = torch.empty_like(x)
    gamma, beta = scale.float(), bias.float()  # held until the launch
    fn = (_lib.lib().vdx_group_norm_cluster_bf16 if x.dtype == torch.bfloat16
          else _lib.lib().vdx_group_norm_cluster_f32)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
             B, S, C, num_groups, plan.stripe_channels, plan.cluster,
             plan.rows_per_cta, plan.box_rows, plan.threads, float(eps),
             int(with_silu), _lib.stream_ptr(x.device))
    _lib.check(err, "K2 fused_group_norm")
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0


def fused_group_norm_2phase(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, *, num_groups: int,
                            eps: float = 1e-5,
                            with_silu: bool = False) -> torch.Tensor:
    """K3: [B, S, C] GroupNorm(+SiLU) in two passes over x: per-chunk
    moments, then a chunked normalise that reduces them first. One
    wrapper call = two launches; the counter counts wrapper calls."""
    if x.device.type == "cpu":
        return group_norm_moments_plain(x, scale, bias, num_groups=num_groups,
                                        eps=eps, with_silu=with_silu)
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda or cpu tensors, got {x.device}")
    B, S, C = _check(x, scale, bias, num_groups)
    plan = k3_plan(B, S, C, num_groups, x.element_size())
    if plan is None:
        raise ValueError(f"K3 takes C % 8 == 0, C <= {MAX_CHANNELS}, "
                         f"G <= {MAX_GROUPS}; got C={C}, G={num_groups}")
    work = torch.empty(B * plan.n_chunks * 2 * num_groups, dtype=torch.float32,
                       device=x.device)
    y = torch.empty_like(x)
    gamma, beta = scale.float(), bias.float()  # held until the launch
    fn = (_lib.lib().vdx_group_norm_stream_bf16 if x.dtype == torch.bfloat16
          else _lib.lib().vdx_group_norm_stream_f32)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
             work.data_ptr(), B, S, C, num_groups, plan.rows_per_chunk,
             float(eps), int(with_silu), _lib.stream_ptr(x.device))
    _lib.check(err, "K3 fused_group_norm_2phase")
    fused_group_norm_2phase.launches += 1
    return y


fused_group_norm_2phase.launches = 0


def group_norm_silu_cuda(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5,
                         with_silu: bool = True) -> torch.Tensor:
    """Channels-last [B, ..., C] dispatch for a CUDA tensor: folds every
    non-batch axis into S, then K2 where one cluster holds a stripe, else
    K3 (:func:`gn_plan`); raises when neither kernel takes the shape."""
    shape = x.shape
    B, C = shape[0], shape[-1]
    S = math.prod(shape[1:-1])
    x3 = x.reshape(B, S, C)
    if not x3.is_contiguous():
        x3 = x3.contiguous()
    plan = gn_plan(B, S, C, num_groups, x.element_size())
    if plan is None:
        raise NotImplementedError(
            f"no Hopper GroupNorm kernel takes [B={B}, S={S}, C={C}], "
            f"G={num_groups}")
    fn = fused_group_norm if plan.route == "K2" else fused_group_norm_2phase
    y = fn(x3, scale, bias, num_groups=num_groups, eps=eps, with_silu=with_silu)
    return y.reshape(shape)
