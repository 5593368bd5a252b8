"""K1 (staticmax) and K4 (running-max) flash attention (CUDA,
``csrc/flash_attention*.cu``).

K1 — port of vdx/kernels/flash_attention.py ``flash_attention_dt(...,
exp_impl="staticmax")``: non-causal softmax(q k^T * scale) v over
[B, S, H, D] tensors in the max-free base-2 form

    p = 2^(s * scale * log2(e) - 80),   out = (sum r(p) v) / max(l, 2^-126)

with ``l`` summed from the unrounded p and r() the rounding to v's dtype.
The power-of-two offset is exact and cancels in acc / l. Domain bound (as
vdx, ``STATIC_OFF``): a row whose every scaled logit is below -46
underflows to zeros; one above ~193 overflows.

K4 — port of vdx/kernels/flash_attention.py ``flash_attention``: the same
function by the running-max online softmax (m' = max(m, rowmax s),
alpha = e^(m - m'), p = e^(s - m'), l' = alpha l + sum p over the
unrounded p, acc' = alpha acc + r(p) v), for any head dim up to 256. No
domain bound.

K6, K7, K8 — ports of vdx/kernels/flash_attention.py
``flash_attention_blockdiag``, ``flash_attention_blockdiag_tc`` and
``flash_attention_blockdiag_tc2``: per-position attention over the F
frames of [P, F, H, D] tensors (the motion modules' temporal sites),

    out[p, :, h] = softmax_g(q[p, :, h] . k[p, g, h]) v[p, :, h]

in base 2 with l summed from the unrounded p and PV from p rounded to v's
dtype. K6 folds scale * log2(e) into q in q's own dtype (so under bf16
the constant and the product round to bf16); K7 and K8 multiply the fp32
scores by it, and compute the identical function. All three run as modes
of one Hopper kernel (``csrc/temporal_attention.cu``; K9, in
kernels/temporal_attention_cp.py, is its third mode).

Each wrapper launches its CUDA kernel for a CUDA tensor (K1/K4: bf16 on
the tensor cores, fp32 on a SIMT kernel with fp32 p; K6-K9: fp32 FMAs for
either dtype) and raises on anything the kernel does not take; for a CPU
tensor it computes its plain PyTorch version, which the tests and
``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import torch

from vdx_torch.kernels import _lib

LOG2E = 1.4426950408889634
STATIC_OFF = 80.0
L_FLOOR = 2.0 ** -126
# csrc/temporal_attention.cu takes up to 32 frames and head dims up to 160
TEMPORAL_MAX_F = 32
TEMPORAL_MAX_D = 160


def flash_attention_dt_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, scale: float) -> torch.Tensor:
    """Plain PyTorch staticmax attention: the kernel's arithmetic, with the
    S x S score tensor materialised. [B, Sq, H, D] -> [B, Sq, H, D]."""
    # q pre-scaled in fp32 and rounded once to q's dtype (as vdx does
    # host-side before the Pallas kernel)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp2(s - STATIC_OFF)
    l = torch.clamp_min(p.sum(dim=-1), L_FLOOR)  # [b, h, q]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float) -> torch.Tensor:
    """Plain PyTorch K4: the S x S scores materialised, softmax in fp32
    with l from the unrounded p, PV from p rounded to v's dtype, one
    rounding at the end. [B, Sq, H, D] -> [B, Sq, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)  # [b, h, q]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def _check_operands(what: str, q, k, v) -> None:
    """Device, dtype, shape and layout checks shared by K1 and K4."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {q.device}")
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {q.shape} k {k.shape} v {v.shape}")
    if B * H > 65535 or Sq < 1 or Skv < 1:
        raise ValueError(f"{what} grid out of range: B*H={B * H}, Sq={Sq}, "
                         f"Skv={Skv}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or fp32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{what} needs {name} with unit stride on D")


def _rows_16b_aligned(*ts: torch.Tensor) -> bool:
    """Every [b, s, h] row of each tensor starts on a 16-byte boundary
    (bf16: strides in multiples of 8 elements, an aligned base)."""
    return all(not any(st % 8 for st in t.stride()[:3]) and t.data_ptr() % 16 == 0
               for t in ts)


def _strides(*ts: torch.Tensor):
    return [st for t in ts for st in t.stride()[:3]]


def _launch_f32(q, k, v, *, scale: float, running_max: bool) -> torch.Tensor:
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    B, Sq, H, D = q.shape
    err = _lib.lib().vdx_flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, k.shape[1], H, D, *_strides(q, k, v, o),
        float(scale * LOG2E), int(running_max), _lib.stream_ptr(q.device))
    _lib.check(err, "flash attention (fp32)")
    return o


def flash_attention_dt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, scale: float) -> torch.Tensor:
    """K1: staticmax flash attention, [B, Sq, H, D] x [B, Skv, H, D]^2 ->
    q's shape.

    CUDA: D % 8 == 0 and D < 128 (what ops.attention sends here); bf16
    with 16-byte aligned rows on the tensor cores, or fp32; one launch on
    the current stream, no synchronise. CPU: the plain version.
    """
    if q.device.type == "cpu":
        return flash_attention_dt_plain(q, k, v, scale=scale)
    _check_operands("K1", q, k, v)
    B, Sq, H, D = q.shape
    if D % 8 or not 8 <= D < 128:
        raise ValueError(f"K1 takes head dims 8..120 in steps of 8, got {D}")
    if q.dtype == torch.float32:
        o = _launch_f32(q, k, v, scale=scale, running_max=False)
    else:
        if not _rows_16b_aligned(q, k, v):
            raise ValueError("K1 needs bf16 q/k/v rows 16-byte aligned "
                             f"(strides {q.stride()}, {k.stride()}, {v.stride()})")
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        err = _lib.lib().vdx_flash_attention_dt_staticmax_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, k.shape[1], H, D, *_strides(q, k, v, o),
            float(scale * LOG2E), _lib.stream_ptr(q.device))
        _lib.check(err, "K1 flash_attention_dt")
    flash_attention_dt.launches += 1
    return o


flash_attention_dt.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, scale: float) -> torch.Tensor:
    """K4: running-max flash attention, [B, Sq, H, D] x [B, Skv, H, D]^2
    -> q's shape, any 1 <= D <= 256.

    CUDA: bf16 on the tensor cores (16-byte row loads when D % 8 == 0 and
    the rows are aligned, element loads otherwise), or fp32; one launch on
    the current stream, no synchronise. CPU: the plain version.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    _check_operands("K4", q, k, v)
    B, Sq, H, D = q.shape
    if not 1 <= D <= 256:
        raise ValueError(f"K4 takes head dims 1..256, got {D}")
    if q.dtype == torch.float32:
        o = _launch_f32(q, k, v, scale=scale, running_max=True)
    else:
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        vec = D % 8 == 0 and _rows_16b_aligned(q, k, v)
        err = _lib.lib().vdx_flash_attention_runmax_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, k.shape[1], H, D, *_strides(q, k, v, o),
            float(scale * LOG2E), int(vec), _lib.stream_ptr(q.device))
        _lib.check(err, "K4 flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


# ------------------------------------------------- K6-K9: temporal sites --


def _base2_softmax_pv(s: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """K6-K8's tail on fp32 scores s [P, H, F, F] (log2 domain): p =
    2^(s - rowmax), l from the unrounded p, PV from p rounded to v's
    dtype, one rounding to ``dtype`` at the end -> [P, F, H, D]."""
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)  # [P, H, F]
    acc = torch.einsum("phfg,pghd->pfhd", p.to(v.dtype).float(), v.float())
    return (acc / l.transpose(1, 2)[..., None]).to(dtype)


def flash_attention_blockdiag_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, *,
                                    scale: float) -> torch.Tensor:
    """Plain PyTorch K6: q pre-scaled by scale * log2(e) in q's dtype,
    then :func:`_base2_softmax_pv`. [P, F, H, D] -> [P, F, H, D]."""
    qs = q * torch.tensor(scale * LOG2E, dtype=q.dtype)
    s = torch.einsum("pfhd,pghd->phfg", qs.float(), k.float())
    return _base2_softmax_pv(s, v, q.dtype)


def flash_attention_blockdiag_tc_plain(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, *,
                                       scale: float) -> torch.Tensor:
    """Plain PyTorch K7/K8: the fp32 scores times scale * log2(e), then
    :func:`_base2_softmax_pv`. [P, F, H, D] -> [P, F, H, D]."""
    s = torch.einsum("pfhd,pghd->phfg", q.float(), k.float()) \
        * (scale * LOG2E)
    return _base2_softmax_pv(s, v, q.dtype)


def check_temporal_shapes(what: str, q, k, v) -> None:
    """q, k and v of one [P, F, H, D] shape (vdx's folds need it)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what} takes q, k, v of one [P, F, H, D] shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _check_blockdiag(what: str, q, k, v, block: int, heads=None) -> None:
    """vdx's preconditions of K6-K8 (its asserts), on every device."""
    check_temporal_shapes(what, q, k, v)
    P, F, H, D = q.shape
    if heads is not None and H != heads:
        raise ValueError(f"{what}: q has {H} heads, heads={heads}")
    if D % 8:
        raise ValueError(f"{what} takes D % 8 == 0, got D={D}")
    if block % 128 or block % F:
        raise ValueError(f"{what} takes block % 128 == 0 and F | block; "
                         f"got block={block}, F={F}")


def launch_temporal(entry: str, what: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, mult: float) -> torch.Tensor:
    """One launch of a mode of ``csrc/temporal_attention.cu`` on CUDA
    [P, F, H, D] operands (strided views, unit stride on D); -> a
    contiguous output of q's shape and dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or fp32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{what} needs {name} with unit stride on D")
    P, F, H, D = q.shape
    if not (1 <= F <= TEMPORAL_MAX_F and 1 <= D <= TEMPORAL_MAX_D):
        raise ValueError(f"{what}: the Hopper kernel takes 1..{TEMPORAL_MAX_F} "
                         f"frames and head dims 1..{TEMPORAL_MAX_D}; got "
                         f"F={F}, D={D}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if o.numel() == 0:
        return o
    per_16b = 16 // q.element_size()
    vec = D % 8 == 0 and all(
        not any(st % per_16b for st in t.stride()[:3]) and t.data_ptr() % 16 == 0
        for t in (q, k, v))
    err = getattr(_lib.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        P, F, H, D, *_strides(q, k, v, o), float(mult),
        int(q.dtype == torch.bfloat16), int(vec), _lib.stream_ptr(q.device))
    _lib.check(err, what)
    return o


def flash_attention_blockdiag(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              block: int = 512) -> torch.Tensor:
    """K6: per-position attention over the F frames of [P, F, H, D] q, k,
    v (bf16 or fp32) -> q's shape, with scale * log2(e) folded into q in
    q's dtype.

    Raises where vdx asserts: one shape for q, k and v; D % 8 == 0;
    block % 128 == 0 and F | block. ``block`` is the TPU kernel's tile of
    the folded P*F token axis; the Hopper kernel needs none (one warp per
    position and head) and keeps it only for those preconditions. CUDA:
    one launch, F <= 32 and D <= 160. CPU: the plain version.
    """
    _check_blockdiag("K6", q, k, v, block)
    if q.device.type == "cpu":
        return flash_attention_blockdiag_plain(q, k, v, scale=scale)
    mult = torch.tensor(scale * LOG2E, dtype=q.dtype).item()
    o = launch_temporal("vdx_temporal_attention_blockdiag", "K6 blockdiag",
                        q, k, v, mult)
    flash_attention_blockdiag.launches += 1
    return o


flash_attention_blockdiag.launches = 0


def flash_attention_blockdiag_tc(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, scale: float, heads: int,
                                 block: int = 256) -> torch.Tensor:
    """K7: K6's attention with scale * log2(e) applied to the fp32 scores
    (vdx's [T, C]-layout form). Raises where vdx asserts (H == heads,
    D % 8 == 0, block % 128 == 0, F | block, one shape for q, k, v); the
    Hopper kernel needs no ``block``. CUDA: one launch of the kernel's
    fp32-scaled-scores mode, F <= 32, D <= 160. CPU: the plain version."""
    _check_blockdiag("K7", q, k, v, block, heads)
    if q.device.type == "cpu":
        return flash_attention_blockdiag_tc_plain(q, k, v, scale=scale)
    o = launch_temporal("vdx_temporal_attention_tc", "K7 blockdiag_tc",
                        q, k, v, scale * LOG2E)
    flash_attention_blockdiag_tc.launches += 1
    return o


flash_attention_blockdiag_tc.launches = 0


def flash_attention_blockdiag_tc2(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, scale: float, heads: int,
                                  block: int = 256) -> torch.Tensor:
    """K8: vdx's q-major variant of K7, the identical function; the same
    kernel mode, counted apart. Preconditions and devices as K7."""
    _check_blockdiag("K8", q, k, v, block, heads)
    if q.device.type == "cpu":
        return flash_attention_blockdiag_tc_plain(q, k, v, scale=scale)
    o = launch_temporal("vdx_temporal_attention_tc", "K8 blockdiag_tc2",
                        q, k, v, scale * LOG2E)
    flash_attention_blockdiag_tc2.launches += 1
    return o


flash_attention_blockdiag_tc2.launches = 0
