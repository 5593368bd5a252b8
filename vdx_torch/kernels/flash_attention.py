"""K1 — staticmax flash attention (CUDA, ``csrc/flash_attention.cu``).

Port of vdx/kernels/flash_attention.py ``flash_attention_dt(...,
exp_impl="staticmax")``: non-causal softmax(q k^T * scale) v over
[B, S, H, D] tensors in the max-free base-2 form

    p = 2^(s * scale * log2(e) - 80),   out = (sum bf16(p) v) / max(l, 2^-126)

with ``l`` summed from the unrounded p. The power-of-two offset is exact
and cancels in acc / l. Domain bound (as vdx, ``STATIC_OFF``): a row whose
every scaled logit is below -46 underflows to zeros; one above ~193
overflows.

:func:`flash_attention_dt` launches the CUDA kernel for a CUDA tensor and
raises on anything the kernel does not take; for a CPU tensor it computes
:func:`flash_attention_dt_plain`, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import torch

from vdx_torch.kernels import _lib

LOG2E = 1.4426950408889634
STATIC_OFF = 80.0
L_FLOOR = 2.0 ** -126


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


def _check_operand(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"K1 takes bf16 {name}, got {t.dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"K1 needs {name} as [B, S, H, D] with unit stride on D")
    if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"K1 needs {name} 16-byte aligned rows "
                         f"(strides {t.stride()})")


def flash_attention_dt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, scale: float) -> torch.Tensor:
    """Staticmax flash attention, [B, Sq, H, D] x [B, Skv, H, D]^2 -> q's shape.

    CUDA: bf16 only, D % 8 == 0 and D < 128, 16-byte aligned rows; one
    launch on the current stream, no synchronise. CPU: the plain version.
    """
    if q.device.type == "cpu":
        return flash_attention_dt_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, got {q.device}")
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {q.shape} k {k.shape} v {v.shape}")
    if D % 8 or not 8 <= D < 128:  # what ops.attention sends here
        raise ValueError(f"K1 takes head dims 8..120 in steps of 8, got {D}")
    if B * H > 65535 or Sq < 1 or Skv < 1:
        raise ValueError(f"K1 grid out of range: B*H={B * H}, Sq={Sq}, Skv={Skv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _lib.lib()
    err = lib.vdx_flash_attention_dt_staticmax_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Skv, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], float(scale * LOG2E), _lib.stream_ptr(q.device),
    )
    _lib.check(err, "K1 flash_attention_dt")
    flash_attention_dt.launches += 1
    return o


flash_attention_dt.launches = 0
