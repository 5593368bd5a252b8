"""Attention op with implementation dispatch (port of vdx/ops/attention.py).

Shapes: q [B, Sq, H, D], k/v [B, Skv, H, D] -> [B, Sq, H, D].

Implementations:
  * ``xla``       — exact fp32 softmax (probs stored in v's dtype), the
                    counterpart of vdx's einsum path.
  * ``xla_bf16p`` — fp32 softmax statistics, probs rounded to bf16 between
                    the two products, normalised by the sum of the rounded
                    probs.
  * ``flash``     — K1, the staticmax flash kernel
                    (kernels/flash_attention.py), for D % 8 == 0, D < 128.
                    Other head dims need K4, which is not ported yet.
  * ``auto``      — flash for long CUDA sequences (Sq, Skv >= 512,
                    D <= 256); xla_bf16p for maskless bf16; else xla. This
                    mirrors vdx, where "flash available" means the TPU
                    backend: here it means a CUDA tensor.

The eager paths compute both products in fp32 from the stored operands, as
vdx's einsums accumulate in fp32 (``preferred_element_type``).
"""

from __future__ import annotations

from typing import Optional

import torch

from vdx_torch.kernels.flash_attention import flash_attention_dt


def _xla_attention(q, k, v, scale: float, mask: Optional[torch.Tensor]):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    scores = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1).to(vt.dtype)
    out = torch.matmul(probs.float(), vt.float())
    return out.to(q.dtype).transpose(1, 2)


def _xla_attention_bf16probs(q, k, v, scale: float):
    """Short-sequence attention with the probs tensor in bf16 (temporal
    S=16 and cross Skv=77 sites); statistics stay fp32."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).to(torch.bfloat16)
    pf = p.float()
    l = pf.sum(dim=-1, keepdim=True)  # [b, h, q, 1]
    out = torch.matmul(pf, vt.float()) / l
    return out.to(q.dtype).transpose(1, 2)


def _should_use_flash(q, k) -> bool:
    # Flash pays off when the score matrix is large; short KV (cross-attn
    # 77, temporal 16-32) stays on the eager path.
    return q.shape[1] >= 512 and k.shape[1] >= 512 and q.shape[-1] <= 256


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over [B, S, H, D] tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_valid is not None or impl.startswith("ring:"):
        raise NotImplementedError(
            "ring attention (kv_valid, impl='ring:*') comes with the "
            "parallel slice (ROADMAP Queue 1 item 14)")

    if impl == "auto":
        if mask is None and q.device.type == "cuda" and _should_use_flash(q, k):
            impl = "flash"
        elif mask is None and v.dtype == torch.bfloat16:
            impl = "xla_bf16p"
        else:
            impl = "xla"

    if impl == "flash":
        D = q.shape[-1]
        if D % 8 == 0 and D < 128:
            return flash_attention_dt(q, k, v, scale=scale)
        raise NotImplementedError(
            f"head dim {D} needs K4 (vdx/kernels/flash_attention.py "
            "flash_attention, the running-max kernel), which is not ported "
            "yet (ROADMAP Queue 2)")
    if impl == "xla_bf16p":
        if mask is not None:
            raise ValueError("bf16-prob path does not support masks")
        return _xla_attention_bf16probs(q, k, v, scale)
    if impl == "xla":
        return _xla_attention(q, k, v, scale, mask)
    if impl in ("blockdiag", "xla_bf16p_packed"):
        raise NotImplementedError(
            f"impl={impl!r} is not ported yet (ROADMAP Queue 2, K6-K9)")
    raise ValueError(f"unknown attention impl {impl!r}")
