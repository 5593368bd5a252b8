"""Attention op with implementation dispatch (port of vdx/ops/attention.py).

Shapes: q [B, Sq, H, D], k/v [B, Skv, H, D] -> [B, Sq, H, D].

Implementations:
  * ``xla``       — exact fp32 softmax (probs stored in v's dtype), the
                    counterpart of vdx's einsum path.
  * ``xla_bf16p`` — fp32 softmax statistics, probs rounded to bf16 between
                    the two products, normalised by the sum of the rounded
                    probs.
  * ``flash``     — K1, ``flash_attention_dt`` in its staticmax form with
                    vdx's blocks (4096, 1024), for D % 8 == 0 and D < 128;
                    K4, the running-max flash kernel, for every other head
                    dim up to 256 (kernels/flash_attention.py).
  * ``blockdiag`` — K6, per-position attention over a short sequence
                    (the motion modules' F frames) with vdx's default
                    block of 512 (kernels/flash_attention.py).
  * ``xla_bf16p_packed`` — vdx's eager packed short-sequence path:
                    128 // S batch rows packed into one block-diagonal
                    score matrix, probs in bf16; exact against
                    ``xla_bf16p``. Plain PyTorch, as vdx's is XLA, and
                    dispatched only when asked for.
  * ``ring:<axis>`` — ring attention with the sequence sharded over a
                    bound mesh axis (parallel/ring_attention.py); the only
                    impl that takes ``kv_valid``, ragged frame sharding's
                    key mask.
  * ``auto``      — flash for long CUDA sequences (Sq, Skv >= 512,
                    D <= 256); xla_bf16p for maskless bf16 (the temporal
                    sites included, as vdx); else xla. This mirrors vdx,
                    where "flash available" means the TPU backend: here it
                    means a CUDA tensor.

The eager paths compute both products in fp32 from the stored operands, as
vdx's einsums accumulate in fp32 (``preferred_element_type``).
"""

from __future__ import annotations

from typing import Optional

import torch

from vdx_torch.kernels.flash_attention import (LOG2E, L_FLOOR, STATIC_OFF,
                                               flash_attention,
                                               flash_attention_blockdiag,
                                               flash_attention_dt)
from vdx_torch.parallel.ring_attention import ring_attention


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


def _xla_attention_bf16probs_static(q, k, v, scale: float):
    """vdx's eager bf16-probs attention with the max-free static softmax
    (K5's function): p = 2^(s * scale * log2(e) - 80) rounded to bf16, l
    summed from the rounded p and floored at 2^-126. Not dispatched; the
    ``bf16ps`` spec of the attention micro-benchmark."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) \
        * (scale * LOG2E)
    p = torch.exp2(scores - STATIC_OFF).to(torch.bfloat16).float()
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), L_FLOOR)
    out = torch.matmul(p, vt.float()) / l
    return out.to(q.dtype).transpose(1, 2)


def _xla_attention_bf16probs_packed(q, k, v, scale: float, pack: int):
    """vdx's packed short-sequence attention: ``pack`` batch rows share
    one [pack*S, pack*S] score matrix under a block-diagonal mask (-1e30
    off the blocks, so their probs are exactly 0), probs rounded to bf16,
    fp32 statistics; the batch is zero-padded to a multiple of ``pack``
    and trimmed after."""
    B, S, H, D = q.shape
    G = -(-B // pack)
    if G * pack != B:
        pad = (0, 0, 0, 0, 0, 0, 0, G * pack - B)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    qg, kg, vg = (t.reshape(G, pack, S, H, D) for t in (q, k, v))
    scores = torch.einsum("gpshd,gqthd->ghpsqt", qg.float(), kg.float()) * scale
    blockdiag = torch.eye(pack, dtype=torch.bool, device=q.device)
    scores = torch.where(blockdiag[None, None, :, None, :, None], scores,
                         torch.tensor(-1e30, device=q.device))
    m = scores.amax(dim=(4, 5), keepdim=True)
    p = torch.exp(scores - m).to(torch.bfloat16).float()
    l = p.sum(dim=(4, 5))  # [G, H, pack, S]
    out = torch.einsum("ghpsqt,gqthd->gpshd", p, vg.float())
    out = out / l.permute(0, 2, 3, 1)[..., None]
    return out.to(q.dtype).reshape(G * pack, S, H, D)[:B]


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
    """Scaled dot-product attention over [B, S, H, D] tensors.

    ``kv_valid`` ([S_kv_local] bool) is ring-only: ragged frame sharding's
    key-validity mask, rotated around the ring with its KV block."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_valid is not None and not impl.startswith("ring:"):
        raise ValueError("kv_valid is only supported by ring attention; "
                         "local ragged paths slice the frame axis instead")

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
            return flash_attention_dt(q, k, v, scale=scale, block_q=4096,
                                      block_k=1024, exp_impl="staticmax")
        return flash_attention(q, k, v, scale=scale)
    if impl == "xla_bf16p":
        if mask is not None:
            raise ValueError("bf16-prob path does not support masks")
        return _xla_attention_bf16probs(q, k, v, scale)
    if impl == "xla":
        return _xla_attention(q, k, v, scale, mask)
    if impl == "blockdiag":
        return flash_attention_blockdiag(q, k, v, scale=scale)
    if impl == "xla_bf16p_packed":
        if mask is not None:
            raise ValueError("packed path does not support masks")
        S = q.shape[1]
        pack = max(1, 128 // S)
        if pack == 1 or k.shape[1] != S:
            return _xla_attention_bf16probs(q, k, v, scale)
        return _xla_attention_bf16probs_packed(q, k, v, scale, pack)
    if impl.startswith("ring:"):
        # the S axis of q/k/v is a local shard of a mesh axis, bound by a
        # Mesh.bind() context (the frame-sharded temporal sites)
        if mask is not None:
            raise ValueError("ring attention does not support masks")
        return ring_attention(q, k, v, axis_name=impl.split(":", 1)[1],
                              scale=scale, kv_valid=kv_valid)
    raise ValueError(f"unknown attention impl {impl!r}")
