"""Ring attention over the frame axis (port of
vdx/parallel/ring_attention.py).

With the frame axis F sharded over a mesh axis, each rank keeps its
local query block and the KV blocks rotate one step around the ring per
round (:func:`~vdx_torch.parallel.mesh.ppermute`, circular), while the
online-softmax partials accumulate: after n - 1 rotations every query has
seen every key, and the result is exactly full attention. Spatial and
cross attention are frame-local; only the temporal sites communicate.
"""

from __future__ import annotations

from typing import Optional

import torch

from vdx_torch.parallel.mesh import Mesh, all_gather, axis_index, axis_size, ppermute


def _block_attention(q, k, v, scale: float, kv_valid=None):
    """Unnormalised block attention -> (numerator, denominator, rowmax).

    q [B, Sq, H, D], k/v [B, Skv, H, D]; ``kv_valid`` an optional [Skv]
    bool marking the key positions that are real frames (ragged frame
    sharding: padded frames give no probability mass to any query).
    -> acc [B, Sq, H, D] fp32, l and m [B, Sq, H, 1]. Products in fp32
    from the stored operands, probs rounded to v's dtype before the
    second, as vdx's einsums with fp32 accumulation."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_valid is not None:
        s = s.masked_fill(~kv_valid[None, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    if kv_valid is not None:
        # a block whose keys are all padding (a shard of padding only) has
        # m = -inf: clamped, exp(s - m) = exp(-inf) = 0 instead of NaN, and
        # _combine weights the block by exp(m - m') = 0
        m = m.clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return acc.transpose(1, 2), l.transpose(1, 2), m.transpose(1, 2)


def _combine(acc1, l1, m1, acc2, l2, m2):
    """Merge two online-softmax partials."""
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return acc1 * a1 + acc2 * a2, l1 * a1 + l2 * a2, m


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str, scale: Optional[float] = None,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full attention with the sequence sharded over ``axis_name``:
    q/k/v are this rank's shards [B, S_local, H, D] (inside a
    ``Mesh.bind()``), the result is this rank's output shard.

    ``kv_valid`` ([S_local] bool): which local key positions are real
    frames; it rotates around the ring with its KV block. Queries at
    padded positions give finite values that the caller discards."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = axis_size(axis_name)
    acc, l, m = _block_attention(q, k, v, scale, kv_valid)
    perm = [(j, (j + 1) % n) for j in range(n)]
    for _ in range(n - 1):
        if kv_valid is None:
            k, v = ppermute((k, v), axis_name, perm)
        else:
            k, v, kv_valid = ppermute((k, v, kv_valid), axis_name, perm)
        acc, l, m = _combine(acc, l, m,
                             *_block_attention(q, k, v, scale, kv_valid))
    return (acc / l).to(q.dtype)


def make_sharded_temporal_attention(mesh: Mesh, axis_name: str = "frames"):
    """-> attention(q, k, v) over global [B, F, H, D] on every rank: each
    rank takes its frame shard, runs the ring, and the output shards are
    gathered over the axis (vdx's ``shard_map``-wrapped global view)."""

    def attn(q, k, v):
        n = mesh.shape[axis_name]
        Fl = q.shape[1] // n
        with mesh.bind():
            i = axis_index(axis_name)
            sl = slice(i * Fl, (i + 1) * Fl)
            out = ring_attention(q[:, sl], k[:, sl], v[:, sl], axis_name=axis_name)
            return all_gather(out, axis_name, dim=1)

    return attn
