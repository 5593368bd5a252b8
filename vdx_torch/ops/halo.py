"""Frame-axis halo exchange for the temporal convolutions under frame
sharding (port of vdx/ops/halo.py).

A (3, 1, 1) conv over a frame shard needs one edge frame of each
neighbour: one :func:`~vdx_torch.parallel.mesh.ppermute` each way fetches
them. The permutations are not circular, so the shards at the clip's two
ends receive zeros, which is the zero padding of the unsharded conv:
a "valid" conv over the halo-padded shard equals the global conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vdx_torch.parallel.mesh import axis_size, ppermute


def frame_halo_pad(x: torch.Tensor, axis_name: str, halo: int = 1,
                   frame_axis: int = 1) -> torch.Tensor:
    """The local frame shard with ``halo`` frames of each neighbour around
    it: [..., F_local + 2*halo, ...] = left neighbour's tail, the local
    frames, right neighbour's head; zeros at the global edges. At one
    shard, a zero pad."""
    n = axis_size(axis_name)
    if n == 1:
        pad = [0, 0] * (x.dim() - 1 - frame_axis) + [halo, halo]
        return F.pad(x, pad)
    Fl = x.shape[frame_axis]
    tail = x.narrow(frame_axis, Fl - halo, halo)
    head = x.narrow(frame_axis, 0, halo)
    from_left = ppermute(tail, axis_name, [(i, i + 1) for i in range(n - 1)])
    from_right = ppermute(head, axis_name, [(i + 1, i) for i in range(n - 1)])
    return torch.cat([from_left, x, from_right], dim=frame_axis)
