"""Frame sharding's shared rules: the temporal site (the motion module's and
Latte's temporal blocks), the scope of a GroupNorm over the frame axis
(the motion module and the SVD and ModelScope UNets' frame convs), the
mask of real frames and the PE at global frame positions. vdx keeps these
in vdx/nn/temporal.py and repeats the site's rule in vdx/models/dit.py.

``temporal_impl`` names the mode: "local", ``"ring:<axis>"`` or
``"ulysses:<axis>"``. Inside a ``Mesh.bind()`` the frame axis of every
tensor is this rank's shard; ``frames_valid`` is the global count of real
frames in a zero-padded frame axis (ragged frame sharding), or None.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from vdx_torch.nn.embeddings import sinusoidal_positional_encoding
from vdx_torch.parallel.mesh import all_to_all, axis_index, axis_size


def _ring_axis(temporal_impl: str) -> Optional[str]:
    return temporal_impl.split(":", 1)[1] if temporal_impl.startswith("ring:") else None


def _ulysses_axis(temporal_impl: str) -> Optional[str]:
    return (temporal_impl.split(":", 1)[1]
            if temporal_impl.startswith("ulysses:") else None)


def _shard_axis(temporal_impl: str) -> Optional[str]:
    """The mesh axis the frames are sharded over, in either sharded mode:
    GN statistics, halo'd frame convs and global frame positions key off
    it; only the temporal blocks' attention differs between the modes."""
    return _ring_axis(temporal_impl) or _ulysses_axis(temporal_impl)


def frame_validity_mask(frames_local: int, frames_valid: int,
                        axis: Optional[str], device=None) -> torch.Tensor:
    """[F_local] bool: the local frame slots that hold real frames, those
    whose global index (shard index * F_local + local index, or the local
    index when ``axis`` is None) is below ``frames_valid``."""
    idx = torch.arange(frames_local, device=device)
    if axis is not None:
        idx = idx + axis_index(axis) * frames_local
    return idx < frames_valid


def frame_stats(temporal_impl: str, frames_local: int,
                frames_valid: Optional[int], device=None):
    """(axis, mask) of a GroupNorm whose statistics span the frame axis:
    the mesh axis they are reduced over (None locally) and, where
    ``frames_valid`` leaves padded slots, the [F_local] mask of the real
    frames (else None)."""
    axis = _shard_axis(temporal_impl)
    n = 1 if axis is None else axis_size(axis)
    if frames_valid is None or frames_valid >= frames_local * n:
        return axis, None
    return axis, frame_validity_mask(frames_local, frames_valid, axis, device)


def global_frame_pe(F_local: int, dim: int, axis: Optional[str],
                    device=None) -> torch.Tensor:
    """The sinusoidal frame PE [F_local, dim] at this shard's global frame
    positions (the local positions when ``axis`` is None)."""
    if axis is None:
        return sinusoidal_positional_encoding(F_local, dim, device)
    i = axis_index(axis)
    pe = sinusoidal_positional_encoding(F_local * axis_size(axis), dim, device)
    return pe[i * F_local:(i + 1) * F_local]


def run_temporal_site(fn: Callable, x: torch.Tensor, temporal_impl: str,
                      frames_valid: Optional[int] = None,
                      per_position: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """A temporal site on x [P, F, C] (P positions, each attending across
    its F frames), locally or on a frame shard:
    ``fn(x, ring_axis, kv_valid, *per_position)`` runs the site's body.

    * ``"ulysses:<axis>"`` where P divides the axis: a tiled all_to_all
      swaps [P, F_local, C] to [P/n, F_global, C], the body runs locally
      (``ring_axis`` None) on this rank's P/n rows of every ``per_position``
      tensor [P, ...], and a second all_to_all swaps back. Where P does not
      divide the axis the site takes the ring: a static per-site choice,
      both exact.
    * ``"ring:<axis>"``: the body runs ring attention over ``ring_axis``;
      with ragged frames ``kv_valid`` [F_local] masks the padded slots out
      of every softmax.
    * local (and after the Ulysses swap), ragged: x is sliced to the real
      frames, the body runs, and the padded slots are zero-filled."""
    u_axis = _ulysses_axis(temporal_impl)
    ring = _ring_axis(temporal_impl)
    if u_axis is not None and x.shape[0] % axis_size(u_axis):
        ring, u_axis = u_axis, None
    if u_axis is not None:
        n, i = axis_size(u_axis), axis_index(u_axis)
        x = all_to_all(x, u_axis, split_axis=0, concat_axis=1)
        per_position = [t[i * (t.shape[0] // n):(i + 1) * (t.shape[0] // n)]
                        for t in per_position]
    kv_valid, pad_f = None, 0
    if frames_valid is not None:
        if ring is None:
            pad_f = x.shape[1] - frames_valid
            if pad_f:
                x = x[:, :frames_valid]
        elif frames_valid < x.shape[1] * axis_size(ring):
            kv_valid = frame_validity_mask(x.shape[1], frames_valid, ring,
                                           x.device)
    x = fn(x, ring, kv_valid, *per_position)
    if pad_f:
        x = F.pad(x, (0, 0, 0, pad_f))
    if u_axis is not None:
        x = all_to_all(x, u_axis, split_axis=1, concat_axis=0)
    return x
