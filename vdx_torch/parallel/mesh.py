"""Device mesh, axis bindings and the collectives over them (port of
vdx/parallel/mesh.py).

The mesh has vdx's three axes:

  * ``data``   — batch / independent experiments (data parallelism)
  * ``frames`` — the temporal axis (sequence parallelism; only the
                 cross-frame ops communicate)
  * ``tensor`` — attention heads / MLP hidden (tensor parallelism)

:func:`make_mesh` lays the ranks of the initialised process group out as
a ``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names=AXES``.

vdx runs its frame-sharded programs inside ``shard_map``, where
``jax.lax`` collectives name a mesh axis. The port's counterpart of that
axis environment is :meth:`Mesh.bind`: inside ``with mesh.bind():`` an
axis name resolves to that axis's process group, and the functions below,
named after their ``jax.lax`` counterparts, run over it:
:func:`axis_size`, :func:`axis_index`, :func:`psum`, :func:`pmean`,
:func:`ppermute`, :func:`all_to_all` (tiled) and :func:`all_gather`
(tiled). A collective on an axis that no context binds raises
``NameError``, as ``jax.lax`` does outside ``shard_map``; it never runs
locally in silence. Every collective runs through ``torch.distributed``,
also on a one-rank axis (where it is a copy), so a one-rank mesh drives
the same calls as a wider one.

vdx's ``make_mesh`` takes the first n of at least n devices; the port
takes exactly n ranks: ``world_size`` must equal data * frames * tensor
(ROADMAP Queue 3, a known deviation). ``param_sharding_rules`` (tensor
parallelism) comes with the tensor axis in the next slice.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXES = ("data", "frames", "tensor")

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


class Sharding(NamedTuple):
    """A DTensor layout: ``distribute_tensor(x, *sharding)`` (vdx's
    ``NamedSharding``)."""

    device_mesh: object
    placements: tuple


class _Axis(NamedTuple):
    group: object
    size: int
    index: int


_bound = threading.local()


class Mesh:
    """The DeviceMesh over (data, frames, tensor) and its axis bindings.
    ``shape`` maps each axis name to its size, as vdx's ``Mesh.shape``."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.device_type = device_mesh.device_type
        self.shape = {a: device_mesh.size(i) for i, a in enumerate(AXES)}

    @contextlib.contextmanager
    def bind(self):
        """Bind every axis name of the mesh to its process group for the
        collectives below (``shard_map``'s axis environment)."""
        dm = self.device_mesh
        axes = {a: _Axis(dm.get_group(a), self.shape[a], dm.get_local_rank(a))
                for a in AXES}
        stack = _stack()
        stack.append(axes)
        try:
            yield self
        finally:
            stack.pop()


def _stack() -> list:
    if not hasattr(_bound, "stack"):
        _bound.stack = []
    return _bound.stack


def _axis(name: str) -> _Axis:
    for axes in reversed(_stack()):
        if name in axes:
            return axes[name]
    raise NameError(f"unbound axis name {name!r}: no Mesh.bind() context "
                    "binds it (collectives never run locally in silence)")


def make_mesh(data: int = 1, frames: int = 1, tensor: int = 1) -> Mesh:
    """The (data, frames, tensor) mesh over every rank of the initialised
    process group, data outermost, on the backend's devices (NCCL: the
    cards, gloo: the CPU)."""
    n = data * frames * tensor
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {data}x{frames}x{tensor} mesh needs an initialised process "
            "group: launch with torchrun and call "
            "vdx_torch.parallel.distributed.initialize() first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"a {data}x{frames}x{tensor} mesh needs world_size == {n}, the "
            f"process group has {world} ranks (vdx would take the first {n} "
            "devices; the port takes exactly n ranks)")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, (data, frames, tensor),
                                 mesh_dim_names=AXES))


def auto_mesh_shape(n: int) -> Tuple[int, int, int]:
    """vdx's default layout for n devices: favour data, then frames, then
    tensor."""
    if n % 2 == 0 and n >= 8:
        return n // 4, 2, 2
    if n % 2 == 0 and n >= 4:
        return n // 2, 2, 1
    return n, 1, 1


def auto_mesh(n_devices: Optional[int] = None) -> Mesh:
    """:func:`auto_mesh_shape` of n (default: the world size) as a mesh."""
    return make_mesh(*auto_mesh_shape(n_devices or dist.get_world_size()))


def video_sharding(mesh: Mesh) -> Sharding:
    """[B, F, H, W, C] latents: batch over data, frames over frames (the
    frame-sharded pipelines keep their latents replicated and cut the
    frames inside the sharded apply; the data axis's slice places a batch
    with this)."""
    from torch.distributed.tensor import Replicate, Shard

    return Sharding(mesh.device_mesh, (Shard(0), Shard(1), Replicate()))


def replicated(mesh: Mesh) -> Sharding:
    from torch.distributed.tensor import Replicate

    return Sharding(mesh.device_mesh, (Replicate(),) * 3)


# ----------------------------------------------------------------------
# collectives over a bound axis (jax.lax's names)
# ----------------------------------------------------------------------
def axis_size(axis_name: str) -> int:
    return _axis(axis_name).size


def axis_index(axis_name: str) -> int:
    return _axis(axis_name).index


def psum(x: Tensors, axis_name: str):
    """Sum over the axis; a tuple of tensors (one dtype) goes in one
    all_reduce."""
    ax = _axis(axis_name)
    xs = (x,) if torch.is_tensor(x) else tuple(x)
    flat = torch.cat([t.reshape(-1) for t in xs])
    dist.all_reduce(flat, group=ax.group)
    out = [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in xs]), xs)]
    return out[0] if torch.is_tensor(x) else tuple(out)


def pmean(x: Tensors, axis_name: str):
    n = _axis(axis_name).size
    s = psum(x, axis_name)
    return s / n if torch.is_tensor(s) else tuple(t / n for t in s)


def ppermute(x: Tensors, axis_name: str, perm: Sequence[Tuple[int, int]]):
    """Send to ``dst`` for every (this index, dst) pair of ``perm`` and
    receive from ``src`` for every (src, this index) pair, in one batch of
    point-to-point ops; an index that no pair sends to receives zeros.
    Bool tensors travel as uint8."""
    ax = _axis(axis_name)
    me = ax.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    xs = (x,) if torch.is_tensor(x) else tuple(x)
    wire = [t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
            for t in xs]
    outs = [torch.zeros_like(t) for t in wire]
    ops = []
    for t, o in zip(wire, outs):
        for d in dst:
            if d == me:
                o.copy_(t)
            else:
                ops.append(dist.P2POp(dist.isend, t,
                                      dist.get_global_rank(ax.group, d), ax.group))
        for s in src:
            if s != me:
                ops.append(dist.P2POp(dist.irecv, o,
                                      dist.get_global_rank(ax.group, s), ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    outs = [o.bool() if t.dtype == torch.bool else o for o, t in zip(outs, xs)]
    return outs[0] if torch.is_tensor(x) else tuple(outs)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: x splits into n chunks
    along ``split_axis``, chunk j goes to index j, and the chunks received
    are concatenated along ``concat_axis`` in index order."""
    ax = _axis(axis_name)
    n = ax.size
    S = x.shape[split_axis]
    if S % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size {S} does not "
                         f"split over {n} shards")
    # [n, S/n, rest...] with the chunks outermost: all_to_all_single sends
    # dim-0 chunk j to index j and stacks what it receives in index order
    xm = x.movedim(split_axis, 0)
    send = xm.reshape(n, S // n, *xm.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    # back to x's axis order with the sender index in front ...
    y = recv.movedim(1, split_axis + 1)
    # ... then the sender index merged, outermost, into the concat axis
    y = y.movedim(0, concat_axis)
    shape = list(y.shape)
    shape[concat_axis:concat_axis + 2] = [shape[concat_axis] * shape[concat_axis + 1]]
    return y.reshape(shape)


def all_gather(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=dim, tiled=True)``: every index's x
    concatenated along ``dim`` in index order."""
    ax = _axis(axis_name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)
