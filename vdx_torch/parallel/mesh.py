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

Gradients. Each of those collectives is a ``torch.autograd.Function``
whose backward is its transpose, as JAX differentiates them under
``shard_map``: ``psum``'s is a psum, ``all_gather``'s this rank's slice
of a psum (a reduce-scatter), ``all_to_all``'s the reverse swap and
``ppermute``'s the inverse permutation. That is the calculus of a sum of
per-rank objectives, the frames and data axes' convention (the mesh train
step, parallel/train.py). The tensor axis runs Megatron's convention,
where a replicated activation carries the same cotangent on every rank:
:func:`copy_to_axis` (identity forward, psum backward) at a column
split's input, :func:`reduce_from_axis` (psum forward, identity backward)
at a row split's output, and :func:`scatter_to_axis` /
:func:`gather_from_axis` (slice / all_gather, each the other's backward)
where a layer's output or input changes between replicated and split.

:func:`param_sharding_rules` is vdx's tensor-parallel rule, word for
word, on the port's parameter names (parallel/tensor_parallel.py runs
it). vdx's ``make_mesh`` takes the first n of at least n devices; the
port takes exactly n ranks: ``world_size`` must equal data * frames *
tensor (ROADMAP Queue 3, a known deviation).
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


def batch_sharding(mesh: Mesh) -> Sharding:
    """vdx's ``P("data")``: the leading (batch) axis over data, the rest
    replicated (the train step's context, the batched runner's inputs)."""
    from torch.distributed.tensor import Replicate, Shard

    return Sharding(mesh.device_mesh, (Shard(0), Replicate(), Replicate()))


def local_slices(sharding: Sharding, shape: Sequence[int],
                 coords: Sequence[int]) -> tuple:
    """This rank's index into a tensor of global ``shape`` under
    ``sharding``, at mesh coordinates ``coords`` (one an axis): a tuple of
    slices, even shards as ``distribute_tensor`` cuts them."""
    from torch.distributed.tensor import Shard

    start, size = [0] * len(shape), list(shape)
    for n, i, pl in zip(sharding.device_mesh.mesh.shape, coords,
                        sharding.placements):
        if isinstance(pl, Shard):
            d = pl.dim
            if size[d] % n:
                raise ValueError(f"axis {d} of size {size[d]} does not divide "
                                 f"over {n} shards")
            size[d] //= n
            start[d] += i * size[d]
    return tuple(slice(a, a + b) for a, b in zip(start, size))


def place(x, sharding: Sharding, device=None):
    """vdx's ``jax.device_put(x, sharding)`` for a global array that every
    rank holds: this rank's shard, copied to ``device`` (default the
    mesh's device: this rank's card, or the CPU), as a DTensor of the
    global shape. No communication: each rank cuts its own slice."""
    from torch.distributed.tensor import DTensor

    dm = sharding.device_mesh
    x = torch.as_tensor(x)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dm.device_type == "cuda" else torch.device("cpu"))
    coords = dm.get_coordinate()
    local = x[local_slices(sharding, x.shape, coords)]
    if local.device != torch.device(device):
        if torch.device(device).type == "cuda":
            local = local.pin_memory()
        local = local.to(device, non_blocking=True)
    return DTensor.from_local(local.contiguous(), dm, sharding.placements,
                              run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape, device="meta").stride())


# ----------------------------------------------------------------------
# tensor parallelism: vdx's rule (vdx/parallel/mesh.py:50-100)
# ----------------------------------------------------------------------
# Megatron-style paired split (attention + MLP): the producer of the inner
# activation splits its OUTPUT axis (column), the consumer its INPUT axis
# (row), so the inner activation lives sharded between them with one
# reduction at the row output. Matched on vdx's module names.
_COL_SPLIT = ("to_q", "to_k", "to_v", "net_0", "fc1", "q_proj", "k_proj",
              "v_proj", "ff_in")
_ROW_SPLIT = ("to_out", "net_2", "fc2", "out_proj", "ff_out")


def _vdx_axes(transform, ndim: int) -> dict:
    """vdx's axis -> the torch weight's dim, for a conversion rule's
    transform: a flax kernel's last axis (the output) is a Linear's,
    Conv2d's and Conv3d's dim 0, and its second-to-last (the input) their
    dim 1; identity transforms keep every axis."""
    from vdx_torch.core import convert as C

    if transform is C.t_id:
        return {a: a for a in range(-ndim, 0)}
    if transform in (C.t_dense, C.t_conv, C.t_conv3d, C.t_conv3d_1x1_dense):
        return {-1: 0, -2: 1}
    return {-1: 0}  # a patch conv: [p*p*C, D] <- [D, C, p, p]


def param_sharding_rules(module: torch.nn.Module, mesh,
                         min_size: int = 2**16) -> dict:
    """vdx's tensor-parallel shardings for a built module: {parameter
    name: the torch weight's dim split over the tensor axis, or None where
    the parameter is replicated}.

    The rule is vdx's, decided on vdx's parameter path and shape (from the
    module's conversion rules, core/convert.py ``rules_for``: vdx path ->
    (torch key, transform)), so that the same leaves split: a kernel of
    >= 2 dims and ``min_size`` elements under a row-split module name
    splits its input axis where ``tensor`` divides it; any other such
    kernel its output axis; a column-split module's bias shards with its
    kernel; everything else, and everything at ``tensor`` == 1, is
    replicated. ``mesh`` needs only ``shape``."""
    import numpy as np

    from vdx_torch.core import convert as C

    n = mesh.shape["tensor"]
    by_key = {key: (path, tr) for path, (key, tr) in C.rules_for(module).items()}
    out = {}
    for name, p in module.named_parameters():
        if n <= 1 or name not in by_key:
            out[name] = None
            continue
        path, tr = by_key[name]
        names = path.split("/")
        x = tr(np.broadcast_to(np.uint8(0), tuple(p.shape)))  # vdx's shape
        size, shape = x.size, x.shape
        col = any(m in _COL_SPLIT for m in names)
        row = any(m in _ROW_SPLIT for m in names)
        axis = None
        if (x.ndim >= 2 and size >= min_size and row and names[-1] == "kernel"
                and shape[-2] % n == 0):
            axis = -2
        elif x.ndim >= 2 and size >= min_size and shape[-1] % n == 0:
            axis = -1
        elif (x.ndim == 1 and col and names[-1] == "bias"
              and shape[0] % n == 0 and size >= n):
            axis = -1
        out[name] = None if axis is None else _vdx_axes(tr, x.ndim)[axis]
    return out


# ----------------------------------------------------------------------
# collectives over a bound axis (jax.lax's names), differentiable
# ----------------------------------------------------------------------
def axis_size(axis_name: str) -> int:
    return _axis(axis_name).size


def axis_index(axis_name: str) -> int:
    return _axis(axis_name).index


def _psum_raw(xs: tuple, ax: _Axis) -> tuple:
    flat = torch.cat([t.reshape(-1) for t in xs])
    dist.all_reduce(flat, group=ax.group)
    return tuple(p.view_as(t) for p, t in zip(flat.split([t.numel() for t in xs]), xs))


def _ppermute_raw(xs: tuple, ax: _Axis, perm) -> tuple:
    me = ax.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
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
    return tuple(o.bool() if t.dtype == torch.bool else o
                 for o, t in zip(outs, xs))


def _all_to_all_raw(x: torch.Tensor, ax: _Axis, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
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


def _all_gather_raw(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def _my_chunk(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    k = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * k, k)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *xs):
        ctx.ax = ax
        return _psum_raw(xs, ax)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + _psum_raw(gs, ctx.ax)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, perm, *xs):
        ctx.ax, ctx.perm = ax, perm
        ctx.diff = [t.is_floating_point() for t in xs]
        outs = _ppermute_raw(xs, ax, perm)
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *gs):
        inv = [(d, s) for s, d in ctx.perm]
        idx = [i for i, d in enumerate(ctx.diff) if d]
        back = _ppermute_raw(tuple(gs[i] for i in idx), ctx.ax, inv)
        out = [None] * len(gs)
        for i, g in zip(idx, back):
            out[i] = g
        return (None, None) + tuple(out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, split_axis, concat_axis, x):
        ctx.args = (ax, split_axis, concat_axis)
        return _all_to_all_raw(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ax, split_axis, concat_axis = ctx.args
        return None, None, None, _all_to_all_raw(g.contiguous(), ax, concat_axis,
                                                 split_axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.args = (ax, dim)
        return _all_gather_raw(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        ax, dim = ctx.args
        (s,) = _psum_raw((g.contiguous(),), ax)
        return None, None, _my_chunk(s, ax, dim)


def psum(x: Tensors, axis_name: str):
    """Sum over the axis; a tuple of tensors (one dtype) goes in one
    all_reduce. Backward: a psum of the cotangents."""
    ax = _axis(axis_name)
    xs = (x,) if torch.is_tensor(x) else tuple(x)
    out = _PSum.apply(ax, *xs)
    return out[0] if torch.is_tensor(x) else tuple(out)


def pmean(x: Tensors, axis_name: str):
    n = _axis(axis_name).size
    s = psum(x, axis_name)
    return s / n if torch.is_tensor(s) else tuple(t / n for t in s)


def ppermute(x: Tensors, axis_name: str, perm: Sequence[Tuple[int, int]]):
    """Send to ``dst`` for every (this index, dst) pair of ``perm`` and
    receive from ``src`` for every (src, this index) pair, in one batch of
    point-to-point ops; an index that no pair sends to receives zeros.
    Bool tensors travel as uint8 (and carry no gradient). Backward: the
    inverse permutation."""
    ax = _axis(axis_name)
    xs = (x,) if torch.is_tensor(x) else tuple(x)
    outs = _PPermute.apply(ax, tuple(perm), *xs)
    return outs[0] if torch.is_tensor(x) else tuple(outs)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: x splits into n chunks
    along ``split_axis``, chunk j goes to index j, and the chunks received
    are concatenated along ``concat_axis`` in index order. Backward: the
    reverse swap."""
    return _AllToAll.apply(_axis(axis_name), split_axis, concat_axis, x)


def all_gather(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=dim, tiled=True)``: every index's x
    concatenated along ``dim`` in index order. Backward: this index's
    slice of the psum of the cotangents (a reduce-scatter)."""
    return _AllGather.apply(_axis(axis_name), dim, x)


# ----------------------------------------------------------------------
# Megatron's conjugate pairs (the tensor axis)
# ----------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _psum_raw((g.contiguous(),), ctx.ax)[0]


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        return _psum_raw((x,), ax)[0]

    @staticmethod
    def backward(ctx, g):
        return None, g


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.args = (ax, dim)
        return _my_chunk(x, ax, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        ax, dim = ctx.args
        return None, None, _all_gather_raw(g, ax, dim)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.args = (ax, dim)
        return _all_gather_raw(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        ax, dim = ctx.args
        return None, None, _my_chunk(g, ax, dim).contiguous()


def copy_to_axis(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Megatron's f at a column split's replicated input: the identity
    forward, a psum of the cotangent backward (each rank's columns give
    part of the input's gradient)."""
    return _CopyTo.apply(_axis(axis_name), x)


def reduce_from_axis(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Megatron's g at a row split's output: the psum of the partial
    products forward, the (replicated) cotangent as it is backward."""
    return _ReduceFrom.apply(_axis(axis_name), x)


def scatter_to_axis(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """A replicated tensor -> this rank's chunk along ``dim``; backward
    all-gathers the chunks' cotangents."""
    return _ScatterTo.apply(_axis(axis_name), dim, x)


def gather_from_axis(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """Every rank's chunk -> the replicated tensor along ``dim``; backward
    takes this rank's chunk of the (replicated) cotangent."""
    return _GatherFrom.apply(_axis(axis_name), dim, x)
