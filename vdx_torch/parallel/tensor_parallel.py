"""Tensor-parallel execution of a denoiser over the mesh's ``tensor`` axis:
vdx's ``param_sharding_rules`` run as column/row-split layers.

vdx lays its parameters out by the rule and lets XLA's SPMD partitioner
insert the collectives. The port has no partitioner, so
:func:`tensor_parallel` cuts each rank's shards out of a built module
that holds the full weights (core/convert.py maps vdx's tree to that
state dict; this function cuts it) and swaps each split layer for its
tensor-parallel form, in place (parameter names do not change):

* **Megatron's pairs** (nn/attention.py): ``to_q``/``to_k``/``to_v`` with
  ``to_out.0`` in :class:`~vdx_torch.nn.attention.Attention`, and
  ``net.0.proj`` with ``net.2`` in ``FeedForward`` (GEGLU) and
  ``GELUFeedForward``. The inner activation stays split (each rank runs
  its heads, or its columns of the hidden layer) and the row split's
  output takes one psum, its replicated bias added once after it.
  Attention whose heads do not divide the axis (ModelScope's 5 heads, the
  SVD UNet's 5/10/20) gathers q, k and v and runs whole on every rank,
  and ``to_out`` takes its rank's slice of the input, as XLA's
  partitioner does.
* **GEGLU's layout.** ``net.0.proj`` computes ``[hidden | gate]``; vdx's
  contiguous split would give one rank all of ``hidden``. In a pair the
  port cuts each half by the axis, so a rank's shard is ``[hidden_r |
  gate_r]`` and a local ``chunk(2)`` pairs the right halves (ROADMAP F22).
* **Every other output-split layer** (convolutions, time-embedding and
  modulation linears, ``proj_in``/``proj_out``, the DiTs' patch
  embeddings) computes its output channels' slice and all-gathers it; a
  replicated bias is added after the gather. A row-split linear outside a
  pair slices its replicated input.
* The replicated parameters used on a split activation (CogVideoX's
  per-head ``norm_q``/``norm_k`` at local heads) get a partial gradient on
  each rank: they are listed in ``module.tp_partial``, and the mesh train
  step sums their gradients over the axis.

Gradients follow Megatron's convention (parallel/mesh.py): a replicated
activation carries the same cotangent on every tensor rank, so a
replicated parameter's gradient is complete on each. The caller runs the
module inside ``with mesh.bind():`` (the mesh train step does);
:func:`gather_state_dict` returns the full state dict (the inverse of
the cut) for comparisons and checkpoints. The text towers and the VAE
stay replicated.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.nn.attention import GEGLU, Attention, FeedForward, GELUFeedForward
from vdx_torch.nn.layers import Conv2d, Dense, FrameConv, PatchConv
from vdx_torch.parallel.mesh import (Mesh, _all_gather_raw, _axis, axis_index,
                                     copy_to_axis, gather_from_axis,
                                     param_sharding_rules, reduce_from_axis,
                                     scatter_to_axis)

AXIS = "tensor"


def _chunk(t: torch.Tensor, dim: int, n: int, i: int, halves: bool) -> torch.Tensor:
    """Rank i's shard of t along ``dim``: the i-th of n contiguous pieces,
    or with ``halves`` the i-th piece of each half, concatenated."""
    if not halves:
        k = t.shape[dim] // n
        return t.narrow(dim, i * k, k)
    a, b = t.chunk(2, dim)
    return torch.cat([_chunk(a, dim, n, i, False), _chunk(b, dim, n, i, False)], dim)


class _TPLayer:
    """The tensor-parallel state of a layer: ``tp_split`` "out" (output
    channels split, dim 0) or "row" (input features split, dim 1);
    ``tp_gather``: an out split all-gathers its output; ``tp_local_in``: a
    row split's input is already split; ``tp_bias``: "shard" (the bias is
    split with the output), "full" (replicated, added after the gather)
    or None (no bias, or a row split's, added after the psum)."""

    tp_split = "out"
    tp_gather = True
    tp_local_in = False
    tp_bias: Optional[str] = None

    def _local_bias(self, cd):
        return self.bias.to(cd) if self.tp_bias == "shard" else None

    def _finish(self, y, cd):
        """An out split's local output -> what the consumer takes."""
        if not self.tp_gather:
            return y
        y = gather_from_axis(y, AXIS, -1)
        return y + self.bias.to(cd) if self.tp_bias == "full" else y


class TPDense(_TPLayer, Dense):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x, w = x.to(cd), self.weight.to(cd)
        if self.tp_split == "out":
            y = F.linear(copy_to_axis(x, AXIS), w, self._local_bias(cd))
            return self._finish(y, cd)
        if not self.tp_local_in:
            x = scatter_to_axis(x, AXIS, -1)
        y = reduce_from_axis(F.linear(x, w), AXIS)
        return y if self.bias is None else y + self.bias.to(cd)


class TPConv2d(_TPLayer, Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x, w, b = copy_to_axis(x.to(cd), AXIS), self.weight.to(cd), self._local_bias(cd)
        if self.kernel_size == (1, 1) and self.stride == (1, 1) \
                and self.padding == (0, 0):
            y = F.linear(x, w[:, :, 0, 0], b)
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride,
                         self.padding).permute(0, 2, 3, 1)
        return self._finish(y, cd)


class TPFrameConv(_TPLayer, FrameConv):
    def forward(self, x: torch.Tensor, padding: str = "same") -> torch.Tensor:
        if padding not in ("same", "valid"):
            raise ValueError(f"unknown frame padding {padding!r}")
        cd = self.policy.compute_dtype
        B, F_, H, W, C = x.shape
        x = copy_to_axis(x.to(cd), AXIS)
        x4 = x.reshape(B, F_, H * W, C).permute(0, 3, 1, 2)
        y = F.conv2d(x4, self.weight.to(cd)[..., 0], self._local_bias(cd),
                     padding=(1, 0) if padding == "same" else (0, 0))
        y = y.permute(0, 2, 3, 1).reshape(B, y.shape[2], H, W, -1)
        return self._finish(y, cd)


class TPPatchConv(_TPLayer, PatchConv):
    def linear(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        w = self.weight.to(cd).permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        y = F.linear(copy_to_axis(x.to(cd), AXIS), w, self._local_bias(cd))
        return self._finish(y, cd)


_TP_CLASS = {Dense: TPDense, Conv2d: TPConv2d, FrameConv: TPFrameConv,
             PatchConv: TPPatchConv}


def plan_tensor_parallel(module: nn.Module, mesh, *,
                         min_size: int = 2**16) -> dict:
    """How :func:`tensor_parallel` runs ``module``: {layer name: its
    mode} ({"tp_split", "tp_gather", "tp_local_in", "tp_bias", "cut":
    the parameters cut, their dims and whether GEGLU's halves are cut
    one by one}), plus
    "__partial__": the tensor-partial parameters and "__heads__":
    {attention name: local heads} of the attentions that run at local
    heads. Needs only the parameters' shapes (a module on the meta device
    will do) and ``mesh.shape``; raises ValueError where a split parameter
    has no tensor-parallel execution."""
    split = param_sharding_rules(module, mesh, min_size)
    # vdx's rule shards a column-split module's bias also where its kernel
    # stays whole (under min_size); that layer runs whole on every rank, so
    # its bias stays whole too (ROADMAP F22)
    for k, d in split.items():
        if d is not None and k.endswith(".bias") \
                and split.get(k[:-len("bias")] + "weight", 0) is None:
            split[k] = None
    n = mesh.shape[AXIS]
    plan: Dict[str, dict] = {}
    partial, heads = set(), {}
    if n == 1:
        return {"__partial__": partial, "__heads__": heads}

    def key(mname: str, leaf: str) -> str:
        return f"{mname}.{leaf}" if mname else leaf

    def add(mname, layer, kind, *, gather=True, local_in=False, halves=False):
        has_bias = getattr(layer, "bias", None) is not None
        b_split = has_bias and split.get(key(mname, "bias")) is not None
        bias = None
        if kind == "out" and has_bias:
            if not (b_split or gather):
                raise ValueError(f"{mname}: a replicated bias on an output "
                                 "that stays split")
            bias = "shard" if b_split else "full"
        cut = {key(mname, "weight"): (split[key(mname, "weight")], halves)}
        if b_split:
            cut[key(mname, "bias")] = (0, halves)
        plan[mname] = dict(tp_split=kind, tp_gather=gather, tp_local_in=local_in,
                           tp_bias=bias, cut=cut)

    mods = dict(module.named_modules())
    for mname, m in mods.items():
        if isinstance(m, Attention):
            qkv = [split.get(key(mname, f"{p}.weight")) for p in ("to_q", "to_k", "to_v")]
            if (qkv == [0, 0, 0] and m.heads % n == 0
                    and split.get(key(mname, "to_out.0.weight")) == 1):
                for p in ("to_q", "to_k", "to_v"):
                    add(key(mname, p), getattr(m, p), "out", gather=False)
                add(key(mname, "to_out.0"), m.to_out[0], "row", local_in=True)
                heads[mname] = m.heads // n
                for norm in ("norm_q", "norm_k"):
                    if getattr(m, norm) is not None:
                        partial.update(key(mname, f"{norm}.{leaf}")
                                       for leaf, _ in getattr(m, norm).named_parameters())
        elif isinstance(m, (FeedForward, GELUFeedForward)):
            geglu = isinstance(m.net[0], GEGLU)
            if (split.get(key(mname, "net.0.proj.weight")) == 0
                    and split.get(key(mname, "net.2.weight")) == 1
                    and (not geglu or m.net[2].in_features % n == 0)):
                add(key(mname, "net.0.proj"), m.net[0].proj, "out", gather=False,
                    halves=geglu)
                add(key(mname, "net.2"), m.net[2], "row", local_in=True)
    for mname, m in mods.items():
        if mname in plan or type(m) not in _TP_CLASS:
            continue
        w_dim = split.get(key(mname, "weight"))
        if w_dim == 0:
            add(mname, m, "out")
        elif w_dim == 1 and type(m) is Dense:
            add(mname, m, "row")
        elif w_dim is not None:
            raise ValueError(f"no tensor-parallel execution for {mname}.weight "
                             f"split on dim {w_dim} ({type(m).__name__})")
    cut = {k for v in plan.values() for k in v["cut"]}
    unhandled = [k for k, d in split.items() if d is not None and k not in cut]
    if unhandled:
        raise ValueError(f"no tensor-parallel execution for split parameters "
                         f"{unhandled[:5]}")
    plan["__partial__"], plan["__heads__"] = partial, heads
    return plan


def tensor_parallel(module: nn.Module, mesh: Mesh, *,
                    min_size: int = 2**16) -> nn.Module:
    """Cut ``module`` (a denoiser holding its full weights) into this
    rank's tensor-parallel shards by vdx's rule
    (:func:`~vdx_torch.parallel.mesh.param_sharding_rules` at
    ``min_size``) as :func:`plan_tensor_parallel` lays them out, in place,
    and return it. Sets ``module.tp_layout`` ({parameter: (dim, halves)}
    of every split parameter) and ``module.tp_partial`` (replicated
    parameters whose gradient each rank holds a part of). The module runs
    inside ``with mesh.bind():``. At ``tensor`` == 1 nothing is split and
    the module runs as it was."""
    plan = plan_tensor_parallel(module, mesh, min_size=min_size)
    module.tp_partial = plan.pop("__partial__")
    heads = plan.pop("__heads__")
    module.tp_layout = {k: v for m in plan.values() for k, v in m["cut"].items()}
    if not plan:
        return module
    n = mesh.shape[AXIS]
    with mesh.bind():
        i = axis_index(AXIS)
    mods = dict(module.named_modules())
    for mname, h in heads.items():
        mods[mname].heads = h
    for mname, mode in plan.items():
        layer = mods[mname]
        for k, (dim, halves) in mode["cut"].items():
            leaf = k.rsplit(".", 1)[-1]
            p = getattr(layer, leaf)
            t = _chunk(p.detach(), dim, n, i, halves).clone()
            if t.is_cuda and t.dim() in (4, 5):
                t = t.contiguous(memory_format=torch.channels_last if t.dim() == 4
                                 else torch.channels_last_3d)
            setattr(layer, leaf, nn.Parameter(t, requires_grad=p.requires_grad))
        layer.__class__ = _TP_CLASS[type(layer)]
        for k, v in mode.items():
            if k != "cut":
                setattr(layer, k, v)
    return module


@torch.no_grad()
def gather_state_dict(module: nn.Module, mesh: Mesh) -> dict:
    """The full state dict of a :func:`tensor_parallel` module cut over
    ``mesh`` (every shard all-gathered over the axis, GEGLU's halves put
    back), on every rank; the module's own state dict where nothing is
    split."""
    layout = getattr(module, "tp_layout", {})
    state = module.state_dict()
    if not layout:
        return state
    with mesh.bind():
        ax = _axis(AXIS)
        out = {}
        for k, t in state.items():
            if k not in layout:
                out[k] = t
                continue
            dim, halves = layout[k]
            parts = _all_gather_raw(t.contiguous(), ax, dim).chunk(ax.size, dim)
            if halves:
                pairs = [p.chunk(2, dim) for p in parts]
                parts = [a for a, _ in pairs] + [b for _, b in pairs]
            out[k] = torch.cat(parts, dim)
    return out
