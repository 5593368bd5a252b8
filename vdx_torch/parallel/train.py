"""Diffusion training on one card (port of vdx/parallel/train.py): the
eps-prediction DDPM objective over the motion UNet, in full or through a
LoRA adapter.

The levers are vdx's, with vdx's arithmetic:

  * ``make_optimizer`` — global-norm clipping, then AdamW, with optax's
    schedules (linear warmup, cosine decay) and optax's step count: the
    update at count n uses lr(n), so under warmup the first update has
    lr 0. Clipping is optax's: g / norm * max_norm when norm >= max_norm,
    no epsilon. AdamW is optax's: eps after the square root, the decay
    wd * p added to the Adam direction before the learning rate, moments
    in the parameter dtype.
  * ``remat=True`` — ``torch.utils.checkpoint`` (non-reentrant) around the
    denoiser call: activations are recomputed in the backward.
  * ``grad_accum=k`` — the noise is drawn once for the whole batch, then
    k micro-batches run in turn, their gradients summed in fp32 and handed
    back in the parameter dtype: the accumulated gradient is the
    full-batch one.
  * ``ema_decay`` — an EMA of the parameters, computed in fp32 and cast
    back, carried in the TrainState.
  * :func:`make_mesh_train_step` — the same step over a (data, frames,
    tensor) mesh (vdx's multi-chip dry run, ``__graft_entry__.py``): the
    batch over (data, frames), the context over data, the parameters by
    ``param_sharding_rules`` (parallel/tensor_parallel.py), the frames
    axis through the frame-sharded denoiser under grad.

Noise and timesteps come from ``core/rng.py``'s threefry port, so a key
gives vdx's t and noise (bf16 latents draw JAX's bf16 normals).

The step differentiates through the hand-written kernels: on the card
every K1 site and every GroupNorm runs its kernel forward and its plain
version's VJP backward (``kernels.flash_attention.FlashAttentionDtFn``,
``ops.groupnorm.GroupNormFn``). The optimizer works in place on the
module's parameters, which the module keeps owning; the TrainState holds
the step count, the optimizer's moments and the EMA tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from vdx_torch.core import rng
from vdx_torch.schedulers.common import ScheduleConfig, make_alphas_cumprod

Schedule = Callable[[int], float]
# optax.adamw's epsilon, added after the square root (vdx never sets it)
ADAM_EPS = 1e-8


# ----------------------------------------------------------------------
# optax's schedules (count -> learning rate), in float64
# ----------------------------------------------------------------------
def constant_schedule(value: float) -> Schedule:
    return lambda count: float(value)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``transition_steps``
    counts, then end (constant init when transition_steps <= 0)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule with exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        cos = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps)
                                    / decay_steps))
        return init_value * ((1.0 - alpha) * cos + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear init -> peak for
    ``warmup_steps`` counts, then cosine decay over the remaining
    ``decay_steps - warmup_steps`` to ``end_value``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


# ----------------------------------------------------------------------
# the optimizer: clip-by-global-norm -> AdamW, optax's arithmetic
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1, b2,
    weight_decay=...)), or plain adamw when ``clip_norm`` is None.
    ``init`` makes the state of a {name: tensor} dict of parameters;
    ``update`` applies one step to them in place."""

    schedule: Schedule
    clip_norm: Optional[float] = None
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor],
               norm: Optional[torch.Tensor] = None) -> dict:
        """One update of ``params`` (in place) from ``grads`` (same keys,
        the parameters' dtypes); -> the new state. ``norm``: the
        gradients' global norm where this rank holds shards of them (the
        mesh step's :func:`mesh_global_norm`), else computed here."""
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm, norm)
        count = state["count"] + 1
        # optax: 1 - decay ** count in fp32, then in the moment's dtype
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        lr = self.schedule(state["count"])
        mus, nus = {}, {}
        for n, p in params.items():
            g = grads[n]
            mu = (1.0 - self.b1) * g + self.b1 * state["mu"][n]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"][n]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            u = u + self.weight_decay * p
            p.copy_((p + (-lr) * u).to(p.dtype))
            mus[n], nus[n] = mu, nu
        return {"count": count, "mu": mus, "nu": nus}


def _sum_squares(grads) -> torch.Tensor:
    total = None
    for g in grads:
        s = (g * g).sum()
        total = s if total is None else total + s
    return total


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves of each leaf's sum
    of squares (each sum in the leaf's dtype)."""
    return torch.sqrt(_sum_squares(grads.values()))


def mesh_global_norm(grads: Dict[str, torch.Tensor], sharded) -> torch.Tensor:
    """:func:`global_norm` of gradients of which this rank holds the
    ``sharded`` leaves' shards over the tensor axis (inside the mesh's
    binding): a sharded leaf's squares count across its shards (a psum),
    a replicated leaf's once."""
    from vdx_torch.parallel.mesh import psum

    total = _sum_squares(g for n, g in grads.items() if n not in sharded)
    part = _sum_squares(g.float() for n, g in grads.items() if n in sharded)
    if part is not None:
        part = psum(part, "tensor")
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """optax.clip_by_global_norm: the gradients as they are when their
    global norm (``norm``, or computed here) is below ``max_norm``, else
    each (g / norm) * max_norm in g's dtype; no epsilon
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6)."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    return {n: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for n, g in grads.items()}


def make_optimizer(learning_rate: float = 1e-4, *, warmup_steps: int = 0,
                   total_steps: int = 0, clip_norm: float = 1.0,
                   weight_decay: float = 1e-2, b1: float = 0.9,
                   b2: float = 0.999) -> AdamW:
    """Clip-by-global-norm -> AdamW, with linear warmup + cosine decay
    when ``total_steps`` > 0, linear warmup alone when only
    ``warmup_steps`` > 0, constant otherwise (vdx's recipe)."""
    if total_steps > 0:
        lr = warmup_cosine_decay_schedule(0.0, learning_rate,
                                          max(warmup_steps, 1), total_steps)
    elif warmup_steps > 0:
        lr = linear_schedule(0.0, learning_rate, warmup_steps)
    else:
        lr = constant_schedule(learning_rate)
    return AdamW(lr, clip_norm=clip_norm, weight_decay=weight_decay, b1=b1,
                 b2=b2)


# ----------------------------------------------------------------------
# the train state and steps
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TrainState:
    """The trained tensors by name (the module's own parameters for a
    full step, updated in place; the flat adapter for LoRA), the
    optimizer's state, the step count, and the EMA tensors when
    ``ema_decay`` is set."""

    params: Dict[str, torch.Tensor]
    opt_state: dict
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def init_train_state(model: torch.nn.Module,
                     params: Optional[Dict[str, torch.Tensor]] = None,
                     learning_rate: float = 1e-4,
                     optimizer: Optional[AdamW] = None,
                     ema: bool = False):
    """-> (TrainState, optimizer) over ``params`` (default: the model's
    parameters, which the step then updates in place). The default
    optimizer is plain AdamW (optax.adamw's defaults); ``ema=True`` seeds
    the EMA with a copy of the parameters."""
    if params is None:
        params = dict(model.named_parameters())
    if optimizer is None:
        optimizer = AdamW(constant_schedule(learning_rate))
    ema_params = ({n: p.detach().clone() for n, p in params.items()}
                  if ema else None)
    return TrainState(params, optimizer.init(params), 0, ema_params), optimizer


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def draw(acp: torch.Tensor, T: int, key, latents: torch.Tensor):
    """(noisy, t, noise) for the whole batch from ``key`` (vdx's draw):
    t ~ randint(0, T), noise ~ normal in the latents' dtype."""
    B = latents.shape[0]
    rt, rn = rng.split(_as_key(key))
    t = rng.randint(rt, (B,), 0, T, device=latents.device)
    noise = rng.key_normal(rn, latents.shape, latents.device,
                           dtype=latents.dtype)
    a = acp[t.long()].reshape((B,) + (1,) * (latents.dim() - 1))
    noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
    return noisy, t, noise


def _as_key(key) -> rng.PRNGKey:
    return key if isinstance(key, rng.PRNGKey) else rng.prng_key(int(key))


def _mse(pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - noise.float()) ** 2)


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]) -> dict:
    """d loss / d params, zeros where a parameter takes no part (as JAX)."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), got)}


@torch.no_grad()
def _ema_update(ema: Optional[Dict[str, torch.Tensor]],
                params: Dict[str, torch.Tensor],
                ema_decay: Optional[float]) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA after a step: d * ema + (1 - d) * params in fp32, cast back
    to each EMA leaf's dtype; ``ema`` as it is when ``ema_decay`` is None."""
    if ema_decay is None:
        return ema
    if ema is None:
        raise ValueError("ema_decay set but state.ema_params is None: build "
                         "the state with init_train_state(..., ema=True)")
    d = torch.tensor(ema_decay, dtype=torch.float32)
    return {n: (d * e.float() + (1.0 - d) * params[n].float()).to(e.dtype)
            for n, e in ema.items()}


def make_train_step(model: torch.nn.Module, optimizer: AdamW,
                    schedule: ScheduleConfig = ScheduleConfig(),
                    with_grad_stats: bool = False, remat: bool = False,
                    grad_accum: int = 1, ema_decay: Optional[float] = None,
                    return_grads: bool = False):
    """-> train_step(state, batch, key) -> (state, metrics).

    batch: {"latents": [B, F, h, w, C] clean latents, "context": [B, S, D]};
    key: an ``rng.PRNGKey`` (or an int seed). metrics["loss"] is a 0-d
    fp32 tensor (no host sync); ``with_grad_stats`` adds
    metrics["grad_absmax"], {name: max |grad|}. ``remat`` recomputes the
    denoiser forward in the backward; ``grad_accum`` = k splits B into k
    micro-batches (B % k == 0); ``ema_decay`` = d needs a state built with
    ``init_train_state(..., ema=True)``; ``return_grads`` adds
    metrics["grads"], the gradients the optimizer took."""
    device = _model_device(model)
    acp = torch.as_tensor(make_alphas_cumprod(schedule), device=device)
    T = schedule.num_train_timesteps

    def apply(noisy, t, context):
        if remat:
            return checkpoint(model, noisy, t, context, use_reentrant=False)
        return model(noisy, t, context)

    def value_and_grad(params, noisy, t, noise, context):
        loss = _mse(apply(noisy, t, context), noise)
        return loss.detach(), _grads(loss, params)

    def accum_grads(params, noisy, t, noise, context):
        B = noisy.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} must divide into grad_accum="
                             f"{grad_accum} micro-batches")
        m = B // grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        sums = {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
                for n, p in params.items()}
        for i in range(grad_accum):
            sl = slice(i * m, (i + 1) * m)
            loss, grads = value_and_grad(params, noisy[sl], t[sl], noise[sl],
                                         context[sl])
            loss_sum = loss_sum + loss
            for n, g in grads.items():
                sums[n] += g
            del grads
        k = torch.tensor(float(grad_accum), dtype=torch.float32)
        # fp32 sums, handed back in the parameters' dtypes (the optimizer
        # state keeps its dtypes, as vdx's)
        return loss_sum / k, {n: (s / k).to(params[n].dtype)
                              for n, s in sums.items()}

    def train_step(state: TrainState, batch: dict, key):
        noisy, t, noise = draw(acp, T, key, batch["latents"])
        if grad_accum > 1:
            loss, grads = accum_grads(state.params, noisy, t, noise,
                                      batch["context"])
        else:
            loss, grads = value_and_grad(state.params, noisy, t, noise,
                                         batch["context"])
        metrics = {"loss": loss}
        if with_grad_stats:
            metrics["grad_absmax"] = {n: g.abs().max() for n, g in grads.items()}
        if return_grads:
            metrics["grads"] = grads
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        del grads
        ema = _ema_update(state.ema_params, state.params, ema_decay)
        return TrainState(state.params, opt_state, state.step + 1, ema), metrics

    return train_step


def flatten_adapter(lora: dict) -> Dict[str, torch.Tensor]:
    """{site: {"a", "b"}} -> {"site#a": a, "site#b": b}, the leaves the
    optimizer steps."""
    return {f"{p}#{w}": site[w] for p, site in lora.items() for w in ("a", "b")}


def unflatten_adapter(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for name, t in flat.items():
        p, w = name.rsplit("#", 1)
        out.setdefault(p, {})[w] = t
    return out


def make_lora_train_step(model: torch.nn.Module, optimizer: AdamW,
                         schedule: ScheduleConfig = ScheduleConfig(),
                         remat: bool = False):
    """LoRA fine-tuning (vdx's ``make_lora_train_step``): only the adapter
    is trained, the base stays frozen. -> step(state, batch, key) ->
    (state, metrics), where ``state.params`` is
    ``flatten_adapter(init_lora(...))`` with leaves that require grad.
    Each step merges W + (a @ b)^T with ``core.lora.merge_lora`` and runs
    the model on the merged weights through
    ``torch.func.functional_call``; the module's own weights are never
    written. Same objective and draw as :func:`make_train_step`."""
    from torch.func import functional_call

    from vdx_torch.core.lora import merge_lora

    device = _model_device(model)
    acp = torch.as_tensor(make_alphas_cumprod(schedule), device=device)
    T = schedule.num_train_timesteps
    base = {n: p.detach() for n, p in model.named_parameters()}

    def step(state: TrainState, batch: dict, key):
        for leaf in state.params.values():
            leaf.requires_grad_(True)
        noisy, t, noise = draw(acp, T, key, batch["latents"])
        merged = merge_lora(base, unflatten_adapter(state.params), 1.0)
        weights = {**base, **merged}

        def run(x, tt, ctx):
            return functional_call(model, weights, (x, tt, ctx))

        args = (noisy, t, batch["context"])
        pred = (checkpoint(run, *args, use_reentrant=False) if remat
                else run(*args))
        loss = _mse(pred, noise)
        grads = _grads(loss, state.params)
        del merged, weights, pred
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        return (TrainState(state.params, opt_state, state.step + 1,
                           state.ema_params), {"loss": loss.detach()})

    return step


# ----------------------------------------------------------------------
# the step over a mesh
# ----------------------------------------------------------------------
_BUCKET = 1 << 26  # elements an all_reduce of gradients carries at most


def _psum_buckets(grads: Dict[str, torch.Tensor], names, axis_name: str) -> None:
    """Sum the fp32 gradients ``names`` over the axis in place, in buckets
    of at most _BUCKET elements (one all_reduce each)."""
    from vdx_torch.parallel.mesh import psum

    bucket, size = [], 0
    for n in list(names) + [None]:
        if n is not None:
            bucket.append(n)
            size += grads[n].numel()
        if bucket and (n is None or size >= _BUCKET):
            for k, g in zip(bucket, psum(tuple(grads[k] for k in bucket), axis_name)):
                grads[k] = g
            bucket, size = [], 0


def make_mesh_train_step(model: torch.nn.Module, optimizer: AdamW, mesh,
                         schedule: ScheduleConfig = ScheduleConfig(), *,
                         remat: bool = False, grad_accum: int = 1,
                         ema_decay: Optional[float] = None,
                         return_grads: bool = False):
    """:func:`make_train_step` over ``mesh`` (every rank calls it, SPMD):
    -> train_step(state, batch, key) -> (state, metrics).

    ``model``: the denoiser, tensor-parallel (``tensor_parallel``) where
    the mesh has a tensor axis; ``state``: ``init_train_state(model)``
    over its parameters, this rank's shards. ``batch["latents"]`` [B, F,
    h, w, C] lies over (data, frames) and ``batch["context"]`` over data
    (vdx's ``P("data", "frames")`` and ``P("data")``): DTensors from
    ``prefetch_to_device(sharding=...)``, or global tensors that every
    rank holds and cuts.

    Every rank draws the global t and noise from ``key`` (the
    single-device draw) and takes its slice; the denoiser runs on this
    rank's frames in its frame-sharded mode (``temporal_impl``
    "ulysses:frames", as ``frame_parallel.make_frame_sharded_denoiser``
    runs it by default, without that apply's final all_gather), under
    grad. The loss is the local squared
    error over the global element count, summed over data and frames: the
    global mean once. Each gradient is summed over data and frames (and
    the tensor-partial ones over tensor); the clip uses the global norm
    (:func:`mesh_global_norm`); AdamW and the EMA run on each shard.
    ``remat``, ``grad_accum`` (the local batch splits into k micro-batches)
    and ``ema_decay`` are the single-card step's. ``return_grads`` adds
    metrics["grads"], the reduced gradients (this rank's shards)."""
    from vdx_torch.parallel.mesh import (axis_index, axis_size, batch_sharding,
                                         local_slices, psum, video_sharding)

    device = _model_device(model)
    acp = torch.as_tensor(make_alphas_cumprod(schedule), device=device)
    T = schedule.num_train_timesteps
    impl = "ulysses:frames"
    sharded = set(getattr(model, "tp_layout", {}))
    partial = set(getattr(model, "tp_partial", ()))
    layouts = {"latents": video_sharding(mesh), "context": batch_sharding(mesh)}

    def local(name, x):
        """-> (this rank's shard on the model's device, the global shape)."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return x.to_local().to(device), tuple(x.shape)
        x = torch.as_tensor(x)
        sl = local_slices(layouts[name], x.shape,
                          mesh.device_mesh.get_coordinate())
        return x[sl].to(device), tuple(x.shape)

    def run(noisy, t, context):
        with mesh.bind():  # also where remat recomputes (autograd's thread)
            return model(noisy, t, context, temporal_impl=impl)

    def apply(noisy, t, context):
        if remat:
            return checkpoint(run, noisy, t, context, use_reentrant=False)
        return run(noisy, t, context)

    def train_step(state: TrainState, batch: dict, key):
        latents, shape = local("latents", batch["latents"])
        context, _ = local("context", batch["context"])
        params = state.params
        with mesh.bind():
            nd, nf = axis_size("data"), axis_size("frames")
            di, fi = axis_index("data"), axis_index("frames")
            B, F_ = shape[:2]
            Bl, Fl = B // nd, F_ // nf
            rt, rn = rng.split(_as_key(key))
            bs, fs = slice(di * Bl, (di + 1) * Bl), slice(fi * Fl, (fi + 1) * Fl)
            t = rng.randint(rt, (B,), 0, T, device=device)[bs]
            noise = rng.key_normal(rn, shape, device, dtype=latents.dtype)[bs, fs]
            a = acp[t.long()].reshape((Bl,) + (1,) * (latents.dim() - 1))
            noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
            if Bl % grad_accum:
                raise ValueError(f"the local batch {Bl} must divide into "
                                 f"grad_accum={grad_accum} micro-batches")
            count = float(np.prod(shape))
            m = Bl // grad_accum
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            sums = {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
                    for n, p in params.items()}
            for i in range(grad_accum):
                sl = slice(i * m, (i + 1) * m)
                pred = apply(noisy[sl], t[sl], context[sl])
                loss = ((pred.float() - noise[sl].float()) ** 2).sum() / count
                grads = _grads(loss, params)
                loss_sum = loss_sum + loss.detach()
                for n, g in grads.items():
                    sums[n] += g
                del grads, pred, loss
            with torch.no_grad():
                for ax in ("data", "frames"):
                    _psum_buckets(sums, list(sums), ax)
                    loss_sum = psum(loss_sum, ax)
                _psum_buckets(sums, [n for n in sums if n in partial], "tensor")
                grads = {n: g.to(params[n].dtype) for n, g in sums.items()}
                del sums
                norm = (mesh_global_norm(grads, sharded)
                        if optimizer.clip_norm is not None else None)
            opt_state = optimizer.update(grads, state.opt_state, params, norm)
        metrics = {"loss": loss_sum}
        if return_grads:
            metrics["grads"] = grads
        del grads
        ema = _ema_update(state.ema_params, params, ema_decay)
        return TrainState(params, opt_state, state.step + 1, ema), metrics

    return train_step
