"""Temporal context windows: clips longer than the motion module's trained
span (port of vdx/pipelines/context.py).

Each denoiser evaluation runs on overlapping fixed-length frame windows
and blends the per-window predictions (temporal MultiDiffusion), with
optional FreeNoise initial noise so that far-apart windows share content
(Qiu et al., "FreeNoise: Tuning-Free Longer Video Diffusion via Noise
Rescheduling", 2023).

* Every window evaluation has the shape of a trained-length call, so the
  kernels run at the main path's shapes.
* The blend is linear, in fp32, on the prediction (before the CFG combine
  and the sampler update): ``acc += eps * w`` and ``cnt += w`` window by
  window in start order, then ``acc / cnt``. Weights are frame-position
  triangles ("pyramid") by default.
* When one window covers the clip the wrapper is the identity, so the
  pipeline equals the context-free one bit for bit.
* Window parallelism (:func:`make_windowed_apply` with ``mesh``): over a
  mesh axis, each rank evaluates its round-robin share of the windows on the
  replicated latents and the blend is a psum, equal bit for bit to the
  sequential blend where no frame lies in more than two windows.

``window_evals`` counts the window evaluations of the sequential and the
window-parallel wrapper ("sequential", "sharded"; a dummy window counts
too), so a run can show which one ran.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from vdx_torch.core import rng

#: window evaluations by wrapper since the last reset
window_evals = {"sequential": 0, "sharded": 0}


@dataclasses.dataclass(frozen=True)
class ContextConfig:
    """Sliding-window schedule for long clips. ``frames`` should be the
    denoiser's trained temporal span (16 for AnimateDiff's motion
    adapter); ``stride`` < ``frames`` makes the windows overlap."""

    #: window length: the temporal span each denoiser call sees
    frames: int = 16
    #: hop between window starts; overlap = frames - stride
    stride: int = 8
    #: per-frame blend weights in a window: "pyramid" (triangular,
    #: center-weighted) or "uniform"
    weights: str = "pyramid"
    #: FreeNoise initial noise: frames past the first window reuse the
    #: base window's noise frames under per-block shuffles
    freenoise: bool = True

    def __post_init__(self):
        if self.frames < 2:
            raise ValueError("context frames must be >= 2")
        if not (0 < self.stride < self.frames):
            raise ValueError(
                "context stride must be in (0, frames) — windows must "
                "overlap to blend"
            )
        if self.weights not in ("pyramid", "uniform"):
            raise ValueError(f"unknown context weights {self.weights!r}")


def window_starts(total: int, frames: int, stride: int) -> tuple:
    """Window start offsets covering [0, total): hops of ``stride``, the
    last window pinned to ``total - frames`` if the last hop overshoots."""
    if total < frames:
        raise ValueError(f"num_frames={total} < context window {frames}")
    starts = list(range(0, total - frames + 1, stride))
    if starts[-1] != total - frames:
        starts.append(total - frames)
    return tuple(starts)


def window_weights(frames: int, mode: str) -> np.ndarray:
    """[frames] fp32 blend weights; only the profile matters (the blend
    divides by each frame's summed weight)."""
    if mode == "uniform":
        return np.ones((frames,), np.float32)
    half = (frames + 1) // 2
    ramp = np.arange(1, half + 1, dtype=np.float32)
    return np.concatenate([ramp, ramp[: frames - half][::-1]])


def make_windowed_apply(unet_apply: Callable, *, total_frames: int,
                        out_channels: int, cfg: ContextConfig, mesh=None,
                        axis: str = "frames") -> Callable:
    """Wrap ``unet_apply(x [B, F, H, W, Cin], t, *cond)`` so that each call
    runs it per overlapping window and returns the blended [B, F, H, W,
    out_channels] prediction in fp32; ``unet_apply`` itself when one
    window covers the clip. Conditioning after (x, t) passes through.

    ``mesh``: window-PARALLEL over its axis ``axis``, run by every rank on
    the same replicated latents (vdx's ``make_windowed_apply_sharded``).
    The window starts are padded to a multiple of the axis size with
    dummy windows at start 0 and weight 0 and laid out round-robin: rank
    ``idx`` takes row ``idx`` of the padded starts reshaped ``(n, -1)`` in
    Fortran order. Each rank accumulates ``acc += eps * w * valid`` and
    ``cnt += w * valid`` over its windows in that order, then ``acc`` and
    ``cnt`` are summed over the axis (one all_reduce) and the result is
    ``acc / cnt`` on every rank. A dummy window runs the denoiser and adds
    ``eps * 0`` (not 0 if eps is not finite, as vdx). With stride >=
    frames / 2 no frame lies in more than two windows, the other ranks add
    an exact +0.0, and a two-term fp32 sum is commutative, so the blend
    equals the sequential one (``mesh=None``: one rank, every window, no
    psum) bit for bit."""
    starts = window_starts(total_frames, cfg.frames, cfg.stride)
    if len(starts) == 1:
        return unet_apply
    from vdx_torch.parallel.mesh import axis_index, psum

    n = 1 if mesh is None else mesh.shape[axis]
    counter = "sequential" if mesh is None else "sharded"
    ctx = cfg.frames
    w_np = window_weights(ctx, cfg.weights)
    npad = (-len(starts)) % n
    starts_p = np.asarray(list(starts) + [0] * npad, np.int64).reshape(
        n, -1, order="F")
    valid_p = np.asarray([1.0] * len(starts) + [0.0] * npad,
                         np.float32).reshape(n, -1, order="F")
    w_on = {}  # device -> the weights there, uploaded once

    def blend(x, t, cond, idx):
        w = w_on.get(x.device)
        if w is None:
            w = w_on[x.device] = torch.from_numpy(w_np).to(x.device).view(
                1, ctx, 1, 1, 1)
        acc = torch.zeros(x.shape[:4] + (out_channels,), dtype=torch.float32,
                          device=x.device)
        cnt = torch.zeros((1, total_frames, 1, 1, 1), dtype=torch.float32,
                          device=x.device)
        for s, valid in zip(starts_p[idx].tolist(), valid_p[idx].tolist()):
            eps = unet_apply(x[:, s:s + ctx], t, *cond).float()
            window_evals[counter] += 1
            wv = w * valid
            acc[:, s:s + ctx] = acc[:, s:s + ctx] + eps * wv
            cnt[:, s:s + ctx] = cnt[:, s:s + ctx] + wv
        return acc, cnt

    def apply(x: torch.Tensor, t: torch.Tensor, *cond) -> torch.Tensor:
        if mesh is None:
            acc, cnt = blend(x, t, cond, 0)
        else:
            with mesh.bind():
                acc, cnt = psum(blend(x, t, cond, axis_index(axis)), axis)
        return acc / cnt

    return apply


def make_freenoise_maker(latent_shape: Sequence[int], ctx: int,
                         device) -> Callable:
    """FreeNoise initial noise with ``_noise_maker``'s contract: ``keys``
    holds one key per video (``rng.prng_key(seed)``) -> fp32
    [B, *latent_shape[1:]] on ``device``. Frames [0, ctx) draw fresh noise
    from the first key of a split; each later ctx-long block is the base
    block under a permutation drawn from the second key's chain
    (truncated at the clip's length)."""
    total = latent_shape[1]
    reps = math.ceil(total / ctx)
    base_shape = (ctx,) + tuple(latent_shape[2:])

    def per_video(key: tuple) -> torch.Tensor:
        k_base, k_perm = rng.split(key)
        base = rng.key_normal(k_base, base_shape, device)
        blocks = [base]
        for _ in range(1, reps):
            k_perm, k = rng.split(k_perm)
            blocks.append(base[rng.permutation(k, ctx).to(base.device)])
        return torch.cat(blocks)[:total]

    def make(keys: Sequence[tuple]) -> torch.Tensor:
        return torch.stack([per_video(k) for k in keys])

    return make
