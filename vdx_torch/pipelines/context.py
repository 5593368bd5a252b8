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

Window parallelism over several devices (vdx's
``make_windowed_apply_sharded``) comes with the next slice of the port
(ROADMAP Queue 1 item 14, step 7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from vdx_torch.core import rng


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
                        out_channels: int, cfg: ContextConfig) -> Callable:
    """Wrap ``unet_apply(x [B, F, H, W, Cin], t, *cond)`` so that each call
    runs it per overlapping window and returns the blended [B, F, H, W,
    out_channels] prediction in fp32; ``unet_apply`` itself when one
    window covers the clip. Conditioning after (x, t) passes through."""
    starts = window_starts(total_frames, cfg.frames, cfg.stride)
    if len(starts) == 1:
        return unet_apply
    ctx = cfg.frames
    w_np = window_weights(ctx, cfg.weights)
    w_on = {}  # device -> the weights there, uploaded once

    def apply(x: torch.Tensor, t: torch.Tensor, *cond) -> torch.Tensor:
        w = w_on.get(x.device)
        if w is None:
            w = w_on[x.device] = torch.from_numpy(w_np).to(x.device).view(
                1, ctx, 1, 1, 1)
        acc = torch.zeros(x.shape[:4] + (out_channels,), dtype=torch.float32,
                          device=x.device)
        cnt = torch.zeros((1, total_frames, 1, 1, 1), dtype=torch.float32,
                          device=x.device)
        for s in starts:
            eps = unet_apply(x[:, s:s + ctx], t, *cond).float()
            acc[:, s:s + ctx] = acc[:, s:s + ctx] + eps * w
            cnt[:, s:s + ctx] = cnt[:, s:s + ctx] + w
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
