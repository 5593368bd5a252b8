"""Euler discrete sampler, Karras-style sigma formulation (port of
vdx/schedulers/euler.py).

The scheduler the reference baseline configures: EulerDiscreteScheduler
with linspace timestep spacing and linear betas. Sigmas are interpolated
onto the (fractional) timestep grid, the initial latents are scaled by the
largest sigma, the model input by 1/sqrt(sigma^2 + 1), and the update is
the deterministic Euler step (s_churn = 0).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vdx_torch.schedulers.common import (
    ScheduleConfig,
    make_alphas_cumprod,
    on_device,
)


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    schedule: ScheduleConfig = ScheduleConfig()
    timestep_spacing: str = "linspace"


class EulerTables(NamedTuple):
    """Per-step constants, shape [N] (sigmas has N+1, the last 0)."""

    timesteps: torch.Tensor  # fp32: Euler feeds fractional timesteps
    sigmas: torch.Tensor  # [N+1]
    init_noise_sigma: float


def make_tables(num_inference_steps: int, cfg: EulerConfig = EulerConfig(),
                device="cpu") -> EulerTables:
    T = cfg.schedule.num_train_timesteps
    acp = make_alphas_cumprod(cfg.schedule).astype(np.float64)
    sigmas_train = np.sqrt((1.0 - acp) / acp)

    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps,
                         dtype=np.float64)[::-1].copy()
    elif cfg.timestep_spacing == "leading":
        step_ratio = T // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy() + 1
    elif cfg.timestep_spacing == "trailing":
        step_ratio = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -step_ratio)).astype(np.float64) - 1
    else:
        raise ValueError(cfg.timestep_spacing)

    sigmas = np.interp(ts, np.arange(0, T), sigmas_train)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)

    max_sigma = float(sigmas.max())
    if cfg.timestep_spacing in ("linspace", "trailing"):
        init_noise_sigma = max_sigma
    else:
        init_noise_sigma = float((max_sigma ** 2 + 1.0) ** 0.5)
    return on_device(EulerTables, device, timesteps=ts.astype(np.float32),
                     sigmas=sigmas, init_noise_sigma=init_noise_sigma)


def scale_model_input(sample: torch.Tensor, step_index,
                      tables: EulerTables) -> torch.Tensor:
    sigma = tables.sigmas[step_index]
    return (sample.float() / torch.sqrt(sigma ** 2 + 1.0)).to(sample.dtype)


def step(sample: torch.Tensor, model_output: torch.Tensor, step_index,
         tables: EulerTables, cfg: EulerConfig = EulerConfig()) -> torch.Tensor:
    """One deterministic Euler update along the sigma grid. ``sample`` is
    the unscaled latent; the model was fed ``scale_model_input(sample)``."""
    sigma = tables.sigmas[step_index]
    sigma_next = tables.sigmas[step_index + 1]
    sample32 = sample.float()
    out32 = model_output.float()

    pred = cfg.schedule.prediction_type
    if pred == "epsilon":
        denoised = sample32 - sigma * out32
    elif pred == "v_prediction":
        denoised = sample32 * (1.0 / (sigma ** 2 + 1.0)) + out32 * (
            -sigma / torch.sqrt(sigma ** 2 + 1.0))
    elif pred == "sample":
        denoised = out32
    else:
        raise ValueError(pred)

    derivative = (sample32 - denoised) / sigma
    prev_sample = sample32 + derivative * (sigma_next - sigma)
    return prev_sample.to(sample.dtype)


def add_noise_at(original: torch.Tensor, noise: torch.Tensor, step_index,
                 tables: EulerTables) -> torch.Tensor:
    """Clean latents diffused to the step_index-th sigma node, x + sigma n
    in fp32 (the video2video entry point: the trajectory continues from
    that node as if it had been denoised down to it)."""
    return original.float() + tables.sigmas[step_index] * noise.float()
