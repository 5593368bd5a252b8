"""DDIM sampler as pure functions (port of vdx/schedulers/ddim.py).

SD-1.5 DDIM: linear betas, steps_offset=1, clip_sample=False, leading
spacing, set_alpha_to_one=False, eta=0. :func:`make_tables` precomputes
per-step (alpha_prod_t, alpha_prod_prev); :func:`step` indexes them by the
step number.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vdx_torch.schedulers.common import (
    ScheduleConfig,
    make_alphas_cumprod,
    pred_x0_and_eps,
    timesteps_leading,
    timesteps_linspace,
    timesteps_trailing,
)


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    schedule: ScheduleConfig = ScheduleConfig()
    steps_offset: int = 1
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = False
    thresholding: bool = False
    timestep_spacing: str = "leading"  # "leading" | "trailing" | "linspace"


class DDIMTables(NamedTuple):
    """Per-step constants for an N-step DDIM run, shape [N]."""

    timesteps: torch.Tensor  # int32 — the train-time t fed to the model
    alpha_prod_t: torch.Tensor  # fp32
    alpha_prod_prev: torch.Tensor  # fp32
    init_noise_sigma: float


def make_tables(num_inference_steps: int, cfg: DDIMConfig = DDIMConfig(),
                device="cpu") -> DDIMTables:
    T = cfg.schedule.num_train_timesteps
    acp = make_alphas_cumprod(cfg.schedule)
    if cfg.timestep_spacing == "leading":
        ts = timesteps_leading(T, num_inference_steps, cfg.steps_offset)
    elif cfg.timestep_spacing == "trailing":
        ts = timesteps_trailing(T, num_inference_steps)
    elif cfg.timestep_spacing == "linspace":
        ts = timesteps_linspace(T, num_inference_steps)
    else:
        raise ValueError(f"unknown timestep_spacing: {cfg.timestep_spacing}")
    ts = np.clip(ts, 0, T - 1)
    prev_ts = ts - T // num_inference_steps
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(acp[0])
    a_t = acp[ts]
    a_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, T - 1)], final_alpha)
    return DDIMTables(
        timesteps=torch.as_tensor(ts, dtype=torch.int32, device=device),
        alpha_prod_t=torch.as_tensor(a_t, dtype=torch.float32, device=device),
        alpha_prod_prev=torch.as_tensor(np.asarray(a_prev, np.float32),
                                        dtype=torch.float32, device=device),
        init_noise_sigma=1.0,
    )


def step(sample: torch.Tensor, model_output: torch.Tensor, step_index: int,
         tables: DDIMTables, cfg: DDIMConfig = DDIMConfig()) -> torch.Tensor:
    """One deterministic (eta=0) DDIM update x_t -> x_{t-1}; step 0 is the
    most-noised step."""
    a_t = tables.alpha_prod_t[step_index]
    a_prev = tables.alpha_prod_prev[step_index]
    x0, eps = pred_x0_and_eps(sample.float(), model_output.float(), a_t,
                              cfg.schedule.prediction_type)
    if cfg.clip_sample:
        x0 = torch.clamp(x0, -cfg.clip_sample_range, cfg.clip_sample_range)
    prev_sample = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    return prev_sample.to(sample.dtype)


def scale_model_input(sample: torch.Tensor, step_index,
                      tables: DDIMTables) -> torch.Tensor:
    """DDIM applies no input scaling (identity, for a uniform sampler API)."""
    del step_index, tables
    return sample
