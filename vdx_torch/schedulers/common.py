"""Shared diffusion-schedule math (port of vdx/schedulers/common.py).

SD-1.5 training schedule: 1000 train timesteps, beta_start=0.00085,
beta_end=0.012. Tables are built in numpy (float64, rounded to fp32 as
vdx does); the per-step math runs in fp32 on tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Training-time diffusion schedule (SD-1.5 defaults); see vdx's
    ScheduleConfig for the SNR-shift and zero-terminal-SNR knobs."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" | "sample"
    snr_shift_scale: float = 1.0
    rescale_zero_snr: bool = False


def make_betas(cfg: ScheduleConfig) -> np.ndarray:
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, T, dtype=np.float64)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(T, dtype=np.float64)
        betas = np.minimum(1.0 - alpha_bar((ts + 1) / T) / alpha_bar(ts / T), 0.999)
    else:
        raise ValueError(f"unknown beta_schedule: {cfg.beta_schedule}")
    return betas.astype(np.float32)


def make_alphas_cumprod(cfg: ScheduleConfig) -> np.ndarray:
    acp = np.cumprod(1.0 - make_betas(cfg).astype(np.float64))
    if cfg.snr_shift_scale != 1.0:
        s = float(cfg.snr_shift_scale)
        acp = acp / (s - (s - 1.0) * acp)
    if cfg.rescale_zero_snr:
        if cfg.prediction_type == "epsilon":
            raise ValueError(
                "rescale_zero_snr makes the terminal alphas_cumprod exactly 0; "
                "epsilon prediction divides x0 recovery by sqrt(acp) — use "
                "prediction_type='v_prediction' or 'sample'")
        sq = np.sqrt(acp)
        sq = (sq - sq[-1]) * (sq[0] / (sq[0] - sq[-1]))
        acp = sq ** 2
    return acp.astype(np.float32)


def timesteps_leading(num_train: int, num_steps: int,
                      steps_offset: int = 0) -> np.ndarray:
    """'leading' spacing: round(arange(n) * (T // n))[::-1] + steps_offset."""
    step_ratio = num_train // num_steps
    ts = (np.arange(0, num_steps) * step_ratio).round()[::-1].copy()
    return (ts + steps_offset).astype(np.int32)


def timesteps_linspace(num_train: int, num_steps: int) -> np.ndarray:
    """'linspace' spacing: linspace(0, T-1, n)[::-1]."""
    return (np.linspace(0, num_train - 1, num_steps, dtype=np.float64)[::-1]
            .round().astype(np.int32).copy())


def timesteps_trailing(num_train: int, num_steps: int) -> np.ndarray:
    """'trailing' spacing: round(T - i*T/n) - 1 for i in [0, n), built with
    an integer length (a float-step arange can emit n+1 entries)."""
    i = np.arange(num_steps, dtype=np.float64)
    return np.round(num_train - i * (num_train / num_steps)).astype(np.int32) - 1


def cfg_combine(uncond: torch.Tensor, cond: torch.Tensor, guidance_scale,
                guidance_rescale: float = 0.0) -> torch.Tensor:
    """``uncond + s * (cond - uncond)``, then for phi = guidance_rescale > 0
    the std rescale of Lin et al. (eq. 15-16): the guided output's
    per-sample std is matched to the cond branch's, blended by phi. Stats
    in fp32 over all non-batch axes."""
    guided = uncond + guidance_scale * (cond - uncond)
    if not guidance_rescale:
        return guided
    axes = tuple(range(1, guided.dim()))
    g32 = guided.float()
    std_cond = cond.float().std(dim=axes, keepdim=True, unbiased=False)
    std_g = g32.std(dim=axes, keepdim=True, unbiased=False)
    rescaled = g32 * (std_cond / torch.clamp_min(std_g, 1e-8))
    out = guidance_rescale * rescaled + (1.0 - guidance_rescale) * g32
    return out.to(guided.dtype)


def pred_x0_and_eps(sample: torch.Tensor, model_output: torch.Tensor,
                    alpha_prod_t: torch.Tensor,
                    prediction_type: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover (x0, eps) from a model output under each prediction type."""
    sqrt_a = torch.sqrt(alpha_prod_t)
    sqrt_1ma = torch.sqrt(1.0 - alpha_prod_t)
    if prediction_type == "epsilon":
        eps = model_output
        x0 = (sample - sqrt_1ma * eps) / sqrt_a
    elif prediction_type == "v_prediction":
        x0 = sqrt_a * sample - sqrt_1ma * model_output
        eps = sqrt_a * model_output + sqrt_1ma * sample
    elif prediction_type == "sample":
        x0 = model_output
        eps = (sample - sqrt_a * x0) / sqrt_1ma
    else:
        raise ValueError(f"unknown prediction_type: {prediction_type}")
    return x0, eps
