"""DPM-Solver++(2M) multistep sampler (port of vdx/schedulers/dpm.py).

Second order in log-SNR space on the DDPM discrete grid. The previous x0
prediction rides the denoise loop's carry (``init_state`` /
``step_multistep``); step 0 and the terminal step are first order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from vdx_torch.schedulers.common import (
    ScheduleConfig,
    make_alphas_cumprod,
    on_device,
    pred_x0_and_eps,
    timesteps_leading,
)

IS_MULTISTEP = True


@dataclasses.dataclass(frozen=True)
class DPMConfig:
    schedule: ScheduleConfig = ScheduleConfig()
    steps_offset: int = 1


class DPMTables(NamedTuple):
    timesteps: torch.Tensor  # [N] int32
    alpha_t: torch.Tensor  # [N+1] sqrt(alphas_cumprod) per solver node
    sigma_t: torch.Tensor  # [N+1] sqrt(1 - alphas_cumprod)
    lam: torch.Tensor  # [N+1] log(alpha / sigma)
    alpha_prod: torch.Tensor  # [N] alphas_cumprod at the model-facing t
    init_noise_sigma: float


def make_tables(num_inference_steps: int, cfg: DPMConfig = DPMConfig(),
                device="cpu") -> DPMTables:
    T = cfg.schedule.num_train_timesteps
    acp = make_alphas_cumprod(cfg.schedule).astype(np.float64)
    ts = np.clip(timesteps_leading(T, num_inference_steps, cfg.steps_offset),
                 0, T - 1)
    a_nodes = acp[ts]
    # terminal node: fully denoised, with a sigma floor keeping lambda finite
    a_full = np.concatenate([a_nodes, [1.0 - 1e-8]])
    alpha_t = np.sqrt(a_full)
    sigma_t = np.sqrt(1.0 - a_full)
    lam = np.log(alpha_t) - np.log(np.maximum(sigma_t, 1e-10))
    f32 = np.float32
    return on_device(DPMTables, device, timesteps=ts.astype(np.int32),
                     alpha_t=alpha_t.astype(f32), sigma_t=sigma_t.astype(f32),
                     lam=lam.astype(f32), alpha_prod=a_nodes.astype(f32),
                     init_noise_sigma=1.0)


def scale_model_input(sample: torch.Tensor, step_index,
                      tables: DPMTables) -> torch.Tensor:
    del step_index, tables
    return sample


def init_state(sample: torch.Tensor) -> torch.Tensor:
    """Previous-x0 slot of the multistep carry (zeros before step 0)."""
    return torch.zeros_like(sample)


def step_multistep(sample: torch.Tensor, model_output: torch.Tensor,
                   step_index: int, prev_x0: torch.Tensor, tables: DPMTables,
                   cfg: DPMConfig = DPMConfig()
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DPM-Solver++(2M) update -> (next_sample, x0 for the next carry)."""
    i = step_index
    sample32 = sample.float()
    out32 = model_output.float()
    x0, _ = pred_x0_and_eps(sample32, out32, tables.alpha_prod[i],
                            cfg.schedule.prediction_type)

    lam_s, lam_t = tables.lam[i], tables.lam[i + 1]
    alpha_next, sigma_next = tables.alpha_t[i + 1], tables.sigma_t[i + 1]
    sigma_cur = tables.sigma_t[i]
    h = lam_t - lam_s

    first = (sigma_next / sigma_cur) * sample32 - alpha_next * torch.expm1(-h) * x0
    lam_prev = tables.lam[max(i - 1, 0)]
    h_prev = lam_s - lam_prev
    r = h_prev / torch.where(h == 0, 1.0, h)
    d = torch.where(r == 0, 0.0, 1.0 / torch.clamp_min(r, 1e-10))
    x0_bar = x0 + 0.5 * d * (x0 - prev_x0)
    second = (sigma_next / sigma_cur) * sample32 - alpha_next * torch.expm1(-h) * x0_bar

    # lower_order_final: first order at step 0 and at the terminal node,
    # found by its sigma value (every real schedule sigma is >= 0.01)
    first_order = (sigma_next < 5e-4) | (i == 0)
    next_sample = torch.where(first_order, first, second)
    return next_sample.to(sample.dtype), x0


def step(sample, model_output, step_index, tables, cfg: DPMConfig = DPMConfig()):
    """Stateless first-order fallback (the uniform sampler API)."""
    out, _ = step_multistep(sample, model_output, step_index,
                            torch.zeros_like(sample), tables, cfg)
    return out
