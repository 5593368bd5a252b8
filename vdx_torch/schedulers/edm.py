"""EDM (Karras) sampler, the SVD sampling formulation (port of
vdx/schedulers/edm.py).

  sigma grid: sigma_i = (smax^(1/rho) + i/(n-1) (smin^(1/rho) - smax^(1/rho)))^rho
  preconditioning (sigma_data = 1):
      c_skip = 1 / (sigma^2 + 1),  c_out = -sigma / sqrt(sigma^2 + 1),
      c_in = 1 / sqrt(sigma^2 + 1),  denoised = c_skip x + c_out F(c_in x, t)
  model timestep: t = 0.25 log(sigma) (continuous)
  deterministic Euler update on the sigma grid.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vdx_torch.schedulers.common import on_device


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    sigma_data: float = 1.0
    rho: float = 7.0


class EDMTables(NamedTuple):
    timesteps: torch.Tensor  # [N] continuous: 0.25 log(sigma)
    sigmas: torch.Tensor  # [N+1], the last 0
    init_noise_sigma: float


def make_tables(num_inference_steps: int, cfg: EDMConfig = EDMConfig(),
                device="cpu") -> EDMTables:
    n = num_inference_steps
    i = np.arange(n, dtype=np.float64)
    inv_rho = 1.0 / cfg.rho
    sigmas = (cfg.sigma_max ** inv_rho + i / max(n - 1, 1)
              * (cfg.sigma_min ** inv_rho - cfg.sigma_max ** inv_rho)) ** cfg.rho
    ts = 0.25 * np.log(sigmas)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return on_device(EDMTables, device, timesteps=ts.astype(np.float32),
                     sigmas=sigmas, init_noise_sigma=float(sigmas[0]))


def scale_model_input(sample: torch.Tensor, step_index,
                      tables: EDMTables) -> torch.Tensor:
    """c_in scaling."""
    sigma = tables.sigmas[step_index]
    return (sample.float() / torch.sqrt(sigma ** 2 + 1.0)).to(sample.dtype)


def denoised_from_model_output(sample: torch.Tensor, model_output: torch.Tensor,
                               sigma, cfg: EDMConfig = EDMConfig()) -> torch.Tensor:
    """EDM skip/out combination; ``sample`` is the unscaled latent."""
    del cfg
    x = sample.float()
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
    return c_skip * x + c_out * model_output.float()


def step(sample: torch.Tensor, model_output: torch.Tensor, step_index,
         tables: EDMTables, cfg: EDMConfig = EDMConfig()) -> torch.Tensor:
    sigma = tables.sigmas[step_index]
    sigma_next = tables.sigmas[step_index + 1]
    x = sample.float()
    denoised = denoised_from_model_output(sample, model_output, sigma, cfg)
    d = (x - denoised) / sigma
    return (x + d * (sigma_next - sigma)).to(sample.dtype)


def add_noise_at(original: torch.Tensor, noise: torch.Tensor, step_index,
                 tables: EDMTables) -> torch.Tensor:
    """Clean latents diffused to the step_index-th sigma node, x + sigma n
    in fp32 (video2video; EDM latents live at natural scale)."""
    return original.float() + tables.sigmas[step_index] * noise.float()
