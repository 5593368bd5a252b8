"""DPM-Solver++(2M) on the EDM/Karras sigma grid (port of
vdx/schedulers/dpm_edm.py).

Variance-exploding form (x_t = x0 + sigma_t eps, lambda_t = -log sigma_t):

  x_{i+1} = (sigma_{i+1}/sigma_i) x_i + (1 - sigma_{i+1}/sigma_i) D_i
  D_i     = x0_i + (1 / 2 r_i) (x0_i - x0_{i-1}),  r_i = h_{i-1} / h_i

with x0_i the EDM-preconditioned denoised prediction. First order at step
0 (no history) and at the final step (sigma_N = 0).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vdx_torch.schedulers.edm import (  # noqa: F401  (the sampler surface)
    EDMConfig,
    EDMTables,
    denoised_from_model_output,
    make_tables,
    scale_model_input,
)

IS_MULTISTEP = True

_TINY = 1e-10


def init_state(sample: torch.Tensor) -> torch.Tensor:
    """Previous-x0 slot of the multistep carry (zeros before step 0)."""
    return torch.zeros_like(sample)


def step_multistep(sample: torch.Tensor, model_output: torch.Tensor,
                   step_index: int, prev_x0: torch.Tensor, tables: EDMTables,
                   cfg: EDMConfig = EDMConfig()
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DPM-Solver++(2M) update -> (next_sample, x0 for the next carry);
    ``sample`` is the unscaled latent."""
    i = step_index
    x = sample.float()
    sigma_prev = tables.sigmas[max(i - 1, 0)]
    sigma_cur = tables.sigmas[i]
    sigma_next = tables.sigmas[i + 1]

    x0 = denoised_from_model_output(sample, model_output, sigma_cur, cfg)

    ratio = sigma_next / torch.clamp_min(sigma_cur, _TINY)
    h = (torch.log(torch.clamp_min(sigma_cur, _TINY))
         - torch.log(torch.clamp_min(sigma_next, _TINY)))
    h_prev = (torch.log(torch.clamp_min(sigma_prev, _TINY))
              - torch.log(torch.clamp_min(sigma_cur, _TINY)))
    r = h_prev / torch.clamp_min(h, _TINY)

    d2 = x0 + (0.5 / torch.clamp_min(r, _TINY)) * (x0 - prev_x0)
    # first order at step 0 and at the terminal node (sigma_next == 0)
    first_order = (sigma_next <= 0.0) | (i == 0)
    d = torch.where(first_order, x0, d2)
    next_sample = ratio * x + (1.0 - ratio) * d
    return next_sample.to(sample.dtype), x0


def step(sample, model_output, step_index, tables, cfg: EDMConfig = EDMConfig()):
    """Stateless first-order fallback (the uniform sampler API)."""
    out, _ = step_multistep(sample, model_output, step_index,
                            torch.zeros_like(sample), tables, cfg)
    return out
