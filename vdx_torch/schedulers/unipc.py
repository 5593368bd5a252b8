"""UniPC (unified predictor-corrector), order 2, x0 prediction (port of
vdx/schedulers/unipc.py).

The exponential-integrator family of DPM-Solver++(2M) (schedulers/dpm.py,
whose tables it uses) with the B(h) = expm1(h) slope weight ("bh2") and
the UniC corrector: each model evaluation also refines the previous
transition, at no extra UNet call. The multistep state is
``(x0_prev, sample_prev)``, threaded through the denoise loop's carry.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from vdx_torch.schedulers import dpm
from vdx_torch.schedulers.common import ScheduleConfig, pred_x0_and_eps

IS_MULTISTEP = True


@dataclasses.dataclass(frozen=True)
class UniPCConfig:
    schedule: ScheduleConfig = ScheduleConfig()
    steps_offset: int = 1
    #: apply the UniC corrector to the previous transition on every eval
    corrector: bool = True


class UniPCState(NamedTuple):
    x0_prev: torch.Tensor
    sample_prev: torch.Tensor


def make_tables(num_inference_steps: int, cfg: UniPCConfig = UniPCConfig(),
                device="cpu") -> dpm.DPMTables:
    """The solver nodes of DPM-Solver++(2M) (the DDPM discrete grid)."""
    return dpm.make_tables(
        num_inference_steps,
        dpm.DPMConfig(schedule=cfg.schedule, steps_offset=cfg.steps_offset),
        device=device)


def scale_model_input(sample, step_index, tables):
    del step_index, tables
    return sample


def init_state(sample: torch.Tensor) -> UniPCState:
    return UniPCState(torch.zeros_like(sample), torch.zeros_like(sample))


def _order2_combine(x, x0, slope_term, i_from, i_to, tables):
    """The order-2 exponential-integrator combine for the transition
    node[i_from] -> node[i_to] (the appended terminal node is index N)."""
    lam_s, lam_t = tables.lam[i_from], tables.lam[i_to]
    h = lam_t - lam_s
    hh = -h
    hh_safe = torch.where(hh == 0, 1.0, hh)
    phi1 = torch.expm1(hh)  # expm1(-h); also B(h) for bh2
    b_h = torch.where(phi1 == 0, 1.0, phi1)
    rho = (phi1 / hh_safe - 1.0) / b_h
    sig_s = torch.where(tables.sigma_t[i_from] == 0, 1.0, tables.sigma_t[i_from])
    first = (tables.sigma_t[i_to] / sig_s) * x - tables.alpha_t[i_to] * phi1 * x0
    return first, first - tables.alpha_t[i_to] * phi1 * rho * slope_term


def step_multistep(sample: torch.Tensor, model_output: torch.Tensor,
                   step_index: int, state: UniPCState, tables: dpm.DPMTables,
                   cfg: UniPCConfig = UniPCConfig()
                   ) -> Tuple[torch.Tensor, UniPCState]:
    """One UniPC-2 update: correct the previous transition with the fresh
    model output (UniC), then predict the next node (UniP)."""
    i = step_index
    x = sample.float()
    x0, _ = pred_x0_and_eps(x, model_output.float(), tables.alpha_prod[i],
                            cfg.schedule.prediction_type)
    x0_prev, samp_prev = state.x0_prev, state.sample_prev
    is_first = i == 0

    if cfg.corrector and not is_first:
        # UniC for node[i-1] -> node[i]: slope from the two endpoint x0
        # estimates (r = 1)
        _, x = _order2_combine(samp_prev.float(), x0_prev, x0 - x0_prev,
                               i - 1, i, tables)

    # UniP for node[i] -> node[i+1]: slope extrapolated from history
    lam_prev = tables.lam[max(i - 1, 0)]
    h = tables.lam[i + 1] - tables.lam[i]
    r0 = (lam_prev - tables.lam[i]) / torch.where(h == 0, 1.0, h)
    d1 = (x0_prev - x0) / torch.where(r0 == 0, 1.0, r0)
    first, second = _order2_combine(x, x0, d1, i, i + 1, tables)
    # first order at step 0 and at the terminal node (sigma-value test, as
    # dpm.py)
    first_order = (tables.sigma_t[i + 1] < 5e-4) | is_first
    next_sample = torch.where(first_order, first, second)
    return next_sample.to(sample.dtype), UniPCState(x0, x.to(sample.dtype))


def step(sample, model_output, step_index, tables,
         cfg: UniPCConfig = UniPCConfig()):
    """Stateless first-order fallback (the uniform sampler API)."""
    out, _ = step_multistep(sample, model_output, step_index,
                            init_state(sample), tables,
                            dataclasses.replace(cfg, corrector=False))
    return out
