"""Samplers as pure function namespaces (port of vdx/schedulers/__init__.py).

Uniform surface per sampler module:
  make_tables(num_inference_steps, cfg, device) -> Tables (NamedTuple of
      tensors on ``device``)
  scale_model_input(sample, step_index, tables) -> sample fed to the model
  step(sample, model_output, step_index, tables, cfg) -> next sample
plus ``tables.timesteps`` (the model-facing t per step) and
``tables.init_noise_sigma`` (initial latent scale). Multistep samplers
(``IS_MULTISTEP``) add ``init_state`` and ``step_multistep``, whose state
rides the denoise loop's carry.
"""

from vdx_torch.schedulers import ddim, dpm, dpm_edm, edm, euler, unipc
from vdx_torch.schedulers.common import ScheduleConfig

_SAMPLERS = {
    "ddim": ddim,
    "euler": euler,
    "dpm": dpm,
    "dpmsolver++": dpm,
    "edm": edm,
    "dpm_edm": dpm_edm,
    "unipc": unipc,
}


def get_sampler(name: str):
    try:
        return _SAMPLERS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown sampler {name!r}; available: {sorted(_SAMPLERS)}"
        ) from None


def is_multistep(name: str) -> bool:
    """Whether the sampler threads a multistep state through the denoise
    loop's carry (``init_state`` / ``step_multistep``)."""
    return getattr(get_sampler(name), "IS_MULTISTEP", False)


def make_tables_for(name: str, num_steps: int, cfg=None, device="cpu"):
    """``make_tables`` honouring an optional config override (None = the
    sampler module's defaults, the SD-1.5 reference semantics), with the
    tables on ``device``."""
    sampler = get_sampler(name)
    if cfg is None:
        return sampler.make_tables(num_steps, device=device)
    return sampler.make_tables(num_steps, cfg, device=device)


__all__ = [
    "ddim", "euler", "dpm", "edm", "dpm_edm", "unipc", "get_sampler",
    "is_multistep", "make_tables_for", "ScheduleConfig",
]
