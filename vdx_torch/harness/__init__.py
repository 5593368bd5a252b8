"""The grid study's runners (port of vdx/harness/)."""
from vdx_torch.harness.batched import (
    denoise_batch,
    generate_batch,
    group_configs,
    run_batched_experiments,
)
from vdx_torch.harness.config import (
    CFG_VALUES,
    DEFAULT_CFG,
    DEFAULT_STEPS,
    STEPS_VALUES,
    TEST_VIDEOS,
    ExperimentConfig,
)
from vdx_torch.harness.grid import (
    generate_manifest,
    generate_video,
    measure_experiments,
    plan_grid_search,
    run_grid_search,
    save_experiment,
)

__all__ = [
    "CFG_VALUES",
    "DEFAULT_CFG",
    "DEFAULT_STEPS",
    "STEPS_VALUES",
    "TEST_VIDEOS",
    "ExperimentConfig",
    "denoise_batch",
    "generate_batch",
    "generate_manifest",
    "generate_video",
    "group_configs",
    "measure_experiments",
    "plan_grid_search",
    "run_batched_experiments",
    "run_grid_search",
    "save_experiment",
]
