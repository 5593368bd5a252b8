"""The grid-search runner (port of vdx/harness/grid.py), after reference
experiments/05_grid_search_ablation.py: three one-factor-at-a-time
ablations (CFG sweep at 25 steps, steps sweep at CFG 7.5, baseline
against enhanced prompts) over six videos, 78 experiments, with

  * the reference's artifact layout: {output}/{experiment_id}/frames/*.png,
    {experiment_id}.gif and config.json (05:172-188);
  * config.json written LAST, as the resume commit marker: a re-run
    skips every experiment that has one (05:213-216, 246-249, 285-289);
  * the manifest.json index (05:343-373).

Generation runs on the pipeline's device (CUDA unless the pipeline was
built for the CPU); ``overlap_io`` writes experiment i's files while
experiment i + 1's denoise runs on the card.
"""

from __future__ import annotations

import gc
import json
from pathlib import Path
from typing import Dict, List, Optional

from vdx_torch.harness.config import (
    CFG_VALUES,
    DEFAULT_CFG,
    DEFAULT_STEPS,
    STEPS_VALUES,
    TEST_VIDEOS,
    ExperimentConfig,
)
from vdx_torch.io.frames import export_to_gif, save_frames


def generate_video(pipe, config: ExperimentConfig, output_type: str = "pil"):
    """One experiment through the pipeline -> its frames.

    "pil" (default): a list of PIL frames, after the card is done.
    "device": a uint8 [1, F, H, W, 3] tensor on the pipeline's device,
    returned once the work is queued (no host sync), so the caller can
    write the previous experiment's files while this one runs."""
    out = pipe(
        prompt=config.prompt,
        negative_prompt=config.negative_prompt,
        num_frames=config.num_frames,
        guidance_scale=config.guidance_scale,
        num_inference_steps=config.num_inference_steps,
        height=config.height,
        width=config.width,
        seed=config.seed,
        output_type=output_type,
    )
    frames = out.frames
    return frames[0] if isinstance(frames, list) else frames


def _as_frames(frames):
    """PIL lists pass through; a [1, F, H, W, 3] or [F, H, W, 3] uint8
    tensor (read back from its device once) or array becomes a list of
    [H, W, 3] arrays."""
    if isinstance(frames, list):
        return frames
    arr = frames.cpu().numpy() if hasattr(frames, "cpu") else frames
    return list(arr[0] if arr.ndim == 5 else arr)


def save_experiment(frames, config: ExperimentConfig, output_dir: Path) -> Path:
    exp_dir = Path(output_dir) / config.experiment_id
    frames = _as_frames(frames)
    save_frames(frames, exp_dir / "frames")
    export_to_gif(frames, exp_dir / f"{config.experiment_id}.gif")
    # config.json LAST: it is the commit marker for resume.
    config.save(exp_dir / "config.json")
    return exp_dir


def _run_one(pipe, config: ExperimentConfig, output_dir: Path, log) -> None:
    """One experiment, generate then save, no overlap."""
    exp_dir = Path(output_dir) / config.experiment_id
    if (exp_dir / "config.json").exists():
        log(f"  Skipping {config.experiment_id} (already exists)")
        return
    log(f"  Generating: {config.experiment_id}")
    frames = generate_video(pipe, config)
    save_experiment(frames, config, output_dir)
    gc.collect()


def cfg_ablation_configs(video_name: str, video_config: dict) -> List[ExperimentConfig]:
    return [
        ExperimentConfig(
            experiment_id=f"{video_name}_cfg{cfg:.1f}_steps{DEFAULT_STEPS}",
            video_name=video_name,
            prompt=video_config["prompt_baseline"],
            negative_prompt=video_config["negative_baseline"],
            guidance_scale=cfg,
            num_inference_steps=DEFAULT_STEPS,
            phase="cfg_ablation",
        )
        for cfg in CFG_VALUES
    ]


def steps_ablation_configs(video_name: str, video_config: dict) -> List[ExperimentConfig]:
    return [
        ExperimentConfig(
            experiment_id=f"{video_name}_cfg{DEFAULT_CFG:.1f}_steps{steps}",
            video_name=video_name,
            prompt=video_config["prompt_baseline"],
            negative_prompt=video_config["negative_baseline"],
            guidance_scale=DEFAULT_CFG,
            num_inference_steps=steps,
            phase="steps_ablation",
        )
        for steps in STEPS_VALUES
    ]


def prompt_ablation_configs(video_name: str, video_config: dict) -> List[ExperimentConfig]:
    return [
        ExperimentConfig(
            experiment_id=(
                f"{video_name}_cfg{DEFAULT_CFG:.1f}_steps{DEFAULT_STEPS}_prompt_{variant}"
            ),
            video_name=video_name,
            prompt=video_config[f"prompt_{variant}"],
            negative_prompt=video_config[f"negative_{variant}"],
            guidance_scale=DEFAULT_CFG,
            num_inference_steps=DEFAULT_STEPS,
            phase="prompt_ablation",
        )
        for variant in ("baseline", "enhanced")
    ]


def plan_grid_search(
    phase: str = "all", video_filter: Optional[str] = None
) -> List[ExperimentConfig]:
    """The experiment plan (78 configs for phase "all" and no filter)."""
    videos = TEST_VIDEOS
    if video_filter:
        videos = {k: v for k, v in TEST_VIDEOS.items() if video_filter in k}
    configs: List[ExperimentConfig] = []
    for name, vc in videos.items():
        if phase in ("all", "cfg"):
            configs.extend(cfg_ablation_configs(name, vc))
        if phase in ("all", "steps"):
            configs.extend(steps_ablation_configs(name, vc))
        if phase in ("all", "prompt"):
            configs.extend(prompt_ablation_configs(name, vc))
    return configs


def run_grid_search(
    pipe,
    phase: str = "all",
    video_filter: Optional[str] = None,
    output_dir: Path = Path("outputs/05_grid_search"),
    log=print,
    step_progress: bool = False,
    overlap_io: bool = True,
) -> List[ExperimentConfig]:
    """Run the (possibly filtered) grid.

    ``overlap_io`` (default) runs the study one experiment deep: each
    experiment is generated with ``output_type="device"``, and the
    previous one's frames are read back and written (PNG, GIF, then
    config.json) while the card runs it. config.json still comes last,
    so a crash mid-overlap re-generates the pending experiment on the
    next run. ``step_progress`` logs each denoising step."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    configs = plan_grid_search(phase, video_filter)
    if step_progress and getattr(pipe, "progress_callback", None) is None:
        pipe.progress_callback = lambda i, n: log(f"    step {i + 1}/{n}")
    if not overlap_io:
        for config in configs:
            _run_one(pipe, config, output_dir, log)
        return configs

    pending = None  # (device frames, config) generated, not yet saved
    for config in configs:
        exp_dir = output_dir / config.experiment_id
        if (exp_dir / "config.json").exists():
            log(f"  Skipping {config.experiment_id} (already exists)")
            continue
        log(f"  Generating: {config.experiment_id}")
        frames = generate_video(pipe, config, output_type="device")
        if pending is not None:
            save_experiment(*pending, output_dir)
            gc.collect()
        pending = (frames, config)
    if pending is not None:
        save_experiment(*pending, output_dir)
        gc.collect()
    return configs


def generate_manifest(output_dir: Path) -> Dict:
    """manifest.json over the completed experiments (05:343-373)."""
    output_dir = Path(output_dir)
    manifest = {
        "grid_params": {
            "cfg_values": CFG_VALUES,
            "steps_values": STEPS_VALUES,
            "default_cfg": DEFAULT_CFG,
            "default_steps": DEFAULT_STEPS,
        },
        "experiments": [],
    }
    for exp_dir in sorted(output_dir.iterdir()):
        config_path = exp_dir / "config.json"
        if config_path.exists():
            with open(config_path) as f:
                config = json.load(f)
            manifest["experiments"].append(
                {
                    "experiment_id": config["experiment_id"],
                    "video_name": config["video_name"],
                    "cfg": config["guidance_scale"],
                    "steps": config["num_inference_steps"],
                    "phase": config["phase"],
                }
            )
    with open(output_dir / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def measure_experiments(
    input_dir: Path,
    output_dir: Path,
    exp_filter: Optional[str] = None,
    lpips_metric=None,
    flow_estimator=None,
    log=print,
    device="cuda",
) -> list:
    """The measurement pass over a grid-search output tree (06:465-544):
    {id}_metrics.json per experiment and grid_search_results.json. The
    clips are measured on ``device``, CUDA unless the caller asks for the
    CPU; LPIPS defaults to ``LPIPSMetric()`` there."""
    from vdx_torch.metrics.engine import (load_frames, measure_video,
                                          save_metrics, save_summary)

    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    exp_dirs = [d for d in input_dir.iterdir() if d.is_dir() and (d / "frames").exists()]
    if exp_filter:
        exp_dirs = [d for d in exp_dirs if exp_filter in d.name]

    if lpips_metric is None:
        from vdx_torch.metrics.lpips import LPIPSMetric

        lpips_metric = LPIPSMetric(device=device)
    if flow_estimator is None:
        from vdx_torch.metrics.flow import OpticalFlowEstimator

        flow_estimator = OpticalFlowEstimator()

    all_metrics = []
    for i, exp_dir in enumerate(sorted(exp_dirs)):
        log(f"[{i + 1}/{len(exp_dirs)}] {exp_dir.name}")
        with open(exp_dir / "config.json") as f:
            config = json.load(f)
        frames = load_frames(exp_dir / "frames")
        m = measure_video(
            frames,
            video_name=config["video_name"],
            experiment_id=config["experiment_id"],
            config=config,
            lpips_metric=lpips_metric,
            flow_estimator=flow_estimator,
            device=device,
        )
        all_metrics.append(m)
        save_metrics(m, output_dir / f"{m.experiment_id}_metrics.json")
    save_summary(all_metrics, output_dir / "grid_search_results.json")
    return all_metrics
