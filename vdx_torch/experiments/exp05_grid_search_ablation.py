"""Experiment 05: systematic grid-search ablation (port of
experiments/05_grid_search_ablation.py: the same phases, grids, artifact
layout, resume semantics and manifest; vdx_torch.harness.grid is the
library).

    python -m vdx_torch.experiments.exp05_grid_search_ablation \\
        [--phase {all,cfg,steps,prompt}] [--video NAME] [--output DIR] \\
        [--tiny] [--yes] [--checkpoint DIR] [--step-progress] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
from datetime import datetime
from pathlib import Path


def tiny_plan(phase: str = "all", video_filter=None) -> list:
    """The grid shrunk to smoke-test size (64x64, 4 frames, 2 steps), as
    vdx's ``--tiny`` (05:63-77)."""
    from vdx_torch.harness.grid import plan_grid_search

    return [dataclasses.replace(c, height=64, width=64, num_frames=4,
                                num_inference_steps=2)
            for c in plan_grid_search(phase, video_filter)]


def main(argv=None) -> None:
    from vdx_torch.harness.config import CFG_VALUES, STEPS_VALUES
    from vdx_torch.harness.grid import generate_manifest, run_grid_search

    p = argparse.ArgumentParser(description="Systematic Grid Search Ablation")
    p.add_argument("--phase", default="all", choices=["all", "cfg", "steps", "prompt"])
    p.add_argument("--video", default=None, help="partial-match video filter")
    p.add_argument("--output", default="outputs/05_grid_search")
    p.add_argument("--tiny", action="store_true", help="tiny configs (CPU smoke test)")
    p.add_argument("--yes", action="store_true", help="skip confirmation prompt")
    p.add_argument("--checkpoint", default=None,
                   help="the port's checkpoint directory (save_checkpoint)")
    p.add_argument("--step-progress", action="store_true",
                   help="log every denoise step")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (default cuda)")
    args = p.parse_args(argv)

    output_dir = Path(args.output)
    output_dir.mkdir(parents=True, exist_ok=True)

    print("=" * 60)
    print("SYSTEMATIC GRID SEARCH ABLATION")
    print("=" * 60)
    print(f"Phase: {args.phase}\nVideo filter: {args.video or 'all'}")
    print(f"Output: {output_dir}")
    print(f"CFG values: {CFG_VALUES}\nSteps values: {STEPS_VALUES}")

    if not args.yes:
        input("\nPress Enter to start (or Ctrl+C to cancel)...")

    from vdx_torch.experiments.experiments_common import load_pipeline

    pipe = load_pipeline(tiny=args.tiny, scheduler="ddim",
                         checkpoint=args.checkpoint, device=args.device)

    start = datetime.now()
    plan = tiny_plan(args.phase, args.video) if args.tiny else None
    configs = run_grid_search(pipe, args.phase, args.video, output_dir,
                              step_progress=args.step_progress, plan=plan)
    generate_manifest(output_dir)
    print(f"\nTotal time: {datetime.now() - start}")
    print(f"Experiments: {len(configs)}")
    print("\nNext step: python -m vdx_torch.experiments.exp06_measure_grid_search")


if __name__ == "__main__":
    main()
