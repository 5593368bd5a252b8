"""Experiment 06: measure grid-search results (port of
experiments/06_measure_grid_search.py): per-experiment *_metrics.json and
grid_search_results.json, in the reference's keys
(vdx_torch.metrics.engine), measured on ``--device``.

    python -m vdx_torch.experiments.exp06_measure_grid_search \\
        [--input DIR] [--output DIR] [--filter STR] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Measure grid search experiments")
    p.add_argument("--input", default="outputs/05_grid_search")
    p.add_argument("--output", default="outputs/06_grid_search_metrics")
    p.add_argument("--filter", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the metrics (LPIPS, warp; default "
                        "cuda); the Farneback flow runs on the host")
    args = p.parse_args(argv)

    from vdx_torch.harness.grid import measure_experiments

    input_dir = Path(args.input)
    if not input_dir.exists():
        print(f"Error: {input_dir} does not exist")
        print("Run vdx_torch.experiments.exp05_grid_search_ablation first")
        return

    metrics = measure_experiments(input_dir, Path(args.output), args.filter,
                                  device=args.device)
    print("\n" + "=" * 60)
    print(f"Measurement complete! {len(metrics)} experiments")
    print(f"Results: {args.output}/grid_search_results.json")
    print("Next step: python -m vdx_torch.experiments.exp07_analyze_grid_search")


if __name__ == "__main__":
    main()
