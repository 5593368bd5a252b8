"""Basic grid-search analysis — per-video sweeps, optima, prompt deltas
(port of vdx/analysis/basic.py).

Capability-parity rebuild of reference experiments/07_analyze_grid_search.py:
per-video CFG/steps sweep tables with %-change-vs-baseline deltas (07:173-268),
per-metric optima (07:134-159), prompt comparisons (07:235-268), aggregated
cross-video win counts (07:328-355), and the same CSV artifact set
(07:389-425). Sign convention preserved: positive delta = improvement
(lower-is-better metrics).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import pandas as pd

from vdx_torch.analysis.common import METRICS_07, PRIMARY_METRICS, load_results  # noqa: F401


def get_cfg_sweep(df: pd.DataFrame, video_name: str, fixed_steps: int = 25) -> pd.DataFrame:
    mask = (
        (df["video_name"] == video_name)
        & (df["steps"] == fixed_steps)
        & (~df["phase"].isin(["prompt_ablation"]))
    )
    return df[mask].drop_duplicates(subset=["cfg"]).sort_values("cfg").copy()


def get_steps_sweep(df: pd.DataFrame, video_name: str, fixed_cfg: float = 7.5) -> pd.DataFrame:
    mask = (
        (df["video_name"] == video_name)
        & (df["cfg"] == fixed_cfg)
        & (~df["phase"].isin(["prompt_ablation"]))
    )
    return df[mask].drop_duplicates(subset=["steps"]).sort_values("steps").copy()


def get_prompt_comparison(df: pd.DataFrame, video_name: str) -> pd.DataFrame:
    mask = (df["video_name"] == video_name) & (df["phase"] == "prompt_ablation")
    comparison = df[mask].copy()
    if comparison.empty:
        by_id = df["experiment_id"].str
        comparison = pd.concat(
            [
                df[(df["video_name"] == video_name) & by_id.contains("prompt_baseline")],
                df[(df["video_name"] == video_name) & by_id.contains("prompt_enhanced")],
            ]
        )
    return comparison


def find_optimal(sweep: pd.DataFrame, metric: str, lower_is_better: bool = True) -> Dict:
    if sweep.empty or metric not in sweep.columns:
        return {"value": None, "param_value": None}
    valid = sweep.dropna(subset=[metric])
    if valid.empty:
        return {"value": None, "param_value": None}
    idx = valid[metric].idxmin() if lower_is_better else valid[metric].idxmax()
    best = valid.loc[idx]
    param_name = "cfg" if valid["cfg"].nunique() > 1 else "steps"
    return {"value": best[metric], "param_value": best[param_name], "param_name": param_name}


def relative_change(sweep: pd.DataFrame, metric: str, baseline_value: float) -> pd.Series:
    """% change vs baseline; positive = improvement for lower-is-better."""
    if baseline_value == 0:
        return pd.Series([0.0] * len(sweep), index=sweep.index)
    return (baseline_value - sweep[metric]) / baseline_value * 100


def _sweep_table(sweep: pd.DataFrame, param_col: str, baseline_mask) -> pd.DataFrame:
    if sweep.empty:
        return pd.DataFrame()
    display = [param_col, "mean_mse", "mean_lpips", "mean_flow_magnitude",
               "flow_magnitude_variance", "mean_warp_error", "warp_error_variance",
               "flicker_index"]
    table = sweep[[c for c in display if c in sweep.columns]].copy()
    baseline = sweep[baseline_mask]
    if not baseline.empty:
        for metric in PRIMARY_METRICS:
            if metric in sweep.columns and baseline[metric].notna().any():
                table[f"{metric}_delta"] = relative_change(
                    sweep, metric, baseline[metric].values[0]
                )
    return table


def generate_cfg_table(df: pd.DataFrame, video_name: str) -> pd.DataFrame:
    sweep = get_cfg_sweep(df, video_name)
    return _sweep_table(sweep, "cfg", sweep["cfg"] == 7.5 if not sweep.empty else None)


def generate_steps_table(df: pd.DataFrame, video_name: str) -> pd.DataFrame:
    sweep = get_steps_sweep(df, video_name)
    return _sweep_table(sweep, "steps", sweep["steps"] == 25 if not sweep.empty else None)


def generate_prompt_table(df: pd.DataFrame, video_name: str) -> pd.DataFrame:
    comparison = get_prompt_comparison(df, video_name)
    if comparison.empty:
        return pd.DataFrame()
    comparison = comparison.copy()
    comparison["prompt_type"] = comparison["experiment_id"].apply(
        lambda x: "enhanced" if "enhanced" in x else "baseline"
    )
    table = _sweep_table(
        comparison.rename(columns={"prompt_type": "prompt_type"}),
        "prompt_type",
        comparison["prompt_type"] == "baseline",
    )
    # _sweep_table drops prompt_type if missing from display list; rebuild head
    if "prompt_type" not in table.columns:
        table.insert(0, "prompt_type", comparison["prompt_type"].values)
    return table


def generate_optimal_summary(df: pd.DataFrame) -> pd.DataFrame:
    rows = []
    for video in sorted(df["video_name"].unique()):
        row = {"video": video}
        cfg_sweep = get_cfg_sweep(df, video)
        for metric in PRIMARY_METRICS:
            row[f"best_cfg_{metric}"] = find_optimal(cfg_sweep, metric)["param_value"]
        steps_sweep = get_steps_sweep(df, video)
        for metric in PRIMARY_METRICS:
            row[f"best_steps_{metric}"] = find_optimal(steps_sweep, metric)["param_value"]
        rows.append(row)
    return pd.DataFrame(rows)


def generate_prompt_summary(df: pd.DataFrame) -> pd.DataFrame:
    rows = []
    for video in sorted(df["video_name"].unique()):
        comparison = get_prompt_comparison(df, video)
        if comparison.empty:
            continue
        baseline = comparison[comparison["experiment_id"].str.contains("baseline")]
        enhanced = comparison[comparison["experiment_id"].str.contains("enhanced")]
        if baseline.empty or enhanced.empty:
            continue
        row = {"video": video}
        for metric in PRIMARY_METRICS:
            if metric in baseline.columns:
                b, e = baseline[metric].values[0], enhanced[metric].values[0]
                if b is not None and e is not None and b != 0:
                    row[f"{metric}_baseline"] = b
                    row[f"{metric}_enhanced"] = e
                    row[f"{metric}_improvement"] = (b - e) / b * 100
        rows.append(row)
    return pd.DataFrame(rows)


def generate_aggregated_analysis(df: pd.DataFrame) -> Dict:
    """Cross-video win counts per metric (07:328-355)."""
    videos = df["video_name"].unique()
    out = {"cfg_wins_by_metric": {}, "steps_wins_by_metric": {}}
    for key, sweep_fn in [("cfg_wins_by_metric", get_cfg_sweep),
                          ("steps_wins_by_metric", get_steps_sweep)]:
        for metric in PRIMARY_METRICS:
            wins: Dict = {}
            for video in videos:
                opt = find_optimal(sweep_fn(df, video), metric)
                if opt["param_value"] is not None:
                    wins[opt["param_value"]] = wins.get(opt["param_value"], 0) + 1
            out[key][metric] = wins
    return out


def save_all_csvs(df: pd.DataFrame, output_dir: Path) -> None:
    """Writes the full 07 CSV artifact set."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for video in sorted(df["video_name"].unique()):
        for name, table in [
            ("cfg_sweep", generate_cfg_table(df, video)),
            ("steps_sweep", generate_steps_table(df, video)),
            ("prompt_comparison", generate_prompt_table(df, video)),
        ]:
            if not table.empty:
                table.to_csv(output_dir / f"{video}_{name}.csv", index=False)
    generate_optimal_summary(df).to_csv(
        output_dir / "optimal_values_summary.csv", index=False
    )
    ps = generate_prompt_summary(df)
    if not ps.empty:
        ps.to_csv(output_dir / "prompt_improvement_summary.csv", index=False)
    # column order is part of the compatibility contract
    # (reference outputs/07_grid_search_analysis/all_grid_search_results.csv)
    lead = ["video_name", "experiment_id"]
    cols = lead + [c for c in df.columns if c not in lead]
    df[cols].to_csv(output_dir / "all_grid_search_results.csv", index=False)


def main(argv: Optional[list] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Analyze grid search results")
    p.add_argument("--input", type=str,
                   default="outputs/06_grid_search_metrics/grid_search_results.json")
    p.add_argument("--output", type=str, default="outputs/07_grid_search_analysis")
    args = p.parse_args(argv)
    df = load_results(Path(args.input))
    save_all_csvs(df, Path(args.output))
    agg = generate_aggregated_analysis(df)
    for key, by_metric in agg.items():
        print(f"\n{key}:")
        for metric, wins in by_metric.items():
            print(f"  {metric}: {wins}")


if __name__ == "__main__":
    main()
