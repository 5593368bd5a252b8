"""Comprehensive analysis — trends, win counts, agreement, recommendations
(port of vdx/analysis/comprehensive.py).

Capability-parity rebuild of reference experiments/08_analyze_comprehensive.py:
per-metric best/worst + trend detection with the 0.9 ratio band (08:97-105,
198-206), win-count summaries over the 8-metric panel, prompt impact with
±5% verdicts (08:269-361), metric-agreement scores = 1 - (unique-1)/(n-1)
(08:368-426), per-video recommendations by win-count vote with confidence
(08:433-488), and the same 11-CSV artifact set (08:505-531).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from vdx_torch.analysis.common import (  # noqa: F401
    CFG_VALUES,
    METRICS_08 as METRICS,
    STEPS_VALUES,
    load_results_raw as load_results,
)


def _sweep_analysis(
    data: pd.DataFrame, param: str, values, low_thr, high_thr, labels: Tuple[str, str]
):
    """Shared engine for CFG / steps sweeps: detailed + win counts + trends."""
    videos = data["video_name"].unique()
    hi_better, lo_better = labels

    detailed_rows = []
    for video in sorted(videos):
        vd = data[data["video_name"] == video]
        if vd.empty:
            continue
        row = {"video": video}
        short = "cfg" if param == "guidance_scale" else "steps"
        for metric in METRICS:
            best_idx = vd[metric].idxmin()
            worst_idx = vd[metric].idxmax()
            cast = int if param == "num_inference_steps" else float
            row[f"{metric}_best_{short}"] = cast(vd.loc[best_idx, param])
            row[f"{metric}_best_val"] = vd.loc[best_idx, metric]
            row[f"{metric}_worst_{short}"] = cast(vd.loc[worst_idx, param])
            row[f"{metric}_worst_val"] = vd.loc[worst_idx, metric]
            low = vd[vd[param] <= low_thr][metric].mean()
            high = vd[vd[param] >= high_thr][metric].mean()
            if high < low * 0.9:
                row[f"{metric}_trend"] = hi_better
            elif low < high * 0.9:
                row[f"{metric}_trend"] = lo_better
            else:
                row[f"{metric}_trend"] = "Mixed"
        detailed_rows.append(row)
    detailed_df = pd.DataFrame(detailed_rows)

    summary_rows = []
    for metric in METRICS:
        wins: Dict = {}
        for video in videos:
            vd = data[data["video_name"] == video]
            if not vd.empty:
                best = vd.loc[vd[metric].idxmin(), param]
                if param == "num_inference_steps":
                    best = int(best)
                wins[best] = wins.get(best, 0) + 1
        row = {"metric": metric}
        prefix = "cfg" if param == "guidance_scale" else "steps"
        for v in values:
            row[f"{prefix}_{v}"] = wins.get(v, 0)
        if wins:
            winner = max(wins.items(), key=lambda x: x[1])
            row[f"winner_{prefix}"] = winner[0]
            row["winner_count"] = winner[1]
        summary_rows.append(row)
    summary_df = pd.DataFrame(summary_rows)

    trends_rows = []
    for metric in METRICS:
        trends = {hi_better: 0, lo_better: 0, "Mixed": 0}
        for video in videos:
            vd = data[data["video_name"] == video]
            if vd.empty:
                continue
            low = vd[vd[param] <= low_thr][metric].mean()
            high = vd[vd[param] >= high_thr][metric].mean()
            if high < low * 0.9:
                trends[hi_better] += 1
            elif low < high * 0.9:
                trends[lo_better] += 1
            else:
                trends["Mixed"] += 1
        trends_rows.append(
            {"metric": metric, **trends,
             "dominant_trend": max(trends.items(), key=lambda x: x[1])[0]}
        )
    trends_df = pd.DataFrame(trends_rows)

    return detailed_df, summary_df, trends_df


def analyze_cfg_sweep(df: pd.DataFrame):
    data = df[(df["num_inference_steps"] == 25) & (df["phase"] == "cfg_ablation")]
    return _sweep_analysis(
        data, "guidance_scale", CFG_VALUES, 6.0, 8.0,
        ("Higher CFG better", "Lower CFG better"),
    )


def analyze_steps_sweep(df: pd.DataFrame):
    data = df[(df["guidance_scale"] == 7.5) & (df["phase"] == "steps_ablation")]
    return _sweep_analysis(
        data, "num_inference_steps", STEPS_VALUES, 20, 40,
        ("More steps better", "Fewer steps better"),
    )


def analyze_prompt_impact(df: pd.DataFrame):
    prompt_data = df[df["phase"] == "prompt_ablation"]
    videos = df["video_name"].unique()

    detailed_rows = []
    for video in sorted(videos):
        vp = prompt_data[prompt_data["video_name"] == video]
        baseline = vp[vp["experiment_id"].str.contains("baseline")]
        enhanced = vp[vp["experiment_id"].str.contains("enhanced")]
        if baseline.empty or enhanced.empty:
            continue
        row = {"video": video}
        wins = losses = 0
        for metric in METRICS:
            b, e = baseline[metric].values[0], enhanced[metric].values[0]
            if b != 0:
                pct = (b - e) / b * 100
                row[f"{metric}_baseline"] = b
                row[f"{metric}_enhanced"] = e
                row[f"{metric}_change_pct"] = pct
                if pct > 5:
                    row[f"{metric}_verdict"] = "Improved"
                    wins += 1
                elif pct < -5:
                    row[f"{metric}_verdict"] = "Worse"
                    losses += 1
                else:
                    row[f"{metric}_verdict"] = "Neutral"
        row["total_wins"] = wins
        row["total_losses"] = losses
        row["overall_verdict"] = (
            "Helps" if wins > losses else ("Hurts" if losses > wins else "Neutral")
        )
        detailed_rows.append(row)
    detailed_df = pd.DataFrame(detailed_rows)

    summary_rows = []
    for metric in METRICS:
        improvements, wins, losses = [], 0, 0
        for video in videos:
            vp = prompt_data[prompt_data["video_name"] == video]
            baseline = vp[vp["experiment_id"].str.contains("baseline")]
            enhanced = vp[vp["experiment_id"].str.contains("enhanced")]
            if baseline.empty or enhanced.empty:
                continue
            b, e = baseline[metric].values[0], enhanced[metric].values[0]
            if b != 0:
                pct = (b - e) / b * 100
                improvements.append(pct)
                if pct > 5:
                    wins += 1
                elif pct < -5:
                    losses += 1
        if improvements:
            summary_rows.append(
                {
                    "metric": metric,
                    "avg_improvement_pct": np.mean(improvements),
                    "std_improvement_pct": np.std(improvements),
                    "wins": wins,
                    "losses": losses,
                    "neutral": len(improvements) - wins - losses,
                    "verdict": "Helps" if wins > losses
                    else ("Hurts" if losses > wins else "Mixed"),
                }
            )
    return detailed_df, pd.DataFrame(summary_rows)


def analyze_metric_agreement(df: pd.DataFrame):
    cfg_data = df[(df["num_inference_steps"] == 25) & (df["phase"] == "cfg_ablation")]
    steps_data = df[(df["guidance_scale"] == 7.5) & (df["phase"] == "steps_ablation")]
    videos = df["video_name"].unique()

    def agreement(data, param, cast):
        short = "cfg" if param == "guidance_scale" else "steps"
        rows = []
        for video in sorted(videos):
            vd = data[data["video_name"] == video]
            if vd.empty:
                continue
            row = {"video": video}
            optima = []
            for metric in METRICS:
                best = cast(vd.loc[vd[metric].idxmin(), param])
                row[f"{metric}_best_{short}"] = best
                optima.append(best)
            row["unique_values"] = len(set(optima))
            row["agreement_score"] = 1 - (len(set(optima)) - 1) / (len(METRICS) - 1)
            row[f"most_common_{short}"] = max(set(optima), key=optima.count)
            rows.append(row)
        return pd.DataFrame(rows)

    return (
        agreement(cfg_data, "guidance_scale", float),
        agreement(steps_data, "num_inference_steps", int),
    )


def generate_recommendations(df: pd.DataFrame) -> pd.DataFrame:
    cfg_data = df[(df["num_inference_steps"] == 25) & (df["phase"] == "cfg_ablation")]
    steps_data = df[(df["guidance_scale"] == 7.5) & (df["phase"] == "steps_ablation")]
    prompt_data = df[df["phase"] == "prompt_ablation"]

    rows = []
    for video in sorted(df["video_name"].unique()):
        row = {"video": video}
        vd = cfg_data[cfg_data["video_name"] == video]
        if not vd.empty:
            wins: Dict = {}
            for metric in METRICS:
                best = vd.loc[vd[metric].idxmin(), "guidance_scale"]
                wins[best] = wins.get(best, 0) + 1
            row["recommended_cfg"] = max(wins.items(), key=lambda x: x[1])[0]
            row["cfg_confidence"] = max(wins.values()) / len(METRICS)
        vd = steps_data[steps_data["video_name"] == video]
        if not vd.empty:
            wins = {}
            for metric in METRICS:
                best = int(vd.loc[vd[metric].idxmin(), "num_inference_steps"])
                wins[best] = wins.get(best, 0) + 1
            row["recommended_steps"] = max(wins.items(), key=lambda x: x[1])[0]
            row["steps_confidence"] = max(wins.values()) / len(METRICS)
        vp = prompt_data[prompt_data["video_name"] == video]
        baseline = vp[vp["experiment_id"].str.contains("baseline")]
        enhanced = vp[vp["experiment_id"].str.contains("enhanced")]
        if not baseline.empty and not enhanced.empty:
            wins = losses = 0
            for metric in METRICS:
                b, e = baseline[metric].values[0], enhanced[metric].values[0]
                if b != 0:
                    pct = (b - e) / b * 100
                    if pct > 5:
                        wins += 1
                    elif pct < -5:
                        losses += 1
            row["prompt_wins"] = wins
            row["prompt_losses"] = losses
            row["use_enhanced_prompt"] = (
                "Yes" if wins > losses else ("No" if losses > wins else "Optional")
            )
        rows.append(row)
    return pd.DataFrame(rows)


def save_all_tables(df: pd.DataFrame, output_dir: Path) -> Dict[str, pd.DataFrame]:
    """Run everything and write the 11-CSV artifact set (08:505-531)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cfg_detailed, cfg_summary, cfg_trends = analyze_cfg_sweep(df)
    steps_detailed, steps_summary, steps_trends = analyze_steps_sweep(df)
    prompt_detailed, prompt_summary = analyze_prompt_impact(df)
    cfg_agreement, steps_agreement = analyze_metric_agreement(df)
    recommendations = generate_recommendations(df)
    tables = {
        "cfg_detailed": cfg_detailed, "cfg_summary": cfg_summary,
        "cfg_trends": cfg_trends, "steps_detailed": steps_detailed,
        "steps_summary": steps_summary, "steps_trends": steps_trends,
        "prompt_detailed": prompt_detailed, "prompt_summary": prompt_summary,
        "cfg_agreement": cfg_agreement, "steps_agreement": steps_agreement,
        "recommendations": recommendations,
    }
    for name, table in tables.items():
        table.to_csv(output_dir / f"{name}.csv", index=False)
    return tables


def main(argv: Optional[list] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Comprehensive grid search analysis")
    p.add_argument("--input", type=str,
                   default="outputs/06_grid_search_metrics/grid_search_results.json")
    p.add_argument("--output", type=str, default="outputs/08_comprehensive_analysis")
    args = p.parse_args(argv)
    tables = save_all_tables(load_results(Path(args.input)), Path(args.output))
    print(tables["recommendations"].to_string(index=False))


if __name__ == "__main__":
    main()
