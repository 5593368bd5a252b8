"""Shared analysis definitions (metric lists, loading); port of
vdx/analysis/common.py.

Field/metric names mirror the reference analysis layer exactly
(reference experiments/07_analyze_grid_search.py:34-57,
08_analyze_comprehensive.py:28-50) — they key into the metrics engine's
JSON schema, so the two layers interoperate with the committed
78-record oracle dataset.
"""

from __future__ import annotations

import json
from pathlib import Path

import pandas as pd

# 07's metric lists (lower is better for all)
METRICS_07 = [
    "mean_mse", "std_mse", "mean_lpips", "std_lpips",
    "mean_flow_magnitude", "flow_magnitude_variance",
    "mean_warp_error", "warp_error_variance", "flicker_index",
]
PRIMARY_METRICS = [
    "mean_mse", "mean_lpips", "mean_flow_magnitude", "flow_magnitude_variance",
    "mean_warp_error", "warp_error_variance", "flicker_index",
]

# 08's 8-metric panel (includes the composite score)
METRICS_08 = [
    "mean_mse", "mean_lpips", "mean_flow_magnitude", "flow_magnitude_variance",
    "mean_warp_error", "warp_error_variance", "flicker_index",
    "temporal_consistency_score",
]
METRIC_SHORT_NAMES = {
    "mean_mse": "MSE", "mean_lpips": "LPIPS", "mean_flow_magnitude": "Flow Mag",
    "flow_magnitude_variance": "Flow Var", "mean_warp_error": "Warp Err",
    "warp_error_variance": "Warp Var", "flicker_index": "Flicker",
    "temporal_consistency_score": "Consistency",
}

CFG_VALUES = [5.0, 6.0, 7.0, 7.5, 8.0, 9.0]
STEPS_VALUES = [15, 20, 25, 30, 40, 50]


def load_results(json_path: Path) -> pd.DataFrame:
    """grid_search_results.json -> DataFrame with 07's column renames."""
    with open(json_path) as f:
        results = json.load(f)
    df = pd.DataFrame(results)
    df = df.rename(columns={"guidance_scale": "cfg", "num_inference_steps": "steps"})
    return df


def load_results_raw(json_path: Path) -> pd.DataFrame:
    """08-style loading: raw column names preserved."""
    with open(json_path) as f:
        return pd.DataFrame(json.load(f))
