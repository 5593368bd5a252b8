"""Video measurement engine (port of vdx/metrics/engine.py).

``VideoMetrics`` and the JSON files have the reference's schema, key for
key and in its order (experiments/06_measure_grid_search.py:40-91
dataclasses, 06:396-458 serialisation): the analysis layer and the
reference's committed files read these names.

``measure_video`` takes a clip as numpy or as a tensor on any device
([F, H, W, 3], float in [0, 1] or uint8): MSE, PSNR, flicker, LPIPS
(every pair in one batch), the warp error (every pair in one gather) and
the score run on the clip's device; the flows run on the host (the
grayscale in numpy, as the reference takes it; the pairs fanned over a
4-thread pool). Numpy clips go to CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from vdx_torch.metrics.temporal import (basic_metrics,
                                        temporal_consistency_score, unit_frames)
from vdx_torch.metrics.warp import warp_error_pairs


@dataclasses.dataclass
class FramePairMetrics:
    """Per-consecutive-pair metrics (reference 06:40-49)."""

    frame_idx: int
    mse: float
    psnr: float
    lpips: float
    flow_magnitude_mean: float
    flow_magnitude_std: float
    warp_error: float


@dataclasses.dataclass
class VideoMetrics:
    """Aggregate metrics (reference 06:52-91); field names are the contract."""

    video_name: str
    experiment_id: str
    num_frames: int
    guidance_scale: float
    num_inference_steps: int
    phase: str
    frame_metrics: List[FramePairMetrics]
    mean_mse: float
    std_mse: float
    mean_psnr: float
    mean_lpips: float
    std_lpips: float
    mean_flow_magnitude: float
    flow_magnitude_variance: float
    mean_warp_error: float
    warp_error_variance: float
    temporal_consistency_score: float
    flicker_index: float


def load_frames(frame_dir: Path) -> np.ndarray:
    """PNG (else JPG) frames of a directory, sorted -> [F, H, W, 3] float32
    in [0, 1] (reference 06:97-112, channels-last)."""
    from PIL import Image

    frame_dir = Path(frame_dir)
    files = sorted(frame_dir.glob("*.png")) or sorted(frame_dir.glob("*.jpg"))
    if not files:
        raise ValueError(f"No frames found in {frame_dir}")
    frames = [np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
              for f in files]
    return np.stack(frames, axis=0)


def _device_of(frames, device) -> torch.device:
    if torch.is_tensor(frames):
        return frames.device
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_video runs on CUDA but no CUDA device is "
                           "available; pass device='cpu' to measure on the CPU")
    return dev


def measure_video(
    frames,
    video_name: str,
    experiment_id: str,
    config: dict,
    lpips_metric=None,
    flow_estimator=None,
    device: Optional[Union[str, torch.device]] = None,
    timings: Optional[dict] = None,
) -> VideoMetrics:
    """Temporal consistency of one clip, [F, H, W, 3] in [0, 1] (float) or
    uint8. A tensor is measured on its own device; a numpy clip on
    ``device`` (default CUDA). ``lpips_metric`` None gives LPIPS 0, as
    vdx. ``timings``, when a dict, gets the seconds of each part ("basic",
    "lpips", "flow", "warp"; the device synchronised after each)."""
    if flow_estimator is None:
        from vdx_torch.metrics.flow import OpticalFlowEstimator

        flow_estimator = OpticalFlowEstimator()
    dev = _device_of(frames, device)
    x = unit_frames(frames, dev)
    F = x.shape[0]
    clock = {"t": time.perf_counter()}

    def lap(name):
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[name] = now - clock["t"]
            clock["t"] = now

    basics = basic_metrics(x)
    lap("basic")
    if lpips_metric is not None:
        lpips_dev = lpips_metric.compute_pairs(x).to(dev)
    else:
        lpips_dev = torch.zeros(F - 1, dtype=torch.float32, device=dev)
    lap("lpips")

    # The flows on the host: the reference's grayscale of the [0, 1]
    # frames in numpy, then the pairs over a thread pool (the native call
    # releases the GIL).
    host = frames.cpu().numpy() if torch.is_tensor(frames) else np.asarray(frames)
    if host.dtype == np.uint8:
        host = host.astype(np.float32) / 255.0
    gray = (host.mean(axis=-1) * 255).astype(np.uint8)
    with ThreadPoolExecutor(max_workers=4) as pool:
        flows = np.stack(list(pool.map(
            lambda i: flow_estimator.compute_flow_gray(gray[i], gray[i + 1]),
            range(F - 1))))
    mags = np.sqrt((flows**2).sum(-1)).reshape(F - 1, -1)
    flow_mag_mean = mags.mean(axis=1).astype(np.float64)
    flow_mag_std = mags.std(axis=1).astype(np.float64)
    lap("flow")
    warp_dev = warp_error_pairs(x, torch.from_numpy(flows).to(dev))
    lap("warp")
    score = float(temporal_consistency_score(basics["mse"], lpips_dev))

    mse = basics["mse"].double().cpu().numpy()
    psnr = basics["psnr"].double().cpu().numpy()
    lpips_vals = lpips_dev.double().cpu().numpy()
    warp_errors = warp_dev.double().cpu().numpy()
    frame_metrics = [
        FramePairMetrics(
            frame_idx=i,
            mse=float(mse[i]),
            psnr=float(psnr[i]),
            lpips=float(lpips_vals[i]),
            flow_magnitude_mean=float(flow_mag_mean[i]),
            flow_magnitude_std=float(flow_mag_std[i]),
            warp_error=float(warp_errors[i]),
        )
        for i in range(F - 1)
    ]
    return VideoMetrics(
        video_name=video_name,
        experiment_id=experiment_id,
        num_frames=F,
        guidance_scale=config.get("guidance_scale", 0),
        num_inference_steps=config.get("num_inference_steps", 0),
        phase=config.get("phase", "unknown"),
        frame_metrics=frame_metrics,
        mean_mse=float(np.mean(mse)),
        std_mse=float(np.std(mse)),
        mean_psnr=float(np.mean(psnr)),
        mean_lpips=float(np.mean(lpips_vals)),
        std_lpips=float(np.std(lpips_vals)),
        mean_flow_magnitude=float(np.mean(flow_mag_mean)),
        flow_magnitude_variance=float(np.var(flow_mag_mean)),
        mean_warp_error=float(np.mean(warp_errors)),
        warp_error_variance=float(np.var(warp_errors)),
        temporal_consistency_score=score,
        flicker_index=float(basics["flicker_index"]),
    )


def save_metrics(metrics: VideoMetrics, output_path: Path) -> None:
    """Per-experiment JSON with the reference's exact key order (06:396-427)."""
    data = {
        "video_name": metrics.video_name,
        "experiment_id": metrics.experiment_id,
        "num_frames": metrics.num_frames,
        "guidance_scale": metrics.guidance_scale,
        "num_inference_steps": metrics.num_inference_steps,
        "phase": metrics.phase,
        "mean_mse": metrics.mean_mse,
        "std_mse": metrics.std_mse,
        "mean_psnr": metrics.mean_psnr,
        "mean_lpips": metrics.mean_lpips,
        "std_lpips": metrics.std_lpips,
        "mean_flow_magnitude": metrics.mean_flow_magnitude,
        "flow_magnitude_variance": metrics.flow_magnitude_variance,
        "mean_warp_error": metrics.mean_warp_error,
        "warp_error_variance": metrics.warp_error_variance,
        "temporal_consistency_score": metrics.temporal_consistency_score,
        "flicker_index": metrics.flicker_index,
        "frame_metrics": [dataclasses.asdict(fm) for fm in metrics.frame_metrics],
    }
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)


def save_summary(all_metrics: List[VideoMetrics], output_path: Path) -> None:
    """The roll-up JSON, the reference's grid_search_results.json
    (06:430-458)."""
    summary = [
        {
            "experiment_id": m.experiment_id,
            "video_name": m.video_name,
            "guidance_scale": m.guidance_scale,
            "num_inference_steps": m.num_inference_steps,
            "phase": m.phase,
            "mean_mse": m.mean_mse,
            "std_mse": m.std_mse,
            "mean_lpips": m.mean_lpips,
            "std_lpips": m.std_lpips,
            "mean_flow_magnitude": m.mean_flow_magnitude,
            "flow_magnitude_variance": m.flow_magnitude_variance,
            "mean_warp_error": m.mean_warp_error,
            "warp_error_variance": m.warp_error_variance,
            "temporal_consistency_score": m.temporal_consistency_score,
            "flicker_index": m.flicker_index,
        }
        for m in all_metrics
    ]
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2)
