"""The study's temporal-consistency metrics (port of vdx/metrics/)."""
from vdx_torch.metrics.engine import (
    FramePairMetrics,
    VideoMetrics,
    load_frames,
    measure_video,
    save_metrics,
    save_summary,
)
from vdx_torch.metrics.flow import OpticalFlowEstimator
from vdx_torch.metrics.lpips import LPIPS, LPIPSMetric
from vdx_torch.metrics.temporal import (
    basic_metrics,
    flicker_index,
    mse_pairs,
    psnr_from_mse,
    temporal_consistency_score,
)
from vdx_torch.metrics.warp import warp_error_pairs, warp_frame

__all__ = [
    "FramePairMetrics",
    "VideoMetrics",
    "load_frames",
    "measure_video",
    "save_metrics",
    "save_summary",
    "OpticalFlowEstimator",
    "LPIPS",
    "LPIPSMetric",
    "basic_metrics",
    "flicker_index",
    "mse_pairs",
    "psnr_from_mse",
    "temporal_consistency_score",
    "warp_error_pairs",
    "warp_frame",
]
