"""Temporal-consistency metrics (port of vdx/metrics/temporal.py): the
reference engine's formulas (reference experiments/06_measure_grid_search.py)
as batched torch ops on the frames' device, every pair at once.

  * MSE and PSNR per consecutive pair (06:209-218; PSNR 100 below an MSE
    of 1e-10)
  * flicker index = mean |I_t - 2 I_{t+1} + I_{t+2}| (06:221-235)
  * temporal consistency = var(mse) * 1000 + mean(mse) * 100
    + mean(lpips) * 50 + var(lpips) * 500 (06:238-252)

fp32 throughout; variances are population variances (np.var's default),
as the reference's. Nothing here is a matmul or a convolution, so TF32
cannot reach these reductions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def unit_frames(frames, device=None) -> torch.Tensor:
    """A clip as fp32 in [0, 1] on ``device`` (a tensor's own device when
    None): uint8 is divided by 255 with IEEE division, as numpy divides
    the reference's PNG frames (CUDA's division by a host scalar multiplies
    by its reciprocal, one ulp off); float passes through."""
    x = torch.as_tensor(frames if torch.is_tensor(frames)
                        else np.asarray(frames), device=device)
    if x.dtype != torch.uint8:
        return x.float()
    return x.float() / torch.full((), 255.0, device=x.device)


def mse_pairs(frames: torch.Tensor) -> torch.Tensor:
    """[F, H, W, C] in [0, 1] -> [F-1] MSE of each consecutive pair."""
    x = frames.float()
    d = x[1:] - x[:-1]
    return (d * d).mean(dim=(1, 2, 3))


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    """PSNR of each pair; 100 where the MSE is below 1e-10 (06:215-218)."""
    safe = torch.clamp_min(mse, 1e-30)
    return torch.where(mse < 1e-10, torch.full_like(mse, 100.0),
                       10.0 * torch.log10(1.0 / safe))


def flicker_index(frames: torch.Tensor) -> torch.Tensor:
    """Mean absolute second temporal difference: a 0-d tensor, 0 for
    fewer than 3 frames."""
    if frames.shape[0] < 3:
        return torch.zeros((), dtype=torch.float32, device=frames.device)
    x = frames.float()
    return (x[:-2] - 2.0 * x[1:-1] + x[2:]).abs().mean()


def temporal_consistency_score(mse: torch.Tensor,
                               lpips: torch.Tensor) -> torch.Tensor:
    """The composite score (06:238-252), population variances, fp32."""
    mse, lpips = mse.float(), lpips.float()
    return (mse.var(correction=0) * 1000.0 + mse.mean() * 100.0
            + lpips.mean() * 50.0 + lpips.var(correction=0) * 500.0)


def basic_metrics(frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every metric of the suite that needs no model: per-pair MSE and
    PSNR, and the flicker index, as tensors on the frames' device."""
    mse = mse_pairs(frames)
    return {"mse": mse, "psnr": psnr_from_mse(mse),
            "flicker_index": flicker_index(frames)}
