"""FreeU — training-free re-weighting of UNet backbone and skip features
(port of vdx/nn/freeu.py; Si et al. 2023, "FreeU: Free Lunch in Diffusion
U-Net").

In the first two (lowest-resolution) up stages, the backbone half of the
channel split is amplified by b and the low-frequency band of the skip
connection is scaled by s, with no extra parameters or model evaluations.
The filter is an FFT over the (H, W) axes of the channels-last skip
tensor in fp32; ``torch.fft`` computes it (cuFFT on the card).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FreeUConfig:
    """Stage-0 / stage-1 backbone gains (b1, b2) and skip low-frequency
    scales (s1, s2). Defaults are the published SD-1.5 recommendation."""

    b1: float = 1.5
    b2: float = 1.6
    s1: float = 0.9
    s2: float = 0.2


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred low-frequency box [c - t, c + t) on each spatial
    axis of a [N, H, W, C] map: FFT over H and W in fp32, fftshift, scale,
    invert; the result in x's dtype. A scale of exactly 1.0 returns x
    itself, so identity configs are bit-exact."""
    if float(scale) == 1.0:
        return x
    xf = torch.fft.fftshift(torch.fft.fft2(x.float(), dim=(1, 2)), dim=(1, 2))
    _, H, W, _ = x.shape
    rows = torch.arange(H, device=x.device)
    cols = torch.arange(W, device=x.device)
    in_row = (rows >= H // 2 - threshold) & (rows < H // 2 + threshold)
    in_col = (cols >= W // 2 - threshold) & (cols < W // 2 + threshold)
    box = in_row[:, None] & in_col[None, :]
    mask = torch.where(box, torch.tensor(scale, dtype=torch.float32, device=x.device),
                       torch.tensor(1.0, dtype=torch.float32, device=x.device))
    xf = xf * mask[None, :, :, None]
    out = torch.fft.ifft2(torch.fft.ifftshift(xf, dim=(1, 2)), dim=(1, 2)).real
    return out.to(x.dtype)


def apply_freeu(stage_idx: int, x: torch.Tensor, skip: torch.Tensor,
                cfg: FreeUConfig):
    """FreeU for one up-block (backbone x, skip) pair -> (x, skip). Up
    stages 0 and 1 only; later stages pass through untouched."""
    if stage_idx == 0:
        b, s = cfg.b1, cfg.s1
    elif stage_idx == 1:
        b, s = cfg.b2, cfg.s2
    else:
        return x, skip
    half = x.shape[-1] // 2
    if float(b) != 1.0:
        gain = torch.tensor(b, dtype=x.dtype, device=x.device)
        x = torch.cat([x[..., :half] * gain, x[..., half:]], dim=-1)
    return x, fourier_filter(skip, threshold=1, scale=s)
