"""Backward warping for the warp error (port of vdx/metrics/warp.py).

The reference warps with ``F.grid_sample(mode='bilinear',
padding_mode='border', align_corners=True)`` (reference
experiments/06_measure_grid_search.py:259-284), vdx with
``map_coordinates(order=1, mode='nearest')``: bilinear interpolation at
unnormalised pixel coordinates with edge-clamped sampling. The port
computes vdx's operator as an explicit gather, in its order: the floor of
each coordinate, weights 1 - frac and frac, the four corner indices
clamped to the frame, then ((w00 f00 + w01 f01) + w10 f10) + w11 f11 with
w = w_y * w_x. A flow that points out of the frame samples its edge.

grid_sample would first normalise x to 2x / (W - 1) - 1 and back, which
moves the coordinate by up to 1.5e-5 px at W = 512 before the weights
are taken: its warped pixels sat up to 1.4e-5 from vdx's on random
frames and flows, the gather's up to 1.8e-7 (fp32 on the CPU).

Every pair is warped in one batched call on the frames' device.
"""

from __future__ import annotations

import torch


def _warp(frames: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """[P, H, W, C] frames backward-warped by [P, H, W, 2] flows (dx, dy)
    -> [P, H, W, C] fp32."""
    P, H, W, C = frames.shape
    dev = frames.device
    gy = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1)
    gx = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W)
    flows = flows.to(device=dev, dtype=torch.float32)
    sy = gy + flows[..., 1]
    sx = gx + flows[..., 0]

    def nodes(coord, size):
        lower = torch.floor(coord)
        w_hi = coord - lower
        w_lo = 1 - w_hi
        idx = lower.to(torch.int64)
        return ((idx.clamp(0, size - 1), w_lo),
                ((idx + 1).clamp(0, size - 1), w_hi))

    src = frames.float().reshape(P, H * W, C)
    out = None
    for iy, wy in nodes(sy, H):
        for ix, wx in nodes(sx, W):
            flat = (iy * W + ix).reshape(P, H * W, 1).expand(P, H * W, C)
            term = (wy * wx).unsqueeze(-1) * torch.gather(src, 1, flat).view(
                P, H, W, C)
            out = term if out is None else out + term
    return out


def warp_frame(frame: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``frame`` [H, W, C] by ``flow`` [H, W, 2] (dx, dy)."""
    return _warp(frame[None], flow[None])[0]


def warp_error_pairs(frames: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """[F, H, W, C] frames and [F-1, H, W, 2] flows -> [F-1] warp MSE:
    MSE(warp(frame_i, flow_i), frame_{i+1}) (06:336-338), every pair in
    one batched gather."""
    d = _warp(frames[:-1], flows) - frames[1:].float()
    return (d * d).mean(dim=(1, 2, 3))
