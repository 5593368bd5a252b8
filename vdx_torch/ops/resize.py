"""Bilinear image resizes with antialiasing, as two references compute
them, without their packages:

* :func:`resize_bilinear` — ``jax.image.resize(x, shape, "bilinear")``
  (antialias on): a triangle filter widened by the scale when it
  downscales, as separable weight matrices in fp32 (vdx's SVD resizes the
  conditioning image to the CLIP vision tower's 224 x 224 this way).
* :func:`resize_bilinear_u8` — Pillow's ``Image.resize(size,
  Image.BILINEAR)`` of an 8-bit RGB image: the same filter family with
  Pillow's support rounding, coefficients in 22-bit fixed point, a
  horizontal then a vertical pass, each rounded and clipped to uint8
  (vdx's ``Img2VidService`` resizes a client's image this way; the card's
  machine has no Pillow).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def _jax_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """jax.image's ``compute_weight_mat`` for the triangle kernel with
    antialias: [in_size, out_size] fp32, columns summing to 1."""
    inv_scale = 1.0 / (out_size / in_size)  # vdx's Python-float scale
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W, C] float -> [B, height, width, C] as
    ``jax.image.resize(x, (B, height, width, C), "bilinear")``; an axis
    whose size does not change is left as it is."""
    x = x.float()
    B, H, W, C = x.shape
    if H != height:
        x = torch.einsum("bhwc,hy->bywc", x, _jax_weights(H, height, x.device))
    if W != width:
        x = torch.einsum("bhwc,wx->bhxc", x, _jax_weights(W, width, x.device))
    return x


# Pillow's fixed point for 8-bit images (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _pil_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter (support 1)
    and ``normalize_coeffs_8bpc``: -> (first input index [out], int64
    coefficients [out, ksize]) in 22-bit fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = np.array([max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
                      for x in range(xmax)])
        total = w.sum()
        if total != 0.0:
            w = w / total
        scaled = w * (1 << _PRECISION_BITS)
        kk[xx, :xmax] = np.where(scaled < 0, np.trunc(scaled - 0.5),
                                 np.trunc(scaled + 0.5)).astype(np.int64)
        xmins[xx] = xmin
    return xmins, kk


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's 8-bit resampling passes along ``axis`` of a uint8
    [H, W, C] image."""
    xmins, kk = _pil_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    n = src.shape[0]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmins + k, n - 1)  # a zero coefficient past the end
        acc += src[idx] * kk[:, k].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [height, width, 3] as Pillow's
    ``Image.fromarray(img).resize((width, height), Image.BILINEAR)``:
    the horizontal pass first, then the vertical, each only where the
    size changes."""
    out = np.asarray(img, np.uint8)
    if out.shape[1] != width:
        out = _pil_pass(out, width, axis=1)
    if out.shape[0] != height:
        out = _pil_pass(out, height, axis=0)
    return np.ascontiguousarray(out)
