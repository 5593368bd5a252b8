"""Farnebäck dense optical flow — from-scratch reimplementation (a copy of
vdx/metrics/farneback.py, numpy and scipy only: the same flows, bit for
bit).

Replaces the reference's only true native-compute dependency,
``cv2.calcOpticalFlowFarneback`` (reference
experiments/06_measure_grid_search.py:176-187, params pyr_scale=0.5,
levels=3, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2, flags=0),
with the same algorithm (Farnebäck 2003: quadratic polynomial expansion +
iterative displacement estimation over an image pyramid), engineered to track
OpenCV's numerics:

  * identical Gaussian applicability and 6x6 Gram-matrix inversion constants
  * separable correlation polynomial expansion with replicate borders
  * bilinearly-displaced matrix update with OpenCV's border down-weighting
    (5-pixel apron, weights 0.14/0.4472...)
  * box-filtered 2x2 solve with the +1e-3 determinant regulariser
  * pyramid built by Gaussian-smoothing + bilinear resize of the *original*
    image per level (sigma = (1/scale - 1)/2), flow upscaled by 1/pyr_scale

Backends: this numpy module is the reference implementation; the C++ library
(native/farneback.cpp, built with g++ into libvdxflow.so and loaded via
ctypes in vdx_torch.metrics.flow) is the production host path for batch
measurement.
"""

from __future__ import annotations

import functools


import numpy as np
from scipy.ndimage import correlate1d

BORDER = 5
# OpenCV's edge down-weighting ramp inside FarnebackUpdateMatrices.
_BORDER_W = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _prepare_gaussian(n: int, sigma: float):
    """Applicability kernels g, x*g, x^2*g and the needed inv-Gram entries."""
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    xg = x * g
    xxg = x**2 * g

    # Gram matrix for basis [1, x, y, x^2, y^2, xy] under w(x,y)=g(x)g(y).
    X, Y = np.meshgrid(x, x)
    W = np.outer(g, g)
    basis = [np.ones_like(X), X, Y, X**2, Y**2, X * Y]
    G = np.zeros((6, 6))
    for i in range(6):
        for j in range(6):
            G[i, j] = np.sum(W * basis[i] * basis[j])
    invG = np.linalg.inv(G)
    ig11, ig03, ig33, ig55 = invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        float(ig11),
        float(ig03),
        float(ig33),
        float(ig55),
    )


def poly_exp(img: np.ndarray, n: int, sigma: float) -> np.ndarray:
    """Quadratic expansion. [H, W] float32 -> [H, W, 5] = (r2..r6) =
    coefficients of (x, y, x^2, y^2, xy)."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _prepare_gaussian(n, sigma)
    f = img.astype(np.float32)

    # vertical (y) moments
    b0 = correlate1d(f, g, axis=0, mode="nearest")
    b1 = correlate1d(f, xg, axis=0, mode="nearest")
    b2 = correlate1d(f, xxg, axis=0, mode="nearest")
    # horizontal (x) moments
    s_g = correlate1d(b0, g, axis=1, mode="nearest")  # plain weighted mean
    s_x = correlate1d(b0, xg, axis=1, mode="nearest")  # x moment
    s_xx = correlate1d(b0, xxg, axis=1, mode="nearest")  # x^2 moment
    s_y = correlate1d(b1, g, axis=1, mode="nearest")  # y moment
    s_xy = correlate1d(b1, xg, axis=1, mode="nearest")  # xy moment
    s_yy = correlate1d(b2, g, axis=1, mode="nearest")  # y^2 moment

    R = np.empty(img.shape + (5,), dtype=np.float32)
    R[..., 0] = s_x * ig11  # x coefficient
    R[..., 1] = s_y * ig11  # y coefficient
    R[..., 2] = s_g * ig03 + s_xx * ig33  # x^2
    R[..., 3] = s_g * ig03 + s_yy * ig33  # y^2
    R[..., 4] = s_xy * ig55  # xy
    return R


def _update_matrices(R0: np.ndarray, R1: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Build the per-pixel 2x2 normal equations M = [g11 g12 g22 h1 h2]."""
    H, W = flow.shape[:2]
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    dx, dy = flow[..., 0], flow[..., 1]
    fx = gx + dx
    fy = gy + dy
    x1 = np.floor(fx).astype(np.int64)
    y1 = np.floor(fy).astype(np.int64)
    fx -= x1
    fy -= y1

    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    x1c = np.clip(x1, 0, W - 2)
    y1c = np.clip(y1, 0, H - 2)

    a00 = (1 - fx) * (1 - fy)
    a01 = fx * (1 - fy)
    a10 = (1 - fx) * fy
    a11 = fx * fy
    r_interp = (
        a00[..., None] * R1[y1c, x1c]
        + a01[..., None] * R1[y1c, x1c + 1]
        + a10[..., None] * R1[y1c + 1, x1c]
        + a11[..., None] * R1[y1c + 1, x1c + 1]
    )

    r2 = np.where(inside, r_interp[..., 0], 0.0)
    r3 = np.where(inside, r_interp[..., 1], 0.0)
    r4 = np.where(inside, (R0[..., 2] + r_interp[..., 2]) * 0.5, R0[..., 2])
    r5 = np.where(inside, (R0[..., 3] + r_interp[..., 3]) * 0.5, R0[..., 3])
    r6 = np.where(inside, (R0[..., 4] + r_interp[..., 4]) * 0.25, R0[..., 4] * 0.5)

    r2 = (R0[..., 0] - r2) * 0.5
    r3 = (R0[..., 1] - r3) * 0.5
    r2 = r2 + r4 * dx + r6 * dy
    r3 = r3 + r6 * dx + r5 * dy

    # border down-weighting (5-pixel apron)
    wx = np.ones(W, dtype=np.float32)
    wy = np.ones(H, dtype=np.float32)
    nb = min(BORDER, W // 2)
    wx[:nb] *= _BORDER_W[:nb]
    wx[W - nb:] *= _BORDER_W[:nb][::-1]
    nb = min(BORDER, H // 2)
    wy[:nb] *= _BORDER_W[:nb]
    wy[H - nb:] *= _BORDER_W[:nb][::-1]
    scale = wy[:, None] * wx[None, :]
    r2, r3, r4, r5, r6 = (r * scale for r in (r2, r3, r4, r5, r6))

    M = np.empty((H, W, 5), dtype=np.float32)
    M[..., 0] = r4 * r4 + r6 * r6  # g11
    M[..., 1] = (r4 + r5) * r6  # g12
    M[..., 2] = r5 * r5 + r6 * r6  # g22
    M[..., 3] = r4 * r2 + r6 * r3  # h1
    M[..., 4] = r6 * r2 + r5 * r3  # h2
    return M


def _update_flow_box(M: np.ndarray, winsize: int) -> np.ndarray:
    """Box-blur M and solve the 2x2 system per pixel (flags=0 path)."""
    scale = 1.0 / (winsize * winsize)
    Mb = np.stack(
        [
            correlate1d(
                correlate1d(M[..., c], np.ones(winsize, np.float32), axis=0, mode="nearest"),
                np.ones(winsize, np.float32), axis=1, mode="nearest",
            )
            for c in range(5)
        ],
        axis=-1,
    ) * scale
    g11, g12, g22, h1, h2 = (Mb[..., i].astype(np.float64) for i in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    flow = np.empty(M.shape[:2] + (2,), dtype=np.float32)
    # channel order here: (r2,h1)=x equation, (r3,h2)=y equation
    flow[..., 0] = (g22 * h1 - g12 * h2) * idet
    flow[..., 1] = (g11 * h2 - g12 * h1) * idet
    return flow


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize INTER_LINEAR semantics (half-pixel centers, edge clamp)."""
    H, W = img.shape[:2]
    ys = (np.arange(out_h, dtype=np.float64) + 0.5) * (H / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float64) + 0.5) * (W / out_w) - 0.5
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    wy = (ys - y0).astype(np.float32)
    wx = (xs - x0).astype(np.float32)
    y0c = np.clip(y0, 0, H - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    x0c = np.clip(x0, 0, W - 1)
    x1c = np.clip(x0 + 1, 0, W - 1)

    def gather(a):
        top = a[y0c][:, x0c] * (1 - wx)[None, :] + a[y0c][:, x1c] * wx[None, :]
        bot = a[y1c][:, x0c] * (1 - wx)[None, :] + a[y1c][:, x1c] * wx[None, :]
        return top * (1 - wy)[:, None] + bot * wy[:, None]

    if img.ndim == 2:
        return gather(img.astype(np.float32))
    return np.stack([gather(img[..., c].astype(np.float32)) for c in range(img.shape[-1])], -1)


# OpenCV getGaussianKernel's hardcoded kernels for ksize<=7 when sigma<=0.
_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125], np.float32),
}


def _gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur semantics incl. sigma<=0 small-kernel table;
    REFLECT_101 border (scipy 'mirror')."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        k = _SMALL_GAUSSIAN[ksize]
    else:
        if sigma <= 0:
            sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
        half = (ksize - 1) // 2
        x = np.arange(-half, half + 1, dtype=np.float64)
        k = np.exp(-(x**2) / (2 * sigma**2))
        k = (k / k.sum()).astype(np.float32)
    out = correlate1d(img.astype(np.float32), k, axis=0, mode="mirror")
    return correlate1d(out, k, axis=1, mode="mirror")


def calc_flow(
    prev: np.ndarray,
    curr: np.ndarray,
    pyr_scale: float = 0.5,
    levels: int = 3,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
) -> np.ndarray:
    """Dense flow [H, W, 2] (dx, dy) from two grayscale uint8/float images."""
    prev = prev.astype(np.float32)
    curr = curr.astype(np.float32)
    H, W = prev.shape

    # Cap pyramid depth so the coarsest level is still bigger than the window
    # (OpenCV's min_size=32 guard).
    k0 = 0
    for k0 in range(levels, -1, -1):
        scale = pyr_scale**k0
        if min(H, W) * scale >= 2 * winsize:
            break

    flow = None
    for k in range(k0, -1, -1):
        scale = pyr_scale**k
        h = int(round(H * scale))
        w = int(round(W * scale))

        if flow is None:
            flow = np.zeros((h, w, 2), dtype=np.float32)
        else:
            flow = _resize_bilinear(flow, h, w) * (1.0 / pyr_scale)

        imgs = []
        for src in (prev, curr):
            # OpenCV smooths at EVERY level: at scale==1 this is ksize=3,
            # sigma=0 -> the hardcoded [0.25, 0.5, 0.25] kernel.
            sigma = (1.0 / scale - 1.0) * 0.5
            smooth_sz = max(int(round(sigma * 5)) | 1, 3)
            s = _gaussian_blur(src, smooth_sz, sigma)
            imgs.append(_resize_bilinear(s, h, w) if scale < 1.0 else s)
        R0 = poly_exp(imgs[0], poly_n, poly_sigma)
        R1 = poly_exp(imgs[1], poly_n, poly_sigma)

        M = _update_matrices(R0, R1, flow)
        for it in range(iterations):
            flow = _update_flow_box(M, winsize)
            if it < iterations - 1:
                M = _update_matrices(R0, R1, flow)
    return flow


def flow_stats(flow: np.ndarray) -> dict:
    """Magnitude statistics (reference 06:189-199)."""
    mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    return {
        "magnitude_mean": float(mag.mean()),
        "magnitude_std": float(mag.std()),
        "magnitude_max": float(mag.max()),
        "magnitude_median": float(np.median(mag)),
    }
