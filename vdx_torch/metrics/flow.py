"""Optical-flow backends (port of vdx/metrics/flow.py).

The reference estimates flow with OpenCV's Farnebäck (experiments/06:157-199).
The port has vdx's two implementations of it:

  * "native": the repository's C++ library, ``native/farneback.cpp``,
    compiled by the host's ``g++`` with ``native/build.sh``'s flags at
    first use into ``vdx_torch/_build/libvdxflow.so`` (cached by a hash of
    the source, the flags and the host CPU, since ``-march=native``) and
    loaded with ctypes; asked for by name, it builds or raises;
  * "numpy": vdx_torch.metrics.farneback, always there;
  * "auto": native if it builds on this host, else numpy.

Flow runs on the host: the grayscale input is the reference's (the channel
mean times 255, truncated to uint8, in numpy), so the flows are vdx's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from vdx_torch.metrics import farneback as _np_backend

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "farneback.cpp"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libvdxflow.so"
CXX = "g++"
# native/build.sh's flags
CXX_FLAGS = ["-O3", "-march=native", "-ffast-math", "-fno-finite-math-only",
             "-fopenmp", "-shared", "-fPIC"]

_native: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_info: dict = {}


def _host_cpu() -> bytes:
    """The CPU's model and feature flags: ``-march=native`` code built on
    one host may not run on another."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def build_native() -> Path:
    """Compile ``native/farneback.cpp`` unless the cached library matches
    the source, the flags and the host CPU; raises if there is no
    compiler or the build fails. Records ``build_s`` and ``cached`` in
    ``build_info``."""
    so, stamp = BUILD_DIR / LIB_NAME, BUILD_DIR / (LIB_NAME + ".sha256")
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found: the native flow backend "
                           "builds from the repository's native/ sources")
    h = hashlib.sha256(" ".join([CXX] + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_cpu())
    digest = h.hexdigest()
    t0 = time.time()
    if so.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        build_info.update(cached=True, build_s=time.time() - t0, path=str(so))
        return so
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the native flow backend "
                           "cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native flow build failed (rc {res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    stamp.write_text(digest)
    build_info.update(cached=False, build_s=time.time() - t0, path=str(so),
                      command=" ".join(cmd))
    return so


def native_lib() -> ctypes.CDLL:
    """The loaded native library, built on first use."""
    global _native
    with _lock:
        if _native is None:
            lib = ctypes.CDLL(str(build_native()))
            lib.vdx_farneback_flow.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),  # prev
                ctypes.POINTER(ctypes.c_uint8),  # curr
                ctypes.c_int,  # H
                ctypes.c_int,  # W
                ctypes.c_double,  # pyr_scale
                ctypes.c_int,  # levels
                ctypes.c_int,  # winsize
                ctypes.c_int,  # iterations
                ctypes.c_int,  # poly_n
                ctypes.c_double,  # poly_sigma
                ctypes.POINTER(ctypes.c_float),  # out flow [H, W, 2]
            ]
            lib.vdx_farneback_flow.restype = ctypes.c_int
            _native = lib
        return _native


class OpticalFlowEstimator:
    """The reference's estimator (06:157-199): ``backend`` "native",
    "numpy" or "auto" (native if it builds here, else numpy)."""

    def __init__(self, backend: str = "auto"):
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown flow backend {backend!r}")
        if backend == "auto":
            try:
                native_lib()
                backend = "native"
            except RuntimeError as e:
                build_info["auto_fallback"] = str(e)
                backend = "numpy"
        elif backend == "native":
            native_lib()
        self.backend = backend

    def compute_flow(self, frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
        """Frames [H, W, C] float in [0, 1] -> flow [H, W, 2] (dx, dy).

        Grayscale as the reference's: the channel MEAN (not luma) times
        255, truncated to uint8 (06:173-174)."""
        gray1 = (frame1.mean(axis=-1) * 255).astype(np.uint8)
        gray2 = (frame2.mean(axis=-1) * 255).astype(np.uint8)
        return self.compute_flow_gray(gray1, gray2)

    def compute_flow_gray(self, gray1: np.ndarray, gray2: np.ndarray) -> np.ndarray:
        if self.backend == "numpy":
            return _np_backend.calc_flow(gray1, gray2)
        H, W = gray1.shape
        out = np.empty((H, W, 2), dtype=np.float32)
        g1 = np.ascontiguousarray(gray1, dtype=np.uint8)
        g2 = np.ascontiguousarray(gray2, dtype=np.uint8)
        if g2.shape != (H, W):
            raise ValueError(f"gray frames differ in shape: {g1.shape} {g2.shape}")
        rc = native_lib().vdx_farneback_flow(
            g1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            g2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            H, W, 0.5, 3, 15, 3, 5, 1.2,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(f"vdx_farneback_flow failed: {rc}")
        return out

    def compute_flow_stats(self, flow: np.ndarray) -> dict:
        return _np_backend.flow_stats(flow)
