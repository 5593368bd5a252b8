"""Build and load the port's CUDA kernels (``csrc/*.cu``).

One ``nvcc`` call compiles every source under ``vdx_torch/csrc`` into
``vdx_torch/_build/libvdx_torch_kernels.so`` — plain C entry points, no
PyTorch headers, no CUTLASS — which is then loaded with ``ctypes``. The
build runs at first use and is skipped when the library exists and the
hash of the sources (and flags) matches the stamp beside it.

A missing ``nvcc`` or a failed build raises: no caller gives way to a
plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libvdx_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry point -> argtypes. Every entry point returns cudaGetLastError().
_SIGNATURES = {
    # q, k, v, o, B, Sq, Skv, H, D, q strides (b, s, h), k strides, v
    # strides, o strides, q_mult, stream
    "vdx_flash_attention_dt_staticmax_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_F, _P],
    # x, scale, bias, y, B, S, C, G, eps, silu, stream
    "vdx_group_norm_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "vdx_group_norm_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, scale, bias, y, partials, B, S, C, G, rows_per_chunk, eps, silu, stream
    "vdx_group_norm_2phase_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _I, _P],
    "vdx_group_norm_2phase_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                   _I, _P],
}

_lib = None
build_info: dict = {}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "vdx_torch CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless the cached one
    matches the sources. Records ``build_s`` and ``cached`` in
    ``build_info``."""
    so = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = sources_hash()
    t0 = time.time()
    if so.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        build_info.update(cached=True, build_s=time.time() - t0, path=str(so))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / (LIB_NAME + f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc {res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, so)
    stamp.write_text(digest)
    build_info.update(cached=False, build_s=time.time() - t0, path=str(so),
                      nvcc_output=(res.stdout + res.stderr).strip())
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = _I
        handle.vdx_error_string.argtypes = [_I]
        handle.vdx_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = _lib.vdx_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
