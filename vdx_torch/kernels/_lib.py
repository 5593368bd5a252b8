"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source under ``vdx_torch/csrc`` is compiled by its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects
into ``vdx_torch/_build/libvdx_torch_kernels.so`` — plain C entry points,
no PyTorch headers, no CUTLASS — which is then loaded with ``ctypes``.
The build runs at first use and is skipped when the library exists and
the hash of the sources (and flags) matches the stamp beside it. The
compilers' output (``-Xptxas -v``: registers, shared memory and spills of
every kernel) is kept in ``build_info["nvcc_output"]`` and in
``_build/nvcc.log``.

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
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]
# the TMA kernel finds the driver's tensor-map encoder with dlopen/dlsym
LINK_FLAGS = ["-ldl"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry point -> argtypes. Every entry point returns cudaGetLastError().
_SIGNATURES = {
    # q, k, v, o, B, Sq, Skv, H, D, q strides (b, s, h), k strides, v
    # strides, o strides, mult (scale * log2e), form (0 the running max of
    # K4 and exp, 1 K1's staticmax), stream
    "vdx_flash_attention_sm90": [_P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_F, _I, _P],
    # the same, then form (vdx's exp_impl code: 1 exp2, 2 fastexp2,
    # 4 staticaug, 5 noexp, 6 mxu_only), period (fastexp2's and noexp's
    # statistics period), stream
    "vdx_flash_attention_sm90_forms": [_P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_F, _I, _I, _P],
    # the same, then form (vdx's exp_impl: 0 exp,
    # 1 exp2, 2 fastexp2, 3 staticmax, 4 staticaug, 5 noexp, 6 mxu_only),
    # period (fastexp2's and noexp's statistics period), vec (16-byte row
    # loads), stream
    "vdx_flash_attention_mma_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_F, _I, _I, _I, _P],
    # the same without vec (fp32 operands)
    "vdx_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_F, _I, _I, _P],
    # q, k, v, o, P, F, H, D, q strides (p, f, h), k strides, v strides,
    # o strides, mult, mode (0 K6, 1 K7/K8, 2 K9), vec (16-byte row
    # loads), stream: bf16 K6-K8 on the tensor cores
    "vdx_temporal_attention_mma": [_P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 12
    + [_F, _I, _I, _P],
    # the same with bf16 (else fp32) before vec: K9, and fp32 K6-K8
    "vdx_temporal_attention_simt": [_P, _P, _P, _P, _I, _I, _I, _I]
    + [_L] * 12 + [_F, _I, _I, _I, _P],
    # x, scale, bias, y, B, S, C, G, stripe channels, cluster, rows a CTA,
    # box rows, threads, eps, silu, stream: K2, the one-pass cluster kernel
    "vdx_group_norm_cluster_f32": [_P, _P, _P, _P] + [_I] * 9 + [_F, _I, _P],
    "vdx_group_norm_cluster_bf16": [_P, _P, _P, _P] + [_I] * 9 + [_F, _I, _P],
    # x, scale, bias, y, partials, B, S, C, G, rows_per_chunk, eps, silu,
    # stream: K3, the streaming kernel
    "vdx_group_norm_stream_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _I, _P],
    "vdx_group_norm_stream_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                   _I, _P],
}

_lib = None
build_info: dict = {}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    matches the sources: one ``nvcc -c`` per source, run in parallel, then
    one link. Records ``build_s``, ``cached``, the commands and the
    compilers' output in ``build_info``."""
    so = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = sources_hash()
    t0 = time.time()
    if so.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        build_info.update(cached=True, build_s=time.time() - t0, path=str(so))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f".{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / (src.stem + tag + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc {proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    tmp = BUILD_DIR / (LIB_NAME + tag)
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs), *LINK_FLAGS]
        res = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"nvcc link failed (rc {res.returncode}): "
                          f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "\n".join(logs).strip()
    (BUILD_DIR / "nvcc.log").write_text(log + "\n")
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, so)
    stamp.write_text(digest)
    build_info.update(cached=False, build_s=time.time() - t0, path=str(so),
                      nvcc_output=log)
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
