""".safetensors files read and written without the ``safetensors`` package
(vdx reads them through ``safetensors.numpy``, vdx/core/convert.py; the
port keeps its own reader and writer so that it needs no package beyond
torch and numpy).

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{key: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings, padded with spaces), then the
tensors' raw little-endian bytes, each at its offsets into that buffer,
back to back with no gap.

    save_file({"w": tensor}, "model.safetensors", metadata={"format": "pt"})
    state = load_file("model.safetensors", device="cuda")
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

# safetensors dtype tag <-> torch dtype (BF16 is stored as its 16 bits);
# the dtypes of SD-1.5, motion-adapter and LoRA files
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64}
_TAGS = {v: k for k, v in _DTYPES.items()}
_MAX_HEADER = 100 * 2 ** 20  # the package's own limit


def _as_tensor(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def save_file(tensors: Mapping[str, object], path: Union[str, os.PathLike],
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``{name: tensor or numpy array}`` to ``path``; tensors on any
    device are copied to the host one at a time."""
    items = []
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in sorted(tensors):
        t = _as_tensor(tensors[name])
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors tag")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        items.append(t)
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in items:
            flat = t.detach().to("cpu").contiguous().reshape(-1)
            if flat.numel():
                f.write(flat.view(torch.uint8).numpy().data)


def read_header(path: Union[str, os.PathLike]) -> tuple:
    """-> (header dict without ``__metadata__``, metadata or None, the
    offset of the data buffer in the file)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n).decode("utf-8"))
    meta = header.pop("__metadata__", None)
    return header, meta, 8 + n


def load_file(path: Union[str, os.PathLike],
              device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` on ``device``, in the stored dtypes. The offsets
    are checked to tile the data buffer exactly, as the package does."""
    header, _, start = read_header(path)
    size = os.path.getsize(path) - start
    spans = sorted((tuple(info["data_offsets"]), name)
                   for name, info in header.items())
    end = 0
    for (b, e), name in spans:
        if b != end or e < b:
            raise ValueError(f"{path}: {name}'s offsets [{b}, {e}) leave a gap "
                             f"or overlap")
        end = e
    if end != size:
        raise ValueError(f"{path}: the data buffer holds {size} bytes, the "
                         f"header {end}")
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=start, shape=(size,)) \
        if size else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}")
        b, e = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if e - b != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name}'s {e - b} bytes do not hold "
                             f"{info['dtype']} {list(shape)}")
        raw = torch.from_numpy(np.array(data[b:e]))
        t = raw.view(dtype) if raw.numel() else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape).to(device)
    return out
