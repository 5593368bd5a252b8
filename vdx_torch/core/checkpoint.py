"""Checkpoints: torch ``.safetensors`` files into the port's modules (port
of vdx/core/convert.py's ``convert_checkpoint`` and of the merge in vdx's
``load_pretrained``).

The port's modules already carry diffusers' names, so loading a torch
checkpoint is a name- and shape-checked copy into ``state_dict()``. Its
report is vdx's, string for string: the module's weights are walked in
vdx's order (its sorted slash paths, through the port's copy of the rule
tables, core/convert.py), missing keys read ``checkpoint missing <key>
(for <vdx path>)`` and shape errors give vdx's [in, out] / HWIO shapes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from vdx_torch.core.convert import t_conv, t_dense
from vdx_torch.core.safetensors_io import load_file


def _vdx_shape(tr, shape) -> tuple:
    """A torch-layout shape as vdx's rule ``tr`` lays it out."""
    shape = tuple(int(d) for d in shape)
    if tr is t_conv and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    if tr is t_dense and len(shape) == 2:
        return shape[::-1]
    return shape


def merge_sources(component: str, sources, device="cpu") -> Dict[str, object]:
    """One state dict from a path, a state dict, or a list of them (the
    SD-1.5 UNet and the motion adapter are two files); overlapping keys
    raise."""
    if isinstance(sources, (str, dict)) or hasattr(sources, "__fspath__"):
        sources = [sources]
    sd: dict = {}
    for p in sources:
        part = p if isinstance(p, dict) else load_file(p, device)
        overlap = set(sd) & set(part)
        if overlap:
            raise ValueError(f"{component}: overlapping checkpoint keys "
                             f"{sorted(overlap)[:5]}")
        sd.update(part)
    return sd


def convert_checkpoint(state_dict: Mapping, template: Mapping[str, torch.Tensor],
                       rules: Mapping) -> Tuple[Dict[str, object], dict]:
    """The checkpoint's tensors for ``template``'s keys (a module's
    state_dict), and vdx's report: ``missing``, ``shape_errors``,
    ``unused_checkpoint_keys``. Tensors keep their dtype here;
    ``load_state_dict`` casts them to each parameter's."""
    inverse = {hf: (path, tr) for path, (hf, tr) in rules.items()}
    walk = sorted((inverse[k][0], k, inverse[k][1]) if k in inverse
                  else (k, k, None) for k in template)
    out, missing, shape_errors, used = {}, [], [], set()
    for path, key, tr in walk:
        if tr is None:
            missing.append(f"no rule for {path}")
            continue
        if key not in state_dict:
            missing.append(f"checkpoint missing {key} (for {path})")
            continue
        w = state_dict[key]
        used.add(key)
        if tuple(w.shape) != tuple(template[key].shape):
            shape_errors.append(f"{path}: got {_vdx_shape(tr, w.shape)}, "
                                f"want {_vdx_shape(tr, template[key].shape)}")
            continue
        out[key] = w
    report = {"missing": missing, "shape_errors": shape_errors,
              "unused_checkpoint_keys": sorted(set(state_dict) - used)}
    return out, report

