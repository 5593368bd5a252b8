"""LoRA adapters: low-rank weight deltas on attention projections (port of
vdx/core/lora.py).

LoRA is a weight-space transform: ``merge_lora`` makes ``W' = W + scale *
delta`` on every adapted weight, in fp32, cast back to W's dtype, so the
denoising loop is unchanged and pays nothing per step.

Representation, as vdx's: ``{key: {"a": [in, r], "b": [r, out]}}``, with
``a`` and ``b`` in vdx's [in, out] orientation (``a = A^T * alpha / r``,
``b = B^T`` for a torch checkpoint's A [r, in] and B [out, r]). The keys
are the port's state_dict names (diffusers'), so in the port's [out, in]
layout ``delta = (a @ b)^T``. Sites are walked in vdx's order (its sorted
slash paths, found through the port's copy of the rule tables,
core/convert.py), so one seed draws vdx's adapter.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

#: attention projections, the standard LoRA target set (q/k/v/out), and
#: what AnimateDiff motion LoRAs adapt (motion blocks included)
DEFAULT_TARGETS: Tuple[str, ...] = (
    "to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight",
)


def _vdx_paths(rules: Optional[Mapping]) -> Dict[str, str]:
    """{port key: vdx slash path} from a rule table."""
    return {hf: path for path, (hf, _) in (rules or {}).items()}


def target_paths(state: Mapping[str, torch.Tensor],
                 targets: Sequence[str] = DEFAULT_TARGETS,
                 rules: Optional[Mapping] = None) -> "list[str]":
    """The 2-D weights of ``state`` whose key ends with one of
    ``targets``, in vdx's order: sorted by vdx's path through ``rules``
    (by key where a key has no rule)."""
    order = _vdx_paths(rules)
    keys = [k for k, v in state.items()
            if v.dim() == 2 and any(k.endswith(t) for t in targets)]
    return sorted(keys, key=lambda k: order.get(k, k))


def init_lora(state: Mapping[str, torch.Tensor], rank: int = 4,
              targets: Sequence[str] = DEFAULT_TARGETS, seed: int = 0,
              rules: Optional[Mapping] = None,
              dtype: torch.dtype = torch.float32) -> dict:
    """A fresh adapter over ``state``: ``a ~ N(0, 1/d_in)`` from numpy's
    generator in vdx's site order, ``b = 0``, so it is an exact no-op
    until trained."""
    paths = target_paths(state, targets, rules)
    if not paths:
        raise ValueError(f"no 2-D kernels match targets {tuple(targets)}")
    rng = np.random.default_rng(seed)
    tree = {}
    for p in paths:
        d_out, d_in = state[p].shape
        a = rng.standard_normal((d_in, rank), dtype=np.float32)
        a *= (1.0 / d_in) ** 0.5
        tree[p] = {"a": torch.from_numpy(a).to(dtype),
                   "b": torch.zeros((rank, d_out), dtype=dtype)}
    return tree


def merge_lora(state: Mapping[str, torch.Tensor], lora: dict,
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """``{key: W + scale * (a @ b)^T}`` for every site of ``lora``: fp32
    math on W's device, cast back to W's dtype. Only the adapted keys are
    returned. A pure function that autograd follows: gradients of the
    merged weights reach ``a`` and ``b`` (LoRA training, vdx's
    ``make_lora_train_step``); inference callers run it under
    ``torch.no_grad()``."""
    out = {}
    s = torch.tensor(float(scale), dtype=torch.float32)
    for p, site in lora.items():
        if p not in state:
            raise KeyError(f"LoRA site {p!r} has no matching param leaf "
                           f"(adapter built for a different architecture?)")
        W = state[p]
        a = torch.as_tensor(site["a"]).to(W.device, torch.float32)
        b = torch.as_tensor(site["b"]).to(W.device, torch.float32)
        if tuple(W.shape) != (b.shape[1], a.shape[0]):
            raise ValueError(
                f"LoRA site {p!r}: delta shape {(a.shape[0], b.shape[1])} "
                f"!= kernel shape {tuple(W.shape[::-1])}")
        delta = (a @ b).T
        out[p] = (W.float() + s.to(W.device) * delta).to(W.dtype)
    return out


def save_lora(lora: dict, path) -> None:
    """An adapter tree to a peft-keyed ``.safetensors`` file that
    ``load_lora`` (and :func:`convert_lora_checkpoint`) reads back exactly:
    ``<stem>.lora_A.weight`` = a^T [r, in], ``<stem>.lora_B.weight`` =
    b^T [out, r], alpha left at r (so a = A^T)."""
    from vdx_torch.core.safetensors_io import save_file

    tensors = {}
    for p, site in lora.items():
        stem = p[: -len(".weight")]
        tensors[f"{stem}.lora_A.weight"] = site["a"].detach().T.contiguous()
        tensors[f"{stem}.lora_B.weight"] = site["b"].detach().T.contiguous()
    save_file(tensors, path, metadata={"format": "pt"})


# ----------------------------------------------------------------------
# torch LoRA checkpoints (peft, old diffusers attention processors, kohya)
# ----------------------------------------------------------------------

_LORA_KEY_MARKERS = (
    "lora_A", "lora_B", "lora_down", "lora_up", "lora.down", "lora.up",
    "_lora.down", "_lora.up",
)


def is_lora_state_dict(sd) -> bool:
    """True when ``sd`` looks like a torch LoRA checkpoint (any format)."""
    return isinstance(sd, dict) and any(
        isinstance(k, str) and any(m in k for m in _LORA_KEY_MARKERS)
        for k in sd)


def _strip_prefix(sd: dict) -> dict:
    """Drop a uniform ``unet.`` key prefix (pipeline-level LoRA files)."""
    if sd and all(k.startswith("unet.") for k in sd):
        return {k[len("unet."):]: v for k, v in sd.items()}
    return sd


def _processor_stem(stem: str) -> Optional[str]:
    """Old diffusers attention-processor form: ``...attn1.to_q`` ->
    ``...attn1.processor.to_q_lora`` (to_out.0 -> to_out_lora)."""
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        suffix = "." + proj
        if stem.endswith(suffix):
            parent = stem[: -len(suffix)]
            return f"{parent}.processor.{proj.split('.')[0]}_lora"
    return None


def _candidate_keys(base_key: str):
    """(A key, B key, alpha key) candidates of one site, from its base
    weight's key: peft, old diffusers processor, kohya."""
    assert base_key.endswith(".weight"), base_key
    stem = base_key[: -len(".weight")]
    cands = [
        (f"{stem}.lora_A.weight", f"{stem}.lora_B.weight", None),
        (f"{stem}.lora_A.default.weight", f"{stem}.lora_B.default.weight", None),
        (f"{stem}.lora.down.weight", f"{stem}.lora.up.weight", None),
    ]
    proc = _processor_stem(stem)
    if proc is not None:
        cands.append((f"{proc}.down.weight", f"{proc}.up.weight", None))
    mangled = "lora_unet_" + stem.replace(".", "_")
    cands.append((f"{mangled}.lora_down.weight", f"{mangled}.lora_up.weight",
                  f"{mangled}.alpha"))
    return cands


def _np32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def convert_lora_checkpoint(state_dict: Mapping, template: Mapping[str, torch.Tensor],
                            targets: Sequence[str] = DEFAULT_TARGETS,
                            strict: bool = True,
                            rules: Optional[Mapping] = None) -> Tuple[dict, dict]:
    """A torch LoRA state dict -> the adapter tree over ``template`` (the
    module's state_dict). Walks the target weights, tries each format's
    keys for each, and converts ``a = A^T * (alpha / r)``, ``b = B^T``
    (alpha defaults to r), in fp32 numpy as vdx. Sites with no keys are
    skipped. -> (tree, report) with vdx's report keys ``converted``,
    ``skipped``, ``shape_errors``, ``unused_lora_keys`` (port keys where
    vdx names its paths). strict raises on shape errors and on LoRA keys
    that no site used; no site at all always raises."""
    sd = _strip_prefix(dict(state_dict))
    paths = target_paths(template, targets, rules)
    tree: dict = {}
    used: set = set()
    skipped, shape_errors = [], []
    for p in paths:
        site = None
        for a_key, b_key, alpha_key in _candidate_keys(p):
            if a_key in sd and b_key in sd:
                A = _np32(sd[a_key])  # [r, in]
                B = _np32(sd[b_key])  # [out, r]
                r = A.shape[0]
                d_out, d_in = template[p].shape
                used.update({a_key, b_key})
                if alpha_key is not None and alpha_key in sd:
                    used.add(alpha_key)
                if A.shape != (r, d_in) or B.shape != (d_out, r):
                    shape_errors.append(
                        f"{p}: A {A.shape} / B {B.shape} do not factor the "
                        f"[{d_in}, {d_out}] kernel")
                    break
                alpha = (float(_np32(sd[alpha_key]))
                         if alpha_key is not None and alpha_key in sd else float(r))
                site = {"a": torch.from_numpy(np.ascontiguousarray(A.T * (alpha / r))),
                        "b": torch.from_numpy(np.ascontiguousarray(B.T))}
                break
        if site is None:
            skipped.append(p)
        else:
            tree[p] = site
    unused = sorted(k for k in sd if k not in used
                    and any(m in k for m in _LORA_KEY_MARKERS))
    report = {"converted": [p for p in paths if p in tree], "skipped": skipped,
              "shape_errors": shape_errors, "unused_lora_keys": unused}
    if strict and shape_errors:
        raise ValueError("LoRA factor shapes do not match their target kernels:\n"
                         + "\n".join(shape_errors[:10]))
    if not tree:
        raise ValueError(
            "no LoRA site in the checkpoint matched any target kernel — "
            f"formats tried: peft/diffusers/kohya; targets={tuple(targets)}")
    if strict and unused:
        raise ValueError(
            f"{len(unused)} LoRA checkpoint keys matched no target site "
            f"(first few: {unused[:5]}) — pass strict=False to ignore")
    return tree, report
