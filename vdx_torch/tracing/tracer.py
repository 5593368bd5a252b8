"""ForwardTracer — model introspection through forward hooks (port of
vdx/tracing/tracer.py).

Records per-module input/output shapes and dtypes, parameter counts,
execution order and, optionally, the outputs; depth and predicate
filtering; a text report, a dict export and a shape-change scan; plus an
attention-only subclass. vdx intercepts Flax method calls; here every
submodule gets a ``register_forward_hook`` for the length of one
:meth:`ForwardTracer.trace`, removed when the trace ends, also when the
forward raises. Both record a module when its call returns, so children
come before their parents in the execution order.

Names are ``named_modules()``'s (diffusers' ``.``-joined names, "(root)"
for the model, where vdx has Flax's ``/``-joined paths); a module's
depth is its number of name parts ("down_blocks.0.resnets.1" has depth
4), as a Flax path's depth is its number of parts.

For device time see :func:`profile_trace` (torch.profiler, a Chrome
trace).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch


def _shape_of(x) -> Optional[tuple]:
    return tuple(x.shape) if hasattr(x, "shape") else None


def _dtype_of(x) -> Optional[str]:
    return str(x.dtype) if hasattr(x, "dtype") else None


def _flatten_arrays(tree) -> List[Any]:
    """Tensors in a nest of tuples, lists and dicts, in order."""
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _flatten_arrays(item)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_arrays(tree[k])]
    return [tree] if torch.is_tensor(tree) else []


def module_depth(name: str) -> int:
    """A module name's number of parts (0 for the model itself)."""
    return len(name.split(".")) if name else 0


@dataclasses.dataclass
class ModuleTrace:
    """One module invocation record."""

    name: str
    class_name: str
    input_shapes: List[tuple]
    output_shapes: List[tuple]
    input_dtypes: List[str]
    output_dtypes: List[str]
    param_count: int
    execution_order: int
    output: Optional[Any] = None


class ForwardTracer:
    """Trace a torch module's forward pass.

    Args:
        model: a ``torch.nn.Module``.
        trace_depth: max module depth to record (None = all).
        filter_fn: predicate(name, module) -> bool to select modules.
        capture_tensors: keep module outputs (memory-heavy).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        trace_depth: Optional[int] = None,
        filter_fn: Optional[Callable[[str, torch.nn.Module], bool]] = None,
        capture_tensors: bool = False,
    ):
        self.model = model
        self.trace_depth = trace_depth
        self.filter_fn = filter_fn
        self.capture_tensors = capture_tensors
        self.traces: Dict[str, ModuleTrace] = {}
        self.execution_order: List[str] = []

    # ------------------------------------------------------------------
    def _hook(self, name: str):
        path = name or "(root)"

        def record(module, args, out):
            in_arrays = _flatten_arrays(args)
            out_arrays = _flatten_arrays(out)
            self.traces[path] = ModuleTrace(
                name=path,
                class_name=type(module).__name__,
                input_shapes=[_shape_of(a) for a in in_arrays],
                output_shapes=[_shape_of(a) for a in out_arrays],
                input_dtypes=[_dtype_of(a) for a in in_arrays],
                output_dtypes=[_dtype_of(a) for a in out_arrays],
                param_count=sum(p.numel() for p in module.parameters()),
                execution_order=len(self.execution_order),
                output=out if self.capture_tensors else None,
            )
            self.execution_order.append(path)

        return record

    def trace(self, *args, **kwargs):
        """Run ``model(*args, **kwargs)`` with a forward hook on every
        selected module; returns the model output. The hooks are removed
        when the call ends, whether it returns or raises."""
        self.traces.clear()
        self.execution_order.clear()
        handles = []
        try:
            for name, module in self.model.named_modules():
                if self.trace_depth is not None \
                        and module_depth(name) > self.trace_depth:
                    continue
                if self.filter_fn is not None \
                        and not self.filter_fn(name or "(root)", module):
                    continue
                handles.append(module.register_forward_hook(self._hook(name)))
            return self.model(*args, **kwargs)
        finally:
            for h in handles:
                h.remove()

    # ------------------------------------------------------------------
    # Reports
    # ------------------------------------------------------------------
    def summary_lines(self) -> List[str]:
        lines = [
            f"Forward trace: {type(self.model).__name__}",
            f"Modules traced: {len(self.traces)}",
            "-" * 80,
        ]
        for name in self.execution_order:
            t = self.traces[name]
            lines.append(
                f"{t.execution_order:4d}. {t.class_name:<26} {name:<50} "
                f"in={t.input_shapes} out={t.output_shapes} params={t.param_count:,}"
            )
        return lines

    def print_summary(self) -> None:
        print("\n".join(self.summary_lines()))

    def find_shape_changes(self) -> List[str]:
        """Modules whose (first) output shape differs from input shape."""
        out = []
        for name in self.execution_order:
            t = self.traces[name]
            if t.input_shapes and t.output_shapes and t.input_shapes[0] != t.output_shapes[0]:
                out.append(name)
        return out

    def save_report(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(self.summary_lines()) + "\n")
        return path

    def to_dict(self) -> Dict:
        return {
            "model": type(self.model).__name__,
            "num_modules": len(self.traces),
            "execution_order": list(self.execution_order),
            "traces": {
                k: {
                    f.name: getattr(t, f.name)
                    for f in dataclasses.fields(ModuleTrace)
                    if f.name != "output"
                }
                for k, t in self.traces.items()
            },
        }

    def save_json(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2, default=str))
        return path


class AttentionTracer(ForwardTracer):
    """Attention-only tracer: modules under an attention block by name
    (vdx's "attn"; diffusers also names them "attentions") or of an
    attention class."""

    def __init__(self, model: torch.nn.Module, **kwargs):
        kwargs.setdefault(
            "filter_fn",
            lambda path, module: "attn" in path.lower()
            or "attention" in path.lower()
            or "attention" in type(module).__name__.lower(),
        )
        super().__init__(model, **kwargs)


def trace_model(model: torch.nn.Module, *args, **kwargs) -> ForwardTracer:
    """One-shot convenience: trace ``model(*args, **kwargs)``."""
    tracer = ForwardTracer(model)
    tracer.trace(*args, **kwargs)
    return tracer


def print_model_flow(model: torch.nn.Module, *args, **kwargs) -> None:
    trace_model(model, *args, **kwargs).print_summary()


def profile_trace(fn, *args, log_dir="outputs/profile"):
    """Run ``fn(*args)`` under torch.profiler (CPU and, where there is a
    card, CUDA activity) and write a Chrome trace (chrome://tracing,
    Perfetto) to ``log_dir/trace.json``. The device is synchronised
    before the trace closes, so the trace holds the queued work's
    kernels. -> (fn's output, log_dir)"""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    return out, log_dir
