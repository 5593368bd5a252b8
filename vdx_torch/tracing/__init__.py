from vdx_torch.tracing.tracer import (
    AttentionTracer,
    ForwardTracer,
    ModuleTrace,
    print_model_flow,
    profile_trace,
    trace_model,
)

__all__ = [
    "AttentionTracer",
    "ForwardTracer",
    "ModuleTrace",
    "print_model_flow",
    "profile_trace",
    "trace_model",
]
