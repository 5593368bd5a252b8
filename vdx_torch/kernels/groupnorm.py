"""K2 and K3 — fused GroupNorm(+SiLU) (CUDA, ``csrc/groupnorm.cu``).

Port of vdx/kernels/groupnorm.py: ``fused_group_norm`` (K2, one program
per sample) and ``fused_group_norm_2phase`` (K3, moments over row chunks,
then a chunked normalise). Both take a channels-last [B, S, C] tensor
(S folds every non-batch axis) and compute, per (sample, group), fp32
moments var = E[x^2] - mean^2, rsqrt(var + eps), the affine and an
optional SiLU.

The Hopper dispatch (:func:`group_norm_silu_cuda`) has a gate of its own,
sized by shared memory: K2 keeps one group's [S, C/G] slab in shared
memory, so it takes shapes whose slab fits ``K2_SMEM_BYTES``; K3 takes
the rest. A shape neither takes raises.

Each wrapper launches its kernel for a CUDA tensor and raises on anything
the kernel does not take; for a CPU tensor it computes
:func:`group_norm_moments_plain`, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernels against.
"""

from __future__ import annotations

import math

import torch

from vdx_torch.kernels import _lib

# K2's slab budget: at most this many bytes of shared memory per block
# leaves two blocks resident per SM (228 KB per SM on the H100).
K2_SMEM_BYTES = 100 * 1024
K2_MAX_GROUP_CHANNELS = 256  # one thread per channel of the group
K3_MAX_CHANNELS = 2048       # 8 channels per thread, 256 threads
K3_MAX_GROUPS = 128
# K3 row chunks: enough (chunk, sample) blocks to put two on every SM.
_K3_TARGET_BLOCKS = 2 * 132


def group_norm_moments_plain(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, *, num_groups: int,
                             eps: float, with_silu: bool) -> torch.Tensor:
    """Plain PyTorch version of K2/K3 on [B, S, C]: fp32 moments
    (E[x^2] - mean^2), affine, optional SiLU, cast back to x's dtype."""
    B, S, C = x.shape
    G = num_groups
    xg = x.float().reshape(B, S, G, C // G)
    n = S * (C // G)
    mean = xg.sum(dim=(1, 3)) / n  # [B, G]
    var = torch.clamp_min((xg * xg).sum(dim=(1, 3)) / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    sc = scale.float().reshape(1, G, C // G) * inv[:, :, None]  # [B, G, cpg]
    off = bias.float().reshape(1, G, C // G) - mean[:, :, None] * sc
    y = xg * sc[:, None] + off[:, None]
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.reshape(B, S, C).to(x.dtype)


def k2_viable(S: int, C: int, G: int, itemsize: int) -> bool:
    cpg = C // G
    return cpg <= K2_MAX_GROUP_CHANNELS and S * cpg * itemsize <= K2_SMEM_BYTES


def k3_viable(S: int, C: int, G: int, itemsize: int) -> bool:
    del S, itemsize
    return C % 8 == 0 and C <= K3_MAX_CHANNELS and G <= K3_MAX_GROUPS


def _check(x, scale, bias, num_groups):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"GN kernels take fp32 or bf16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"GN kernels take a contiguous [B, S, C], got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, S, C = x.shape
    if C % num_groups:
        raise ValueError(f"C={C} not divisible by {num_groups} groups")
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError("scale/bias must be [C]")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale/bias must be on x's device")
    if x.data_ptr() % 16:
        raise ValueError("GN kernels need a 16-byte aligned x")
    return B, S, C


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, num_groups: int, eps: float = 1e-5,
                     with_silu: bool = False) -> torch.Tensor:
    """K2: [B, S, C] GroupNorm(+SiLU), one block per (sample, group) with
    the group's slab in shared memory."""
    if x.device.type == "cpu":
        return group_norm_moments_plain(x, scale, bias, num_groups=num_groups,
                                        eps=eps, with_silu=with_silu)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, got {x.device}")
    B, S, C = _check(x, scale, bias, num_groups)
    if not k2_viable(S, C, num_groups, x.element_size()):
        raise ValueError(f"K2 slab [{S}, {C // num_groups}] exceeds its "
                         f"shared-memory budget ({K2_SMEM_BYTES} B)")
    y = torch.empty_like(x)
    gamma, beta = scale.float(), bias.float()  # held until the launch
    fn = (_lib.lib().vdx_group_norm_bf16 if x.dtype == torch.bfloat16
          else _lib.lib().vdx_group_norm_f32)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
             B, S, C, num_groups, float(eps), int(with_silu),
             _lib.stream_ptr(x.device))
    _lib.check(err, "K2 fused_group_norm")
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0


def k3_rows_per_chunk(B: int, S: int) -> int:
    n_chunks = max(1, min(S, -(-_K3_TARGET_BLOCKS // B)))
    return -(-S // n_chunks)


def fused_group_norm_2phase(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, *, num_groups: int,
                            eps: float = 1e-5,
                            with_silu: bool = False) -> torch.Tensor:
    """K3: [B, S, C] GroupNorm(+SiLU) in two passes over x: per-chunk
    moments, then a chunked normalise. One wrapper call = three launches
    (stats, finalise, apply); the counter counts wrapper calls."""
    if x.device.type == "cpu":
        return group_norm_moments_plain(x, scale, bias, num_groups=num_groups,
                                        eps=eps, with_silu=with_silu)
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda or cpu tensors, got {x.device}")
    B, S, C = _check(x, scale, bias, num_groups)
    if not k3_viable(S, C, num_groups, x.element_size()):
        raise ValueError(f"K3 takes C % 8 == 0, C <= {K3_MAX_CHANNELS}, "
                         f"G <= {K3_MAX_GROUPS}; got C={C}, G={num_groups}")
    rows = k3_rows_per_chunk(B, S)
    n_chunks = -(-S // rows)
    work = torch.empty(B * 2 * num_groups * (n_chunks + 1), dtype=torch.float32,
                       device=x.device)
    y = torch.empty_like(x)
    gamma, beta = scale.float(), bias.float()  # held until the launch
    fn = (_lib.lib().vdx_group_norm_2phase_bf16 if x.dtype == torch.bfloat16
          else _lib.lib().vdx_group_norm_2phase_f32)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
             work.data_ptr(), B, S, C, num_groups, rows, float(eps),
             int(with_silu), _lib.stream_ptr(x.device))
    _lib.check(err, "K3 fused_group_norm_2phase")
    fused_group_norm_2phase.launches += 1
    return y


fused_group_norm_2phase.launches = 0


def group_norm_silu_cuda(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5,
                         with_silu: bool = True) -> torch.Tensor:
    """Channels-last [B, ..., C] dispatch for a CUDA tensor: folds every
    non-batch axis into S, then K2 when the group slab fits shared memory,
    else K3; raises when neither kernel takes the shape."""
    shape = x.shape
    B, C = shape[0], shape[-1]
    S = math.prod(shape[1:-1])
    x3 = x.reshape(B, S, C)
    if not x3.is_contiguous():
        x3 = x3.contiguous()
    if k2_viable(S, C, num_groups, x.element_size()):
        fn = fused_group_norm
    elif k3_viable(S, C, num_groups, x.element_size()):
        fn = fused_group_norm_2phase
    else:
        raise NotImplementedError(
            f"no Hopper GroupNorm kernel takes [B={B}, S={S}, C={C}], "
            f"G={num_groups}")
    y = fn(x3, scale, bias, num_groups=num_groups, eps=eps, with_silu=with_silu)
    return y.reshape(shape)
