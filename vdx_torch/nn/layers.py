"""Dense and conv layers on channels-last activations under a dtype policy.

The counterparts of flax's ``nn.Dense(dtype=compute, param_dtype=param)``
and ``nn.Conv``: parameters live in ``policy.param_dtype`` with
torch-native shapes and diffusers names (``weight``/``bias``), inputs and
parameters are cast to ``policy.compute_dtype`` at use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=policy.param_dtype)
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in fp32, output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__(dim, eps=eps, dtype=policy.param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Conv2d(nn.Conv2d):
    """Conv over channels-last [B, H, W, C] input and output. The input is
    handed to the conv as an NCHW view with channels-last strides, so no
    layout copy is made; 1x1 convs run as a matmul."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dtype=policy.param_dtype)
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        w = self.weight.to(cd)
        b = self.bias.to(cd)
        if self.kernel_size == (1, 1) and self.stride == (1, 1) \
                and self.padding == (0, 0):
            return F.linear(x.to(cd), w[:, :, 0, 0], b)
        y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), w, b, self.stride,
                     self.padding)
        return y.permute(0, 2, 3, 1)


class PatchConv(nn.Conv2d):
    """The DiTs' p x p stride-p patch embedding: a Conv2d's ``weight``
    [D, C, p, p] and ``bias`` (diffusers' names), applied by
    :meth:`linear` to patches flattened in (p_h, p_w, C) order."""

    def __init__(self, in_channels: int, out_channels: int, patch: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__(in_channels, out_channels, patch, stride=patch,
                         dtype=policy.param_dtype)
        self.policy = policy

    def linear(self, x: torch.Tensor) -> torch.Tensor:
        """[..., p*p*C] patches -> [..., D]."""
        cd = self.policy.compute_dtype
        w = self.weight.to(cd).permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return F.linear(x.to(cd), w, self.bias.to(cd))


class FrameConv(nn.Module):
    """A (3, 1, 1) convolution over the frame axis of [B, F, H, W, C]
    activations, zero-padded one frame at each end (vdx's
    ``nn.Conv(C, (3, 1, 1))``), holding a Conv3d's ``weight``
    [O, I, 3, 1, 1] and ``bias``. It runs as a (3, 1) 2D convolution over
    the [B, C, F, H*W] view of the channels-last input (no layout copy):
    the same sums, accumulated in fp32 and rounded once, on cuDNN's 2D
    kernels. (cuDNN ran the bf16 Conv3d at the temporal decoder's 576x1024
    planes on an fp32 SIMT-tiled kernel, 13 ms a call on an H100.)

    ``padding="same"`` zero-pads the frame axis (local execution);
    ``padding="valid"`` takes an input already halo-padded by one frame
    at each end (frame-sharded execution, ops/halo.py), F_out = F - 2
    (vdx's ``FrameConv3(padding="valid")``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 1, 1,
                                               dtype=policy.param_dtype))
        self.bias = nn.Parameter(torch.empty(out_channels, dtype=policy.param_dtype))

    def forward(self, x: torch.Tensor, padding: str = "same") -> torch.Tensor:
        if padding not in ("same", "valid"):
            raise ValueError(f"unknown frame padding {padding!r}")
        cd = self.policy.compute_dtype
        B, F_, H, W, C = x.shape
        x4 = x.to(cd).reshape(B, F_, H * W, C).permute(0, 3, 1, 2)
        y = F.conv2d(x4, self.weight.to(cd)[..., 0], self.bias.to(cd),
                     padding=(1, 0) if padding == "same" else (0, 0))
        return y.permute(0, 2, 3, 1).reshape(B, y.shape[2], H, W, -1)
