"""LPIPS perceptual distance, AlexNet backbone (port of vdx/metrics/lpips.py).

The reference's ``lpips.LPIPS(net='alex')`` (reference
experiments/06_measure_grid_search.py:122-154): inputs in [0, 1] go to
[-1, 1] (06:143-144), through the ScalingLayer and AlexNet's five conv
stages; each stage's ReLU output is unit-normalised over channels, the
two images' squared difference is weighted by the non-negative ``lin``
head (``abs(w)``, as vdx) and averaged over space, and the stages sum.

The modules carry the lpips package's published state_dict names
(``features.{0,3,6,8,10}.{weight,bias}``, ``lin{i}.model.1.weight``), so
a real checkpoint loads with ``load_state_dict`` and vdx's
``load_torch_weights`` reads the port's weights. The real weights are hub
artifacts and are not in the repository: ``LPIPSMetric(seed=...)``
draws seeded random ones, as vdx's default does (normal convolution
weights of variance 1 / fan-in, zero biases, unit heads), on the host,
so every device gets the same weights.

Convolutions run in exact fp32 on CUDA (TF32 off while they run); the
head is an elementwise product and a sum, never a matmul.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from vdx_torch.core.dtypes import FP32_POLICY, exact_fp32
from vdx_torch.metrics.temporal import unit_frames

# ImageNet normalisation baked into LPIPS's ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# AlexNet ``features`` stages: (out channels, kernel, stride, pad); a
# 3x3 stride-2 max pool after stages 0 and 1
_ALEX_STAGES = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
                (256, 3, 1, 1), (256, 3, 1, 1))
_POOL_AFTER = (0, 1)


class _Lin(nn.Module):
    """lpips' NetLinLayer: ``model`` = (dropout, 1x1 conv without bias);
    the port keeps the conv's weight under ``model.1`` and applies it as
    a channel-weighted sum."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """Perceptual distance between [B, H, W, 3] images in [-1, 1] -> [B]."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for i, (ch, k, s, p) in enumerate(_ALEX_STAGES):
            layers += [nn.Conv2d(in_ch, ch, k, stride=s, padding=p),
                       nn.ReLU(inplace=False)]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(3, stride=2))
            in_ch = ch
        self.features = nn.Sequential(*layers)
        for i, (ch, *_) in enumerate(_ALEX_STAGES):
            setattr(self, f"lin{i}", _Lin(ch))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[B, H, W, 3] in [-1, 1] -> each stage's ReLU output, [B, C, h, w],
        unit-normalised over channels."""
        z = x.float().permute(0, 3, 1, 2)
        if z.is_cuda:
            z = z.contiguous(memory_format=torch.channels_last)
        z = (z - self.shift) / self.scale
        outs = []
        with exact_fp32(FP32_POLICY, z.device):
            for layer in self.features:
                z = layer(z)
                if isinstance(layer, nn.ReLU):
                    outs.append(z / torch.sqrt((z * z).sum(dim=1, keepdim=True)
                                               + 1e-10))
        return outs

    def distance(self, tx: List[torch.Tensor],
                 ty: List[torch.Tensor]) -> torch.Tensor:
        """Sum over stages of the |lin|-weighted squared tap difference,
        averaged over space -> [B]."""
        total = None
        for i, (a, b) in enumerate(zip(tx, ty)):
            w = getattr(self, f"lin{i}").model[1].weight.abs().view(1, -1, 1, 1)
            contrib = ((a - b) ** 2 * w).sum(dim=1).mean(dim=(1, 2))
            total = contrib if total is None else total + contrib
        return total

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.distance(self.taps(x), self.taps(y))


def random_lpips_state_dict(seed: int = 0) -> dict:
    """Seeded random LPIPS weights under the published names, drawn on the
    host: conv weights normal with variance 1 / fan-in, zero biases, unit
    heads (vdx's Flax init draws lecun-normal kernels from a JAX key; the
    distribution is the same, the draws are not)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in LPIPS().state_dict().items():
        if name.startswith("lin"):
            sd[name] = torch.ones(p.shape)
        elif name.endswith("bias"):
            sd[name] = torch.zeros(p.shape)
        else:
            fan_in = p[0].numel()
            sd[name] = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
    return sd


class LPIPSMetric:
    """The reference's LPIPSMetric (06:122-154) on ``device``: CUDA unless
    the caller asks for the CPU. ``state_dict``: weights under the
    published names; None draws seeded random ones (``seed``)."""

    def __init__(self, state_dict: Optional[dict] = None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available; "
                               "pass device='cpu' to run LPIPS on the CPU")
        model = LPIPS()
        model.load_state_dict(state_dict if state_dict is not None
                              else random_lpips_state_dict(seed))
        self.model = model.to(self.device).eval()

    def _frames(self, frames) -> torch.Tensor:
        """[..., H, W, 3] in [0, 1] (numpy or a tensor; uint8 is / 255) on
        the metric's device, fp32, mapped to [-1, 1]."""
        return unit_frames(frames, self.device) * 2.0 - 1.0

    @torch.inference_mode()
    def compute(self, frame1, frame2) -> float:
        """The distance between two [H, W, 3] frames in [0, 1]."""
        return float(self.model(self._frames(frame1)[None],
                                self._frames(frame2)[None])[0])

    @torch.inference_mode()
    def compute_pairs(self, frames) -> torch.Tensor:
        """Every consecutive pair of [F, H, W, 3] frames -> [F-1] fp32 on
        the metric's device. Each frame goes through AlexNet once, all
        frames in one batch; pair i is frames i and i + 1."""
        taps = self.model.taps(self._frames(frames))
        return self.model.distance([t[:-1] for t in taps],
                                   [t[1:] for t in taps])
