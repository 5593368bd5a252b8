"""Latte-style DiT text-to-video pipeline (port of vdx/pipelines/latte.py).

Target config BASELINE.json configs[4]: the spatiotemporal DiT
(models/dit.py) in the family base's loop, DDIM by default, with the SD
VAE and the CLIP text tower (cross-attention dim 768). FreeU is rejected
(a DiT has no skip connections); video2video, PAB, skip mode and LoRA
come from the base.
"""

from __future__ import annotations

from vdx_torch.core import checkpoint as ckpt
from vdx_torch.core import convert
from vdx_torch.models.dit import LatteConfig, LatteDiT
from vdx_torch.pipelines.base import VideoDiffusionPipeline


class LattePipeline(VideoDiffusionPipeline):
    denoiser_cls = LatteDiT
    denoiser_config_cls = LatteConfig
    default_scheduler = "ddim"

    def _denoiser_rules(self):
        return convert.latte_dit_rules(self.unet.config)

    def load_pretrained(self, sources: dict, strict: bool = True) -> dict:
        """The base's, with a diffusers Latte checkpoint's global adaLN
        (``adaln_single.linear`` and the blocks' ``scale_shift_table``)
        folded into the port's per-block adaLN first, as vdx's rule folds
        it (core/convert.fold_latte_adaln)."""
        if "unet" in sources:
            sd = ckpt.merge_sources("unet", sources["unet"], self.device)
            sources = {**sources,
                       "unet": convert.fold_latte_adaln(sd, self.unet.config)}
        return super().load_pretrained(sources, strict=strict)
