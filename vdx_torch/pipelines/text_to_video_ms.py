"""ModelScope-class text-to-video pipeline (port of
vdx/pipelines/text_to_video_ms.py): the family base's loop with the UNet3D
denoiser and the ViT-H-width text tower (cross-attention dim 1024).

Target config BASELINE.json configs[0]: 16 frames at 256x256, DDIM.
"""

from __future__ import annotations

from vdx_torch.core import convert
from vdx_torch.models.clip_text import CLIPTextConfig
from vdx_torch.models.unet3d import UNet3D, UNet3DConfig
from vdx_torch.pipelines.base import VideoDiffusionPipeline


def vit_h_text_config() -> CLIPTextConfig:
    """OpenCLIP ViT-H/14 text tower dims (ModelScope's conditioning);
    quick-GELU at every width, as vdx's CLIP text tower."""
    return CLIPTextConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096)


class TextToVideoMSPipeline(VideoDiffusionPipeline):
    denoiser_cls = UNet3D
    denoiser_config_cls = UNet3DConfig
    default_scheduler = "ddim"

    def __init__(self, **kwargs):
        kwargs.setdefault("text_config", vit_h_text_config())
        super().__init__(**kwargs)

    def _denoiser_rules(self):
        return convert.unet3d_rules(self.unet.config)
