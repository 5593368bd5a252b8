"""Stable Video Diffusion img2vid pipeline (port of vdx/pipelines/svd.py).

Target config BASELINE.json configs[2]: 25 frames at 576x1024, the EDM
sampler (``dpm_edm`` too), the temporal VAE decode.

    image -> CLIP-vision embedding [1, 1, 1024] (+ a zero embedding for CFG)
          -> VAE-encode (posterior mean, unscaled) + noise augmentation
             -> the conditioning latents, repeated over the frames
    latents [1, F, h, w, 4] ~ N(0, sigma_max^2)
    per step: concat(scaled noisy latents, conditioning) on the channels
              -> UNetSpatioTemporal; CFG always, with a per-frame scale
              linspace(min_guidance_scale, max_guidance_scale, F)
    temporal VAE decode by frame chunks (``decode_chunk``), optionally in
    spatial tiles (``decode_spatial_tile``)

The family base's loop runs it (pipelines/base.py) through its hooks.
The seed's key splits in two (vdx_torch.core.rng, held against
jax.random): the first draws the initial noise, the second the
augmentation noise. The augmentation draws in fp32; vdx draws it in the
latents' dtype, which is the same draw under the fp32 policy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from vdx_torch.core import convert, rng
from vdx_torch.core.dtypes import Policy
from vdx_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from vdx_torch.models.svd_unet import SVDUNetConfig, UNetSpatioTemporal
from vdx_torch.models.vae import (AutoencoderKL, TemporalDecoder, VAEConfig,
                                  decode_spatial_tiled)
from vdx_torch.ops.resize import resize_bilinear
from vdx_torch.pipelines.base import (PipelineOutput, VideoDiffusionPipeline,
                                      _to_uint8)


def resize_to_vision(image: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> [0, 1] at the vision tower's input size,
    as ``jax.image.resize(..., "bilinear")`` (antialiased when it
    downscales)."""
    x = torch.clamp(image.float() / 2 + 0.5, 0.0, 1.0)
    return resize_bilinear(x, cfg.image_size, cfg.image_size)


class SVDImg2VidPipeline(VideoDiffusionPipeline):
    denoiser_cls = UNetSpatioTemporal
    denoiser_config_cls = SVDUNetConfig
    n_denoiser_cond = 2  # image_embeds, added_time_ids
    guidance_always = True  # the per-frame scale mixes cond and uncond
    default_scheduler = "edm"

    def _component_factories(self, vae_config: VAEConfig, policy: Policy,
                             vision_config: CLIPVisionConfig = CLIPVisionConfig()
                             ) -> dict:
        """The SD VAE (its encoder), the temporal decoder and the CLIP
        vision tower."""
        return {"vae": lambda: AutoencoderKL(vae_config, policy),
                "temporal_decoder": lambda: TemporalDecoder(vae_config, policy),
                "vision": lambda: CLIPVisionModel(vision_config, policy)}

    # ------------------------------------------------------------------
    # family hooks
    # ------------------------------------------------------------------
    @property
    def latent_channels(self) -> int:
        # the denoised latents have 4 channels; the UNet's input is
        # concat(noisy, conditioning) = 8
        return self.unet.config.out_channels

    def _components(self) -> dict:
        return {"unet": self.unet, "vae": self.vae,
                "tdec": self.temporal_decoder, "vision": self.vision}

    def _conversion_rules(self) -> dict:
        return {"unet": (self._denoiser_rules(), ()),
                "vae": (convert.vae_rules(self.vae.config), ()),
                "tdec": (convert.temporal_decoder_rules(self.vae.config), ()),
                "vision": (convert.clip_vision_rules(self.vision.config), ())}

    def _denoiser_rules(self):
        return convert.svd_unet_rules(self.unet.config)

    @torch.inference_mode()
    def _prepare_cond(self, key, cond, latent_shape) -> dict:
        """The image conditioning: VAE-encode (the posterior mean, no
        sample), noise-augment from the key's second half, CLIP-vision
        embed, micro-condition ids. The key's first half draws the
        initial noise."""
        image, fps, motion_bucket_id, noise_aug = cond
        B, F_ = latent_shape[:2]
        if isinstance(key, (list, tuple)) and not isinstance(key, rng.PRNGKey):
            (key,) = key
        if not isinstance(key, rng.PRNGKey):
            key = rng.prng_key(int(key))
        k_noise, k_aug = rng.split(key)
        mean = self.vae.encode_moments(image).float().chunk(2, dim=-1)[0]
        cond_lat = mean + noise_aug * rng.key_normal(k_aug, mean.shape,
                                                     self.device)
        # SVD conditions on UNSCALED latents for the concat path
        cond_frames = cond_lat[:, None].expand(B, F_, *cond_lat.shape[1:])
        embeds = self.vision(resize_to_vision(image, self.vision.config))[:, None]
        embeds = torch.cat([torch.zeros_like(embeds), embeds])
        concat = torch.cat([torch.zeros_like(cond_frames), cond_frames])
        aids = torch.tensor([[fps, motion_bucket_id, noise_aug]] * 2,
                            dtype=torch.float32, device=self.device)
        return {"den_args": (embeds, aids), "concat": concat, "key": k_noise}

    def _decode_raw(self, chunk: int, spatial_tile: int = 0,
                    tile_overlap: int = 8):
        """The temporal decoder by frame chunk; with ``spatial_tile`` (in
        latent pixels) each chunk in overlapping spatial tiles, so the
        decoder's peak memory is one tile's."""
        tdec = self.temporal_decoder
        upscale = self.vae.config.downscale

        def dec(c):
            if spatial_tile:
                return decode_spatial_tiled(lambda zz: tdec(zz, chunk), c,
                                            upscale, tile=spatial_tile,
                                            overlap=tile_overlap)
            return tdec(c, chunk)

        def decode(latents):
            B, F_ = latents.shape[:2]
            z = latents.reshape(B * F_ // chunk, chunk, *latents.shape[2:])
            out = [_to_uint8(dec(z[n])) for n in range(z.shape[0])]
            return torch.cat(out).reshape(B, F_, *out[0].shape[1:])

        return decode

    # ------------------------------------------------------------------
    def __call__(
        self,
        image,  # [H, W, 3] float in [0, 1], at (height, width)
        num_frames: int = 25,
        height: int = 576,
        width: int = 1024,
        num_inference_steps: int = 25,
        min_guidance_scale: float = 1.0,
        max_guidance_scale: float = 3.0,
        fps: int = 7,
        motion_bucket_id: int = 127,
        noise_aug_strength: float = 0.02,
        seed: Union[int, Sequence[int]] = 0,
        decode_chunk: int = 5,
        decode_spatial_tile: int = 0,  # latent px; 0 = untiled
        output_type: str = "np",
        scheduler: Optional[str] = None,
        dispatch_steps: int = 0,
    ) -> PipelineOutput:
        scheduler = scheduler or self.scheduler
        ds = self.vae.config.downscale
        latent_shape = (1, num_frames, height // ds, width // ds,
                        self.latent_channels)
        img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                              else image, dtype=torch.float32,
                              device=self.device)[None] * 2.0 - 1.0
        cond = (img, float(fps - 1), float(motion_bucket_id),
                float(noise_aug_strength))
        # the SVD recipe's per-frame CFG scale: a linspace over the clip
        g = np.linspace(min_guidance_scale, max_guidance_scale, num_frames,
                        dtype=np.float32).reshape(1, num_frames, 1, 1, 1)
        decode_opts = ({"spatial_tile": decode_spatial_tile}
                       if decode_spatial_tile else {})
        return self._run_generate(
            cond=cond, guidance_scale=g, guidance=True,
            latent_shape=latent_shape, scheduler=scheduler,
            num_inference_steps=num_inference_steps, seed=seed,
            decode_chunk=decode_chunk, decode_opts=decode_opts,
            output_type=output_type, dispatch_steps=dispatch_steps)
