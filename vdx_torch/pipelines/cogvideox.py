"""CogVideoX text-to-video pipeline (port of vdx/pipelines/cogvideox.py).

Target config BASELINE.json configs[3]: 49 frames at 480x720. T5 text
states -> the family base's CFG-batched denoise loop over the joint-
attention DiT (CFG always; DDIM with v-prediction by default) -> the
causal 3D VAE decode over the whole latent clip (temporal x4, spatial x8;
the decoder repeats frames, 13 latent frames decode to 52, trimmed to the
request's count inside the decode).

    pipe(prompt, num_frames=49, height=480, width=720,
         num_inference_steps=50, guidance_scale=6.0, dynamic_cfg=False,
         decode_spatial_tile=40) -> output.frames[0]

``offload_text_encoder``: T5's weights live in (pinned) host memory; each
miss of the prompt cache copies them to the card once, encodes, and drops
the card's copy before the denoise loop (the cache holds up to 16
prompts, then starts over). PAB broadcasts the joint attention
(``PABConfig.joint_interval``). FreeU, context windows and frame sharding
are rejected as vdx rejects them: the joint attention entangles every
frame with the text.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from vdx_torch.core import convert
from vdx_torch.core.dtypes import Policy
from vdx_torch.models.cogvideox import (CausalVAEConfig, CausalVAEDecoder,
                                        CausalVAEEncoder, CogVideoXConfig,
                                        CogVideoXDiT)
from vdx_torch.models.t5 import T5Config, T5Encoder
from vdx_torch.models.tokenizer import FallbackBPETokenizer
from vdx_torch.models.vae import decode_spatial_tiled
from vdx_torch.pipelines.base import (PipelineOutput, VideoDiffusionPipeline,
                                      _to_uint8)
from vdx_torch.schedulers.common import ScheduleConfig, dynamic_cfg_schedule
from vdx_torch.schedulers.ddim import DDIMConfig
from vdx_torch.schedulers.dpm import DPMConfig

#: the prompt cache starts over past this many entries
TEXT_CACHE_MAX = 16


def cogvideox_sampler_configs() -> dict:
    """CogVideoX's published sampling constants (diffusers'
    CogVideoXDDIMScheduler / CogVideoXDPMScheduler): v-prediction on a
    scaled_linear grid with the SNR shift 3.0 and the zero-terminal-SNR
    rescale; DDIM with steps_offset 0, set_alpha_to_one and trailing
    spacing; DPM-Solver++(2M) on the same schedule."""
    sched = ScheduleConfig(beta_schedule="scaled_linear",
                           prediction_type="v_prediction", snr_shift_scale=3.0,
                           rescale_zero_snr=True)
    return {"ddim": DDIMConfig(schedule=sched, steps_offset=0,
                               set_alpha_to_one=True, timestep_spacing="trailing"),
            "dpm": DPMConfig(schedule=sched, steps_offset=0)}


class CogVideoXPipeline(VideoDiffusionPipeline):
    denoiser_cls = CogVideoXDiT
    denoiser_config_cls = CogVideoXConfig
    denoiser_param_key = "dit"
    guidance_always = True
    default_scheduler = "ddim"
    supports_frame_shards = False
    supports_context = False

    def __init__(self, dit_config: Optional[CogVideoXConfig] = None,
                 vae_config: CausalVAEConfig = CausalVAEConfig(), *,
                 offload_text_encoder: bool = False, sampler_configs=None,
                 freeu=None, **kwargs):
        """Keywords as the base's, plus ``t5_config`` and ``tokenizer``
        (:meth:`_component_factories`) and ``offload_text_encoder``."""
        if freeu is not None:
            raise ValueError("CogVideoXDiT has no skip-connection up path — "
                             "FreeU does not apply")
        self.offload_text_encoder = offload_text_encoder
        self._text_cache: dict = {}
        self._t5_offloaded = False
        super().__init__(dit_config, vae_config,
                         sampler_configs=(cogvideox_sampler_configs()
                                          if sampler_configs is None
                                          else sampler_configs), **kwargs)
        self.dit = self.unet
        self.vae_config = vae_config

    def _component_factories(self, vae_config: CausalVAEConfig, policy: Policy,
                             t5_config: T5Config = T5Config(),
                             tokenizer=None) -> dict:
        """The causal VAE's encoder and decoder and the T5 text tower."""
        self.tokenizer = tokenizer or FallbackBPETokenizer()
        return {"vae_enc": lambda: CausalVAEEncoder(vae_config, policy),
                "vae_dec": lambda: CausalVAEDecoder(vae_config, policy),
                "text_encoder": lambda: T5Encoder(t5_config, policy)}

    # ------------------------------------------------------------------
    # family hooks
    # ------------------------------------------------------------------
    def _components(self) -> dict:
        return {"dit": self.unet, "t5": self.text_encoder,
                "vae_enc": self.vae_enc, "vae_dec": self.vae_dec}

    def _conversion_rules(self) -> dict:
        return {"dit": (convert.cogvideox_dit_rules(self.unet.config), ()),
                "t5": (convert.t5_encoder_rules(self.text_encoder.config), ()),
                "vae_enc": (convert.causal_vae_encoder_rules(self.vae_config), ()),
                "vae_dec": (convert.causal_vae_decoder_rules(self.vae_config), ())}

    def _denoiser_rules(self):
        return convert.cogvideox_dit_rules(self.unet.config)

    def _decode_raw(self, chunk: int, spatial_tile: int = 0,
                    tile_overlap: int = 8, trim: int = 0):
        """The causal decode over the WHOLE latent clip (``chunk`` is
        ignored: frame t depends on every frame before it); with
        ``spatial_tile`` (latent pixels) in overlapping spatial tiles
        (models/vae.decode_spatial_tiled), so the decoder's peak memory is
        one tile column; ``trim`` keeps the first N decoded frames."""
        del chunk
        cfg = self.vae_config
        dec = self.vae_dec

        def decode(latents):
            z = latents / cfg.scaling_factor
            if spatial_tile:
                B, f_lat = z.shape[:2]

                def dec_flat(zt):  # [B*f, t, t, C] -> [B*F_out, T, T, 3]
                    x = dec(zt.reshape(B, f_lat, *zt.shape[1:]))
                    return x.reshape(B * x.shape[1], *x.shape[2:])

                x = decode_spatial_tiled(
                    dec_flat, z.reshape(B * f_lat, *z.shape[2:]),
                    cfg.spatial_downscale, tile=spatial_tile, overlap=tile_overlap)
                x = x.reshape(B, -1, *x.shape[1:])
            else:
                x = dec(z)
            return _to_uint8(x[:, :trim] if trim else x)

        return decode

    # ------------------------------------------------------------------
    # checkpoints and the text tower
    # ------------------------------------------------------------------
    def load_pretrained(self, sources: dict, strict: bool = True) -> dict:
        """The base's; the prompt cache is dropped, since it holds states of
        the old weights (an offloaded T5 takes the new ones on the host)."""
        self._text_cache.clear()
        return super().load_pretrained(sources, strict=strict)

    def load_checkpoint(self, path) -> None:
        self._text_cache.clear()
        super().load_checkpoint(path)

    def init_params(self, seed: int = 0) -> int:
        """The base's; an offloaded T5 comes back to the pipeline's device
        first (its draws happen there) and offloads again at the next
        encode."""
        if self._t5_offloaded:
            self.text_encoder.to(self.device)
            self._t5_offloaded = False
        self._text_cache.clear()
        return super().init_params(seed)

    def _offload_t5(self) -> None:
        """T5's parameters to host memory (pinned when the pipeline is on
        CUDA), once; the card's copy is dropped."""
        if self._t5_offloaded:
            return
        pin = self.device.type == "cuda"
        with torch.no_grad():
            for p in self.text_encoder.parameters():
                host = p.data.to("cpu")
                p.data = host.pin_memory() if pin else host
        self._t5_offloaded = True

    @torch.inference_mode()
    def encode_prompt(self, prompt: Union[str, Sequence[str]],
                      negative_prompt: str = "") -> torch.Tensor:
        """T5 states [2B, max_text_len, d_model], ordered (uncond x B,
        cond x B). With ``offload_text_encoder``, a cached prompt returns
        its states; a miss copies T5's weights to the card in one pass,
        encodes, and lets the copy go."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        key = (tuple(prompts), negative_prompt or "")
        if self.offload_text_encoder and key in self._text_cache:
            return self._text_cache[key]
        ids = self.tokenizer([negative_prompt or ""] * len(prompts) + prompts,
                             context_length=self.unet.config.max_text_len)
        ids = np.remainder(ids, self.text_encoder.config.vocab_size)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        if not self.offload_text_encoder:
            return self.text_encoder(ids)
        self._offload_t5()
        weights = {n: p.to(self.device, non_blocking=True)
                   for n, p in self.text_encoder.named_parameters()}
        states = torch.func.functional_call(self.text_encoder, weights, (ids,))
        del weights  # the card's copy goes before the denoise loop
        if len(self._text_cache) > TEXT_CACHE_MAX:
            self._text_cache.clear()
        self._text_cache[key] = states
        return states

    # ------------------------------------------------------------------
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        negative_prompt: str = "",
        num_frames: int = 49,
        height: int = 480,
        width: int = 720,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        dynamic_cfg: bool = False,
        seed: Union[int, Sequence[int]] = 0,
        output_type: str = "np",
        scheduler: Optional[str] = None,
        decode_spatial_tile: int = 0,  # latent px; 0 = untiled
        decode_tile_overlap: int = 8,
        dispatch_steps: int = 0,
    ) -> PipelineOutput:
        """``dynamic_cfg`` ramps the guidance from 1 to ``guidance_scale``
        over the steps (cosine^5, schedulers.common.dynamic_cfg_schedule).
        The latent clip has 1 + (num_frames - 1) // 4 frames."""
        scheduler = scheduler or self.scheduler
        if dynamic_cfg:
            guidance_scale = dynamic_cfg_schedule(float(guidance_scale),
                                                  num_inference_steps)
        cfg = self.vae_config
        f_lat = 1 + (num_frames - 1) // cfg.temporal_downscale
        B = 1 if isinstance(prompt, str) else len(prompt)
        ds = cfg.spatial_downscale
        latent_shape = (B, f_lat, height // ds, width // ds, self.latent_channels)
        decode_opts = {"trim": num_frames}
        if decode_spatial_tile:
            decode_opts.update(spatial_tile=decode_spatial_tile,
                               tile_overlap=decode_tile_overlap)
        return self._run_generate(
            cond=self.encode_prompt(prompt, negative_prompt),
            guidance_scale=guidance_scale, guidance=True,
            latent_shape=latent_shape, scheduler=scheduler,
            num_inference_steps=num_inference_steps, seed=seed,
            decode_chunk=f_lat, decode_opts=decode_opts, output_type=output_type,
            dispatch_steps=dispatch_steps)
