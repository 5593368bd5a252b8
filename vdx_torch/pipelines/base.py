"""AnimateDiff text-to-video pipeline, plain path (port of
vdx/pipelines/base.py).

    pipe(prompt, negative_prompt=..., num_frames=16, guidance_scale=7.5,
         num_inference_steps=25, height=512, width=512, seed=42)
    -> output.frames[0]

Text encode -> initial noise (vdx's ``jax.random.normal(PRNGKey(seed))``,
computed by vdx_torch.core.rng on the pipeline's device) -> CFG-batched
denoise loop (cond and uncond in ONE UNet call per step) -> frame-chunked
VAE decode -> uint8. The loop is a Python loop of eager steps (vdx's
``lax.scan``); fp32 guidance and scheduler math around the compute-dtype
UNet. Every sampler of vdx_torch.schedulers runs through the one loop:
``scale_model_input`` -> UNet at ``tables.timesteps[i]`` -> CFG combine ->
``step``, or ``step_multistep`` with the sampler's state in the loop's
carry. Under an fp32 policy on CUDA every matmul and convolution runs in
fp32, not TF32: the text encoder, UNet and VAE forwards each turn TF32 off
while they run (core.dtypes.exact_fp32); the glue between them is
elementwise.

What vdx's pipeline also does and this slice does not yet (PAB, skip,
context windows, frame sharding, video2video, dispatch_steps, multi-prompt
batches, per-step guidance schedules) raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from vdx_torch.core import rng
from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from vdx_torch.models.tokenizer import load_tokenizer
from vdx_torch.models.unet_motion import UNetMotion, UNetMotionConfig
from vdx_torch.models.vae import AutoencoderKL, VAEConfig
from vdx_torch.schedulers import get_sampler, is_multistep, make_tables_for
from vdx_torch.schedulers.common import cfg_combine


@dataclasses.dataclass
class PipelineOutput:
    """``frames[i]`` is the i-th video: a uint8 [F, H, W, 3] array for
    output_type="np", a list of PIL images for "pil"."""

    frames: List[Any]
    latents: Optional[torch.Tensor] = None


def _to_uint8(imgs: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float frames -> [0, 255] uint8: round(clip(x/2 + 0.5) * 255)."""
    imgs = torch.clamp(imgs.float() / 2 + 0.5, 0.0, 1.0)
    return torch.round(imgs * 255.0).to(torch.uint8)


def _init_kind(name: str, p: torch.Tensor) -> str:
    if p.dim() >= 2:
        return "normal"
    if "mix_factor" in name:
        return "half"
    if name.endswith("weight"):  # norm scales (vdx's "scale" leaves)
        return "ones"
    return "zeros"


@torch.no_grad()
def random_init_(module: torch.nn.Module, generator: torch.Generator) -> int:
    """Fill every parameter in place with vdx's ``fast_tree_init`` rules:
    a fan-in-scaled standard normal for leaves of 2+ dims, with fan-in
    counted in vdx's layout (all axes but the last: in*kh*kw for convs,
    in for linears, the table length for embeddings); ones for norm
    scales; 0.5 for mix factors; zeros otherwise. Draws happen on the
    parameters' device. Returns the parameter count."""
    embeddings = {f"{n}.weight" for n, m in module.named_modules()
                  if isinstance(m, torch.nn.Embedding)}
    total = 0
    for name, p in module.named_parameters():
        kind = _init_kind(name, p)
        if kind == "normal":
            fan_in = p.shape[0] if name in embeddings else p.numel() // p.shape[0]
            x = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
            p.copy_(x.mul_(max(fan_in, 1) ** -0.5))
        else:
            p.fill_({"half": 0.5, "ones": 1.0, "zeros": 0.0}[kind])
        total += p.numel()
    return total


class AnimateDiffPipeline:
    """SD-1.5 + motion modules, plain path."""

    def __init__(
        self,
        unet_config: Optional[UNetMotionConfig] = None,
        vae_config: VAEConfig = VAEConfig(),
        text_config: CLIPTextConfig = CLIPTextConfig(),
        tokenizer=None,
        policy: Policy = DEFAULT_POLICY,
        scheduler: str = "euler",
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        get_sampler(scheduler)  # ValueError on an unknown name
        self.scheduler = scheduler
        self.policy = policy
        self.tokenizer = tokenizer or load_tokenizer()
        # Built on the meta device and materialised uninitialised on the
        # target: weights come from random_init_ or a state_dict.
        with torch.device("meta"):
            unet = UNetMotion(unet_config or UNetMotionConfig(), policy)
            vae = AutoencoderKL(vae_config, policy)
            text = CLIPTextModel(text_config, policy)
        self.unet = unet.to_empty(device=self.device).eval()
        self.vae = vae.to_empty(device=self.device).eval()
        self.text_encoder = text.to_empty(device=self.device).eval()
        if self.device.type == "cuda":
            # conv weights in the activations' channels-last layout (cuDNN)
            self.unet.to(memory_format=torch.channels_last)
            self.vae.to(memory_format=torch.channels_last)
        self._tables = {}

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @classmethod
    def with_random_params(cls, seed: int = 0, **kwargs) -> "AnimateDiffPipeline":
        """Seeded random weights, generated on the pipeline's device."""
        pipe = cls(**kwargs)
        pipe.init_params(seed)
        return pipe

    def init_params(self, seed: int = 0) -> int:
        """Fill every component with seeded random weights (see
        :func:`random_init_`); returns the parameter count."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return sum(random_init_(m, gen)
                   for m in (self.unet, self.vae, self.text_encoder))

    def load_state_dicts(self, state_dicts: dict) -> None:
        """{"unet" | "vae" | "text": state_dict} with diffusers names."""
        modules = {"unet": self.unet, "vae": self.vae, "text": self.text_encoder}
        for name, sd in state_dicts.items():
            modules[name].load_state_dict(sd, strict=True)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_prompt(self, prompt: str, negative_prompt: str = "") -> torch.Tensor:
        """-> [2, 77, D] context, ordered (uncond, cond) to match the CFG
        batch split."""
        ids = self.tokenizer([negative_prompt or "", prompt])
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return self.text_encoder(ids)

    def _get_tables(self, scheduler: str, num_steps: int):
        """The sampler's tables on the pipeline's device, built once per
        (sampler, step count) and cached: no per-call host work."""
        key = (scheduler.lower(), num_steps)
        if key not in self._tables:
            self._tables[key] = make_tables_for(scheduler, num_steps,
                                                device=self.device)
        return self._tables[key]

    def initial_noise(self, latent_shape, seed: int) -> torch.Tensor:
        """vdx's initial noise for ``seed``: the same fp32 values on the
        CPU and on the card (vdx_torch.core.rng)."""
        return rng.normal(seed, latent_shape, self.device)

    @torch.inference_mode()
    def denoise_step(self, latents: torch.Tensor, i: int, context: torch.Tensor,
                     guidance_scale: float, guidance: bool, scheduler: str,
                     tables, state=None):
        """One CFG-batched UNet evaluation and sampler update at step i
        (a Python int: no host synchronisation). -> (latents, state);
        ``state`` is the multistep sampler's carry, None for the others."""
        sampler = get_sampler(scheduler)
        model_in = torch.cat([latents, latents]) if guidance else latents
        model_in = sampler.scale_model_input(model_in, i, tables)
        t_b = tables.timesteps[i].expand(model_in.shape[0])
        eps = self.unet(model_in, t_b, context)
        if guidance:
            u, c = eps.chunk(2)
            eps = cfg_combine(u, c, guidance_scale)
        if is_multistep(scheduler):
            return sampler.step_multistep(latents, eps, i, state, tables)
        return sampler.step(latents, eps, i, tables), state

    @torch.inference_mode()
    def _denoise(self, context: torch.Tensor, guidance_scale: float,
                 guidance: bool, scheduler: str, tables, latent_shape,
                 seed: int,
                 latents_in: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The denoise loop. ``latents_in`` replaces the seeded initial
        noise, unscaled (the tests feed the JAX program's noise)."""
        noise = (self.initial_noise(latent_shape, seed) if latents_in is None
                 else latents_in.to(device=self.device, dtype=torch.float32))
        latents = noise * tables.init_noise_sigma
        state = (get_sampler(scheduler).init_state(latents)
                 if is_multistep(scheduler) else None)
        for i in range(len(tables.timesteps)):
            latents, state = self.denoise_step(latents, i, context,
                                               guidance_scale, guidance,
                                               scheduler, tables, state)
        return latents

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor, chunk: int) -> torch.Tensor:
        """[B, F, h, w, C] latents -> [B, F, H, W, 3] uint8, decoded
        ``chunk`` frames at a time."""
        B, F_ = latents.shape[:2]
        z = latents.reshape(B * F_ // chunk, chunk, *latents.shape[2:])
        out = [_to_uint8(self.vae.decode(z[n])) for n in range(z.shape[0])]
        return torch.cat(out).reshape(B, F_, *out[0].shape[1:])

    # ------------------------------------------------------------------
    # public API (vdx's argument names)
    # ------------------------------------------------------------------
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        negative_prompt: str = "",
        num_frames: int = 16,
        guidance_scale: float = 7.5,
        num_inference_steps: int = 25,
        height: int = 512,
        width: int = 512,
        seed: int = 0,
        scheduler: Optional[str] = None,
        output_type: str = "pil",
        decode_chunk: int = 8,
        video=None,
        strength: float = 0.8,
        dispatch_steps: int = 0,
    ) -> PipelineOutput:
        del strength  # video2video only
        if video is not None:
            raise NotImplementedError(
                "video2video comes with ROADMAP Queue 1 item 10")
        if dispatch_steps:
            raise NotImplementedError(
                "dispatch_steps comes with ROADMAP Queue 1 item 10")
        if not isinstance(prompt, str):
            raise NotImplementedError(
                "multi-prompt batches come with ROADMAP Queue 1 item 9")
        if np.ndim(guidance_scale) != 0:
            raise NotImplementedError(
                "per-step guidance schedules come with ROADMAP Queue 1 item 9")
        if output_type not in ("np", "pil", "latent"):
            raise NotImplementedError(f"output_type={output_type!r}")
        scheduler = scheduler or self.scheduler
        ds = self.vae.config.downscale
        latent_shape = (1, num_frames, height // ds, width // ds,
                        self.unet.config.in_channels)
        guidance = float(guidance_scale) > 1.0
        context = self.encode_prompt(prompt, negative_prompt)
        if not guidance:
            context = context[1:]
        tables = self._get_tables(scheduler, num_inference_steps)
        latents = self._denoise(context, float(guidance_scale), guidance,
                                scheduler, tables, latent_shape, int(seed))
        if output_type == "latent":
            return PipelineOutput(frames=[], latents=latents)
        chunk = max(1, min(decode_chunk, num_frames))
        while num_frames % chunk:
            chunk -= 1
        frames = self._decode(latents, chunk).cpu().numpy()
        if output_type == "np":
            return PipelineOutput(frames=[frames[0]], latents=latents)
        from PIL import Image

        return PipelineOutput(frames=[[Image.fromarray(f) for f in frames[0]]],
                              latents=latents)
