"""The family base and the AnimateDiff text-to-video and video2video
pipeline (port of vdx/pipelines/base.py).

    pipe(prompt, negative_prompt=..., num_frames=16, guidance_scale=7.5,
         num_inference_steps=25, height=512, width=512, seed=42)
    -> output.frames[0]
    pipe([p0, p1], seed=[s0, s1], guidance_scale=<N-entry schedule>,
         output_type="device")                   # a batch of videos
    pipe(prompt, video=clip, strength=0.6)       # video2video (SDEdit)

:class:`VideoDiffusionPipeline` is vdx's family base: the request loop
around a pluggable denoiser, through vdx's hooks (``denoiser_cls``,
``n_denoiser_cond``, ``guidance_always``, ``latent_channels``,
``_prepare_cond``, ``_decode_raw``, ``_denoiser_rules``,
``_conversion_rules``) and the port's ``default_scheduler`` and
``_component_factories`` (the components beside the denoiser).
:class:`AnimateDiffPipeline` (UNetMotion), ``TextToVideoMSPipeline``
(UNet3D, pipelines/text_to_video_ms.py) and ``SVDImg2VidPipeline``
(pipelines/svd.py) subclass it.

Text encode -> initial noise (vdx's ``jax.random.normal(PRNGKey(seed))``,
computed by vdx_torch.core.rng on the pipeline's device; one draw per
video of a batch, so video b equals the single call with seed b) ->
CFG-batched denoise loop (cond and uncond of every video in ONE UNet call
per step) -> frame-chunked VAE decode -> uint8. The loop is a Python loop
of eager steps (vdx's ``lax.scan``); fp32 guidance and scheduler math
around the compute-dtype UNet. Every sampler of vdx_torch.schedulers runs
through the one loop: ``scale_model_input`` -> (the family's ``concat``
conditioning appended on the channels) -> UNet at ``tables.timesteps[i]``
-> CFG combine (a scalar, a per-step schedule or, as SVD's, a per-frame
[1, F, 1, 1, 1] scale) -> ``step``, or ``step_multistep`` with the
sampler's state in the loop's carry. Under an fp32 policy on CUDA every
matmul and convolution runs in fp32, not TF32: each component's forward
turns TF32 off while it runs (core.dtypes.exact_fp32); the glue between
them is elementwise.

vdx's request surface: prompt batches with per-video seeds, per-step
guidance schedules (indexed on the device), ``guidance_rescale``,
``sampler_configs``, ``variable_steps``, ``progress``, ``attn_impl``,
FreeU, skip turbo mode (``SkipConfig``, ``PipelineOutput.n_evals``),
Pyramid Attention Broadcast (``PABConfig``), context windows with
FreeNoise (``ContextConfig``, pipelines/context.py), LoRA adapters
(``load_lora``, core/lora.py), checkpoints (``load_pretrained``,
``from_pretrained``, ``save_checkpoint``, core/checkpoint.py),
``dispatch_steps`` segments, video2video and ``output_type="device"``.
Frame sharding (ROADMAP Queue 1 item 14) raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import pathlib
import warnings
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from vdx_torch.core import checkpoint as ckpt
from vdx_torch.core import convert, rng
from vdx_torch.core import lora as L
from vdx_torch.core.dtypes import DEFAULT_POLICY, Policy
from vdx_torch.core.safetensors_io import load_file, save_file
from vdx_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from vdx_torch.models.tokenizer import load_tokenizer
from vdx_torch.models.unet_motion import UNetMotion, UNetMotionConfig
from vdx_torch.models.vae import AutoencoderKL, VAEConfig
from vdx_torch.pipelines.context import (ContextConfig, make_freenoise_maker,
                                         make_windowed_apply)
from vdx_torch.schedulers import get_sampler, is_multistep, make_tables_for
from vdx_torch.schedulers.common import cfg_combine, pad_tables


@dataclasses.dataclass(frozen=True)
class PABConfig:
    """Pyramid Attention Broadcast schedule (vdx's ``PABConfig``): each
    attention type's output is reused between refreshes, cross-attention
    longest, spatial shortest; the first and last steps always refresh.
    An interval of 1 computes that type every step and caches nothing."""

    spatial_interval: int = 2
    temporal_interval: int = 4
    cross_interval: int = 6
    #: joint text+video attention (CogVideoX-class DiTs, ROADMAP item 11);
    #: UNetMotion has none
    joint_interval: int = 2
    warmup_steps: int = 2
    cooldown_steps: int = 2


def pab_refresh_flags(pab: PABConfig, i: int, num_steps: int) -> dict:
    """Step i's refresh flag per attention type (Python bools, from the
    global step index): ``hot or i % interval == 0``, hot in the warm-up
    and cool-down; None for an interval of 1. Step 0 always refreshes."""
    hot = i < pab.warmup_steps or i >= num_steps - pab.cooldown_steps

    def flag(interval):
        return None if interval == 1 else bool(hot or i % interval == 0)

    return {"spatial": flag(pab.spatial_interval),
            "temporal": flag(pab.temporal_interval),
            "cross": flag(pab.cross_interval)}


@dataclasses.dataclass(frozen=True)
class SkipConfig:
    """Adaptive whole-step model-output reuse (TeaCache-class turbo mode;
    vdx's ``SkipConfig``). The relative L1 change of the sampler-scaled
    latents accumulates between steps; once it reaches ``threshold`` the
    denoiser evaluates again, else its previous output is reused.
    ``threshold=0`` evaluates every step (bit-exact against the plain
    loop). Warm-up and cool-down steps always evaluate."""

    #: accumulated relative-L1 latent change that triggers a re-eval
    threshold: float = 0.08
    warmup_steps: int = 3
    cooldown_steps: int = 3

    def __post_init__(self):
        # step 0 has no previous output to reuse — it must evaluate
        if self.warmup_steps < 1:
            raise ValueError("skip turbo mode needs warmup_steps >= 1")
        if self.threshold < 0:
            raise ValueError("threshold must be >= 0")


@dataclasses.dataclass
class PipelineOutput:
    """``frames[b]`` is video b: a uint8 [F, H, W, 3] array for
    output_type="np", a list of PIL images for "pil" (and any other
    string but "latent" and "device", as vdx); for "device",
    ``frames`` is one uint8 [B, F, H, W, 3] tensor on the pipeline's
    device."""

    frames: Any
    latents: Optional[torch.Tensor] = None
    #: skip turbo mode only: the denoiser evaluations the loop made (an
    #: int32 tensor on the pipeline's device)
    n_evals: Optional[torch.Tensor] = None


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


@dataclasses.dataclass
class _Request:
    """One request's constants for the denoise loop."""

    context: torch.Tensor
    guidance: bool
    #: a Python float, or a tensor on the device: rank 1 is a per-step
    #: schedule indexed by the step, higher ranks broadcast as they are
    guidance_scale: Union[float, torch.Tensor]
    scheduler: str
    tables: Any
    sampler_cfg: Any
    #: the schedule's step count N (progress's n, skip's cool-down)
    num_steps: int
    t_start: int = 0
    #: the denoiser: the UNet, or its context-windowed wrapper
    unet: Optional[Callable] = None
    #: the denoiser's conditioning after (sample, t) when it is not the
    #: text ``context`` alone (``_prepare_cond``'s ``den_args``)
    den_args: Optional[tuple] = None
    #: [2B or B, F, h, w, Cc], appended to the model input's channels
    #: after ``scale_model_input`` (``_prepare_cond``'s ``concat``)
    concat: Optional[torch.Tensor] = None

    def scale_at(self, i: int):
        g = self.guidance_scale
        return g[i] if torch.is_tensor(g) and g.dim() == 1 else g

    def cond_args(self) -> tuple:
        return (self.context,) if self.den_args is None else self.den_args


@dataclasses.dataclass
class _Carry:
    """The loop's state between steps (and between dispatch segments):
    the latents, the multistep sampler's state, skip mode's previous
    output, scaled latents and accumulated drift, the evaluations made so
    far, and PAB's attention cache."""

    latents: torch.Tensor
    sampler_state: Any = None
    prev_eps: Optional[torch.Tensor] = None
    prev_sig: Optional[torch.Tensor] = None
    accum: Optional[torch.Tensor] = None
    n_evals: int = 0
    pab_cache: Optional[dict] = None


def _channels_last_(module: torch.nn.Module) -> None:
    """Conv weights in the activations' channels-last layout (cuDNN):
    2D kernels channels_last, the frame convs' 3D kernels
    channels_last_3d."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
            elif p.dim() == 5:
                p.data = p.data.contiguous(memory_format=torch.channels_last_3d)


class VideoDiffusionPipeline:
    """Base: the request loop around a pluggable denoiser (vdx's
    ``VideoDiffusionPipeline``). A family sets ``denoiser_cls`` and
    overrides the hooks below; the base is SD-1.5's text path."""

    denoiser_cls = UNetMotion
    denoiser_config_cls = UNetMotionConfig
    #: conditioning tensors the denoiser takes after (sample, t)
    n_denoiser_cond = 1
    #: build the CFG pair whatever the guidance scale (SVD's per-frame scale)
    guidance_always = False
    #: the sampler when the constructor names none
    default_scheduler = "euler"

    def __init__(
        self,
        unet_config=None,
        vae_config: VAEConfig = VAEConfig(),
        *,
        policy: Policy = DEFAULT_POLICY,
        scheduler: Optional[str] = None,
        attn_impl: str = "auto",
        pab: Optional[PABConfig] = None,
        skip: Optional[SkipConfig] = None,
        context: Optional[ContextConfig] = None,
        frame_shards: int = 1,
        seq_impl: str = "ulysses",
        mesh=None,
        variable_steps: int = 0,
        progress: Optional[Callable[[int, int], None]] = None,
        guidance_rescale: float = 0.0,
        sampler_configs=None,
        freeu=None,
        device: Union[str, torch.device] = "cuda",
        **family,
    ):
        """Keywords after the two configs. ``family``: those of the
        family's other components, as :meth:`_component_factories` takes
        them (the text families' ``text_config`` and ``tokenizer``, SVD's
        ``vision_config``)."""
        scheduler = scheduler or self.default_scheduler
        if pab is not None and skip is not None:
            raise ValueError("pab and skip are both turbo modes with their own "
                             "denoise programs — pick one")
        if context is not None and pab is not None:
            raise ValueError("context windows and PAB are incompatible: PAB's "
                             "attention caches are sized per model call")
        if frame_shards != 1 or mesh is not None or seq_impl != "ulysses":
            raise NotImplementedError(
                "frame sharding (frame_shards, seq_impl, mesh) comes with "
                "ROADMAP Queue 1 item 14")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        get_sampler(scheduler)  # ValueError on an unknown name
        self.scheduler = scheduler
        self.policy = policy
        self.pab = pab
        self.skip = skip
        # long clips: a request past context.frames evaluates the UNet per
        # overlapping window and blends (pipelines/context.py); shorter
        # requests run the exact context-free path
        self.context = context
        self.variable_steps = variable_steps
        self.progress_callback = progress
        # CFG std-rescale (Lin et al.); 0.0 = plain CFG
        self.guidance_rescale = float(guidance_rescale)
        # sampler name -> its config dataclass (None: the module defaults)
        self.sampler_configs = dict(sampler_configs or {})
        self._warned_sampler_cfg = set()
        self._tables = {}
        #: component -> {"adapter", "pristine" tensors, "scale"}
        self._lora_active = {}
        self._has_params = False
        unet_config = unet_config or self.denoiser_config_cls()
        self._build(
            unet=lambda: self.denoiser_cls(unet_config, policy,
                                           attn_impl=attn_impl, freeu=freeu),
            **self._component_factories(vae_config, policy, **family))

    def _build(self, **factories) -> None:
        """Each component built on the meta device and materialised
        uninitialised on the pipeline's device as an attribute of that
        name (weights come from random_init_ or a state_dict); on CUDA its
        conv weights go channels-last."""
        for name, make in factories.items():
            with torch.device("meta"):
                module = make()
            module = module.to_empty(device=self.device).eval()
            if self.device.type == "cuda":
                _channels_last_(module)
            setattr(self, name, module)

    # ------------------------------------------------------------------
    # family hooks (vdx's override points)
    # ------------------------------------------------------------------
    @property
    def latent_channels(self) -> int:
        """Channels of the DENOISED latent (fewer than the denoiser's
        input when conditioning is concatenated on the channels)."""
        return self.unet.config.in_channels

    def _prepare_cond(self, key, cond, latent_shape) -> dict:
        """The request's conditioning -> {"den_args": the denoiser's
        tensors after (sample, t), "concat": None or a tensor appended to
        the model input's channels after ``scale_model_input``, "key":
        what :meth:`initial_noise` draws from (a seed, seeds, or a
        ``rng.PRNGKey``)}. Text-to-video: ``cond`` is the encoded
        context."""
        del latent_shape
        return {"den_args": (cond,), "concat": None, "key": key}

    def _decode_raw(self, chunk: int, **opts) -> Callable:
        """-> decode([B, F, h, w, C] latents) -> [B, F, H, W, 3] uint8,
        ``chunk`` frames at a time. Families with other VAEs override."""
        if opts:
            raise TypeError(f"unknown decode options {sorted(opts)}")
        vae = self.vae

        def decode(latents):
            B, F_ = latents.shape[:2]
            z = latents.reshape(B * F_ // chunk, chunk, *latents.shape[2:])
            out = [_to_uint8(vae.decode(z[n])) for n in range(z.shape[0])]
            return torch.cat(out).reshape(B, F_, *out[0].shape[1:])

        return decode

    def _component_factories(self, vae_config: VAEConfig, policy: Policy,
                             text_config: CLIPTextConfig = CLIPTextConfig(),
                             tokenizer=None) -> dict:
        """The components beside the denoiser: attribute name -> a function
        that builds it. The text families: the SD VAE and the CLIP text
        tower (and the tokenizer)."""
        self.tokenizer = tokenizer or load_tokenizer()
        return {"vae": lambda: AutoencoderKL(vae_config, policy),
                "text_encoder": lambda: CLIPTextModel(text_config, policy)}

    def _denoiser_rules(self):
        """vdx parameter path -> (torch key, transform) of the denoiser."""
        return convert.unet_motion_rules(self.unet.config)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @classmethod
    def with_random_params(cls, seed: int = 0, **kwargs) -> "VideoDiffusionPipeline":
        """Seeded random weights, generated on the pipeline's device."""
        pipe = cls(**kwargs)
        pipe.init_params(seed)
        return pipe

    def init_params(self, seed: int = 0) -> int:
        """Fill every component with seeded random weights (see
        :func:`random_init_`); returns the parameter count."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._has_params = True
        return sum(random_init_(m, gen) for m in self._components().values())

    def _components(self) -> dict:
        return {"unet": self.unet, "vae": self.vae, "text": self.text_encoder}

    def load_state_dicts(self, state_dicts: dict) -> None:
        """{component: state_dict} with diffusers names (components as
        :meth:`_components`: "unet", "vae", "text" for the text families)."""
        modules = self._components()
        for name, sd in state_dicts.items():
            modules[name].load_state_dict(sd, strict=True)
        self._has_params = True

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _conversion_rules(self) -> dict:
        """{component: (rules, allowed missing substrings)}: the port's
        copy of vdx's rule tables, which name every weight in both."""
        return {"unet": (self._denoiser_rules(), ()),
                "vae": (convert.vae_rules(self.vae.config), ()),
                "text": (convert.clip_text_rules(self.text_encoder.config), ())}

    def load_pretrained(self, sources: dict, strict: bool = True) -> dict:
        """Fill the components from torch ``.safetensors`` checkpoints
        (vdx's ``load_pretrained``). ``sources``: {component: path |
        [paths] | state dict}; several paths of one component merge into
        one state dict (the SD-1.5 UNet and the motion adapter), and
        overlapping keys raise. strict requires every component and every
        weight; otherwise what is not supplied keeps its value (seeded
        random weights from seed 0 if the pipeline had none). Tensors are
        cast to each parameter's dtype. Returns {component: report} with
        vdx's keys ``missing``, ``shape_errors``,
        ``unused_checkpoint_keys``; nothing is copied unless every
        component converts."""
        specs = self._conversion_rules()
        unknown = sorted(set(sources) - set(specs))
        if unknown:
            raise ValueError(f"unknown components {unknown}; "
                             f"{type(self).__name__} takes {sorted(specs)}")
        if strict:
            absent = sorted(set(specs) - set(sources))
            if absent:
                raise ValueError(f"missing components {absent} (pass "
                                 "strict=False to keep init values for them)")
        modules = self._components()
        converted, reports = {}, {}
        for comp, paths in sources.items():
            rules, allowed_missing = specs[comp]
            sd = ckpt.merge_sources(comp, paths, self.device)
            converted[comp], report = ckpt.convert_checkpoint(
                sd, modules[comp].state_dict(), rules)
            hard = [m for m in report["missing"]
                    if not any(a in m for a in allowed_missing)]
            if strict and (hard or report["shape_errors"]):
                raise ValueError(f"{comp}: conversion failed:\n"
                                 + "\n".join((hard + report["shape_errors"])[:20]))
            reports[comp] = report
        if not self._has_params and not strict:
            self.init_params(0)
        for comp, tensors in converted.items():
            modules[comp].load_state_dict(
                {k: torch.as_tensor(v) for k, v in tensors.items()}, strict=False)
        self._has_params = True
        return reports

    @classmethod
    def from_pretrained(cls, sources: dict, strict: bool = True, **kwargs):
        """Build the pipeline and :meth:`load_pretrained` into it."""
        pipe = cls(**kwargs)
        pipe.load_pretrained(sources, strict=strict)
        return pipe

    def save_checkpoint(self, path) -> None:
        """Every component's weights into the directory ``path`` (made if
        absent), one ``<component>.safetensors`` each in its own dtypes.
        vdx writes an Orbax directory, which the card's machine cannot
        read or write (no ``orbax`` there: ROADMAP Queue 3, F10)."""
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        for name, module in self._components().items():
            save_file(module.state_dict(), path / f"{name}.safetensors",
                      metadata={"format": "pt", "component": name})

    def load_checkpoint(self, path) -> None:
        """The weights of a :meth:`save_checkpoint` directory (names and
        shapes checked by ``load_state_dict``)."""
        path = pathlib.Path(path)
        for name, module in self._components().items():
            module.load_state_dict(
                load_file(path / f"{name}.safetensors", self.device), strict=True)
        self._has_params = True

    # ------------------------------------------------------------------
    # LoRA adapters
    # ------------------------------------------------------------------
    def load_lora(self, source, scale: float = 1.0, component: str = None,
                  targets=None, strict: bool = True) -> Optional[dict]:
        """Attach a LoRA adapter to one component (default the UNet).
        ``source``: a ``.safetensors`` path, a torch LoRA state dict (peft,
        old diffusers processor or kohya keys), or an adapter tree
        (core/lora.py). The adapted weights become ``W + scale * delta``
        (fp32, cast back); loading replaces any adapter already active;
        the pristine tensors are kept, so ``unload_lora`` and
        ``set_lora_scale`` are exact. Returns the conversion report for
        a torch state dict."""
        component = component or "unet"
        targets = tuple(targets or L.DEFAULT_TARGETS)
        module = self._components()[component]
        report = None
        if not isinstance(source, dict) or L.is_lora_state_dict(source):
            if not isinstance(source, dict):
                source = load_file(source)
            source, report = L.convert_lora_checkpoint(
                source, module.state_dict(), targets=targets, strict=strict,
                rules=self._conversion_rules()[component][0])
        self._lora_restore(component)  # drop any active adapter
        params = dict(module.named_parameters())
        self._lora_active[component] = {
            "adapter": source,
            "pristine": {p: params[p].data for p in source if p in params},
            "scale": float(scale)}
        self._lora_merge(component)
        return report

    def set_lora_scale(self, scale: float, component: str = None) -> None:
        """Re-merge the active adapter at a new scale, from the pristine
        weights (scales never accumulate rounding)."""
        component = component or "unet"
        if component not in self._lora_active:
            raise ValueError(f"no LoRA active on {component!r}")
        self._lora_active[component]["scale"] = float(scale)
        self._lora_restore(component)
        self._lora_merge(component)

    def unload_lora(self, component: str = None) -> None:
        """Detach the adapter: the pristine tensors go back, bit for bit."""
        component = component or "unet"
        if component not in self._lora_active:
            raise ValueError(f"no LoRA active on {component!r}")
        self._lora_restore(component)
        del self._lora_active[component]

    def _lora_restore(self, component: str) -> None:
        state = self._lora_active.get(component)
        if state is None:
            return
        params = dict(self._components()[component].named_parameters())
        for p, t in state["pristine"].items():
            params[p].data = t

    def _lora_merge(self, component: str) -> None:
        state = self._lora_active[component]
        params = dict(self._components()[component].named_parameters())
        merged = L.merge_lora({p: t.data for p, t in params.items()},
                              state["adapter"], state["scale"])
        for p, t in merged.items():
            params[p].data = t

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_prompt(self, prompt: Union[str, Sequence[str]],
                      negative_prompt: str = "") -> torch.Tensor:
        """-> [2B, 77, D] context, ordered (uncond x B, cond x B) to match
        the CFG batch split; B = 1 for a string prompt."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        ids = self.tokenizer([negative_prompt or ""] * len(prompts) + prompts)
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return self.text_encoder(ids)

    def _sampler_cfg(self, scheduler: str):
        """The pipeline's config for this sampler, or None for the module's
        SD-1.5 defaults; warns once per sampler when configs were given
        for others (sampling with the wrong constants is silently wrong)."""
        cfg = self.sampler_configs.get(scheduler)
        if cfg is None and self.sampler_configs \
                and scheduler not in self._warned_sampler_cfg:
            warnings.warn(
                f"{type(self).__name__} has checkpoint-faithful configs for "
                f"{sorted(self.sampler_configs)} but none for "
                f"scheduler={scheduler!r}; falling back to the sampler "
                "module's SD-1.5 defaults (epsilon prediction, linear betas) "
                "— pass sampler_configs={...} if that is not what this "
                "checkpoint was trained with", stacklevel=3)
            self._warned_sampler_cfg.add(scheduler)
        return cfg

    def _get_tables(self, scheduler: str, num_steps: int, max_steps: int = 0):
        """The sampler's tables on the pipeline's device, built once per
        (sampler, step count, padded length, config) and cached: no
        per-call host work. ``max_steps`` > 0 edge-pads them to that many
        steps (``variable_steps``)."""
        cfg = self._sampler_cfg(scheduler)
        key = (scheduler.lower(), num_steps, max_steps, cfg)
        if key not in self._tables:
            tables = make_tables_for(scheduler, num_steps, cfg, device=self.device)
            if max_steps:
                tables = pad_tables(tables, num_steps, max_steps)
            self._tables[key] = tables
        return self._tables[key]

    def initial_noise(self, latent_shape, seed) -> torch.Tensor:
        """vdx's initial noise (vdx_torch.core.rng: the same threefry bits
        on the CPU and on the card). ``seed``: an int, a ``rng.PRNGKey``
        (``_prepare_cond``'s key), or for B = latent_shape[0] > 1 one of
        those a video (a scalar serves every video). Under ``context``
        with FreeNoise and a clip past one window, the noise is
        FreeNoise's (pipelines/context.py)."""
        B = latent_shape[0]
        if B == 1:
            if isinstance(seed, (list, tuple)) and not isinstance(seed, rng.PRNGKey):
                (seed,) = seed
            seeds = [seed]
        else:
            seeds = (list(seed) if isinstance(seed, (list, tuple))
                     and not isinstance(seed, rng.PRNGKey) else [seed] * B)
            if len(seeds) != B:  # vdx's exception type (an assert in _seed_keys)
                raise AssertionError(f"got {len(seeds)} seeds for {B} prompts")
        keys = [s if isinstance(s, rng.PRNGKey) else rng.prng_key(int(s))
                for s in seeds]
        ctx = self.context
        if ctx is not None and ctx.freenoise and latent_shape[1] > ctx.frames:
            make = make_freenoise_maker(latent_shape, ctx.frames, self.device)
            return make(keys)
        if B == 1:
            return rng.key_normal(keys[0], latent_shape, self.device)
        return torch.stack([rng.key_normal(k, latent_shape[1:], self.device)
                            for k in keys])

    def _eval(self, req: _Request, latents: torch.Tensor, i: int,
              carry: Optional[_Carry] = None) -> torch.Tensor:
        """One CFG-batched denoiser evaluation at step i (a Python int: no
        host synchronisation); calls ``progress(i, N)``. Under PAB (given
        the loop's ``carry``) the UNet runs with step i's refresh flags
        and the carry's attention cache, and, as vdx's PAB program,
        reports no progress."""
        sampler = get_sampler(req.scheduler)
        model_in = torch.cat([latents, latents]) if req.guidance else latents
        model_in = sampler.scale_model_input(model_in, i, req.tables)
        if req.concat is not None:
            model_in = torch.cat([model_in, req.concat.to(model_in.dtype)], dim=-1)
        t_b = req.tables.timesteps[i].expand(model_in.shape[0])
        pab = self.pab is not None and carry is not None
        if pab:
            eps, carry.pab_cache = self.unet(
                model_in, t_b, *req.cond_args(),
                pab_refresh=pab_refresh_flags(self.pab, i, req.num_steps),
                pab_cache=carry.pab_cache)
        else:
            eps = (req.unet or self.unet)(model_in, t_b, *req.cond_args())
        if req.guidance:
            u, c = eps.chunk(2)
            eps = cfg_combine(u, c, req.scale_at(i), self.guidance_rescale)
        if self.progress_callback is not None and not pab:
            self.progress_callback(i, req.num_steps)
        return eps

    def _step(self, req: _Request, carry: _Carry, eps: torch.Tensor, i: int):
        sampler = get_sampler(req.scheduler)
        kw = {} if req.sampler_cfg is None else {"cfg": req.sampler_cfg}
        if is_multistep(req.scheduler):
            carry.latents, carry.sampler_state = sampler.step_multistep(
                carry.latents, eps, i, carry.sampler_state, req.tables, **kw)
        else:
            carry.latents = sampler.step(carry.latents, eps, i, req.tables, **kw)

    @torch.inference_mode()
    def denoise_step(self, latents: torch.Tensor, i: int, context: torch.Tensor,
                     guidance_scale, guidance: bool, scheduler: str, tables,
                     state=None):
        """One CFG-batched UNet evaluation and sampler update at step i
        (no context windows, no PAB cache). -> (latents, state); ``state``
        is the multistep sampler's carry, None for the others."""
        req = _Request(context, guidance, guidance_scale, scheduler, tables,
                       self._sampler_cfg(scheduler), len(tables.timesteps))
        carry = _Carry(latents, state)
        self._step(req, carry, self._eval(req, latents, i), i)
        return carry.latents, carry.sampler_state

    def _run_steps(self, req: _Request, carry: _Carry, a: int, b: int) -> None:
        """Steps [a, b) of the schedule on ``carry``, in place."""
        if self.skip is None:
            for i in range(a, b):
                self._step(req, carry, self._eval(req, carry.latents, i, carry), i)
            return
        # Skip turbo mode (vdx's scan body): the drift test is read on the
        # host, one scalar per step that is not a forced evaluation.
        sampler, skip = get_sampler(req.scheduler), self.skip
        for i in range(a, b):
            sig = sampler.scale_model_input(carry.latents, i, req.tables).float()
            rel = (sig - carry.prev_sig).abs().mean() \
                / (carry.prev_sig.abs().mean() + 1e-8)
            carry.accum = carry.accum + rel
            forced = (i < req.t_start + skip.warmup_steps
                      or i >= req.num_steps - skip.cooldown_steps)
            if forced or bool(carry.accum >= skip.threshold):
                carry.prev_eps = self._eval(req, carry.latents, i).float()
                carry.accum = torch.zeros_like(carry.accum)
                carry.n_evals += 1
            self._step(req, carry, carry.prev_eps, i)
            carry.prev_sig = sig

    @torch.inference_mode()
    def _denoise(self, req: _Request, latents: torch.Tensor,
                 dispatch_steps: int = 0) -> _Carry:
        """The denoise loop from ``latents`` over steps [req.t_start, N).
        With ``dispatch_steps`` = K it runs as segments [0, K), [K, 2K),
        ... that hand the carry on, with no host sync between them (vdx's
        segmented dispatch; the same operations, so the same bits). PAB's
        attention cache rides the carry too: step 0 fills it, and every
        refresh flag comes from the global step index."""
        carry = _Carry(latents)
        if is_multistep(req.scheduler):
            carry.sampler_state = get_sampler(req.scheduler).init_state(latents)
        if self.skip is not None:
            carry.prev_eps = torch.zeros(latents.shape, device=latents.device)
            carry.prev_sig = torch.zeros(latents.shape, device=latents.device)
            carry.accum = torch.zeros((), device=latents.device)
        N = req.num_steps
        bounds = (list(range(req.t_start, N, dispatch_steps)) + [N]
                  if dispatch_steps else [req.t_start, N])
        for a, b in zip(bounds[:-1], bounds[1:]):
            self._run_steps(req, carry, a, b)
        return carry

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor, chunk: int, **opts) -> torch.Tensor:
        """[B, F, h, w, C] latents -> [B, F, H, W, 3] uint8, decoded
        ``chunk`` frames at a time (the family's :meth:`_decode_raw`)."""
        return self._decode_raw(chunk, **opts)(latents)

    @torch.inference_mode()
    def _encode(self, video: torch.Tensor, chunk: int) -> torch.Tensor:
        """[B, F, H, W, 3] in [-1, 1] -> [B, F, h, w, C] scaled posterior
        means, encoded ``chunk`` frames at a time."""
        B, F_ = video.shape[:2]
        x = video.reshape(B * F_ // chunk, chunk, *video.shape[2:])
        out = [self.vae.encode(x[n]) for n in range(x.shape[0])]
        return torch.cat(out).reshape(B, F_, *out[0].shape[1:])

    # ------------------------------------------------------------------
    # public API (vdx's argument names)
    # ------------------------------------------------------------------
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        negative_prompt: str = "",
        num_frames: int = 16,
        guidance_scale=7.5,
        num_inference_steps: int = 25,
        height: int = 512,
        width: int = 512,
        seed: Union[int, Sequence[int]] = 0,
        scheduler: Optional[str] = None,
        output_type: str = "pil",
        decode_chunk: int = 8,
        video=None,
        strength: float = 0.8,
        dispatch_steps: int = 0,
    ) -> PipelineOutput:
        """Text-to-video; ``video`` ([F, H, W, 3] or [B, F, H, W, 3], uint8
        or float in [-1, 1]) makes it video2video (SDEdit): the clip is
        VAE-encoded, diffused to ``strength`` of the schedule and denoised
        over the remaining steps; ``num_frames``/``height``/``width`` then
        come from the clip. ``guidance_scale`` of rank 1 is a per-step
        schedule of ``num_inference_steps`` entries. ``dispatch_steps`` = K
        runs the loop as segments of K steps. output_type "device" leaves
        the frames on the device and returns without a host sync; "latent"
        returns the latents only, "np" numpy frames, and any other string
        PIL frames, as vdx."""
        scheduler = scheduler or self.scheduler
        N = num_inference_steps
        t_start = 0
        if video is not None:
            if self.pab is not None:
                raise ValueError("video2video does not compose with PAB")
            if is_multistep(scheduler):
                raise ValueError("video2video supports ddim/euler/edm samplers "
                                 "(a multistep state assumes a full trajectory)")
            if not 0.0 < strength <= 1.0:
                raise ValueError(f"strength must be in (0, 1], got {strength}")
            video = torch.as_tensor(video if torch.is_tensor(video)
                                    else np.asarray(video), device=self.device)
            if video.dim() == 4:
                video = video[None]
            video = (video.float() / 127.5 - 1.0 if video.dtype == torch.uint8
                     else video.float())
            _, num_frames, height, width = video.shape[:4]
            # SDEdit truncation: at least one step for any strength > 0
            t_start = N - min(max(int(N * strength), 1), N)
        B = 1 if isinstance(prompt, str) else len(prompt)
        if video is not None and video.shape[0] != B:
            raise ValueError(f"video batch {video.shape[0]} != prompt batch {B}")
        guidance = (self.guidance_always
                    or float(np.max(np.asarray(guidance_scale, np.float32))) > 1.0)
        context = self.encode_prompt(prompt, negative_prompt)  # [2B, 77, D]
        if not guidance:
            context = context[B:]
        ds = self.vae.config.downscale
        latent_shape = (B, num_frames, height // ds, width // ds,
                        self.latent_channels)
        return self._run_generate(
            cond=context, guidance_scale=guidance_scale, guidance=guidance,
            latent_shape=latent_shape, scheduler=scheduler,
            num_inference_steps=N, seed=seed, decode_chunk=decode_chunk,
            output_type=output_type, video=video, t_start=t_start,
            dispatch_steps=dispatch_steps)

    def _run_generate(self, *, cond, guidance_scale, guidance: bool,
                      latent_shape, scheduler: str, num_inference_steps: int,
                      seed, decode_chunk: int, decode_opts=None,
                      output_type: str = "pil", video=None, t_start: int = 0,
                      dispatch_steps: int = 0) -> PipelineOutput:
        """The family-independent request path (vdx's ``_run_generate``):
        the guidance array (a scalar, a per-step schedule or a per-frame
        tensor), the tables, the family's conditioning and noise, the
        denoise loop, the decode and the output."""
        N = num_inference_steps
        B, num_frames = latent_shape[:2]
        if self.pab is not None and is_multistep(scheduler):
            raise ValueError("PAB turbo mode supports ddim/euler/edm samplers")
        segmented = bool(dispatch_steps) and dispatch_steps < N
        if segmented and video is not None:
            raise ValueError("dispatch_steps does not compose with video2video")

        gs = np.asarray(guidance_scale, np.float32)
        use_var = (self.variable_steps > 0 and self.skip is None
                   and self.pab is None and video is None and not segmented
                   and N <= self.variable_steps)
        tables = self._get_tables(scheduler, N,
                                  self.variable_steps if use_var else 0)
        if gs.ndim == 1:
            # a per-step schedule: checked here (an index past its end
            # would fail mid-loop), edge-padded to the padded tables
            if gs.shape[0] != N:
                raise ValueError(f"per-step guidance schedule has "
                                 f"{gs.shape[0]} entries for {N} steps")
            if use_var:
                gs = np.pad(gs, (0, self.variable_steps - N), mode="edge")
        # rank 0: a Python float; rank 1: a per-step schedule indexed on the
        # device; higher ranks (SVD's per-frame [1, F, 1, 1, 1]) broadcast
        scale = float(gs) if gs.ndim == 0 else torch.as_tensor(gs, device=self.device)

        chunk = max(1, min(decode_chunk, num_frames))
        while num_frames % chunk:
            chunk -= 1
        prep = self._prepare_cond(seed, cond, latent_shape)
        unet = self.unet
        if self.context is not None and num_frames > self.context.frames:
            unet = make_windowed_apply(
                self.unet, total_frames=num_frames,
                out_channels=self.latent_channels, cfg=self.context)
        req = _Request(None, guidance, scale, scheduler, tables,
                       self._sampler_cfg(scheduler), N, t_start, unet,
                       den_args=prep["den_args"], concat=prep["concat"])
        noise = self.initial_noise(latent_shape, prep["key"])
        if video is None:
            latents = noise * tables.init_noise_sigma
        else:
            z = self._encode(video, chunk)
            latents = get_sampler(scheduler).add_noise_at(
                z.float(), noise, t_start, tables)
        carry = self._denoise(req, latents,
                              dispatch_steps=dispatch_steps if segmented else 0)
        latents = carry.latents
        n_evals = (None if self.skip is None else
                   torch.tensor(carry.n_evals, dtype=torch.int32, device=self.device))
        if output_type == "latent":
            return PipelineOutput(frames=[], latents=latents, n_evals=n_evals)
        frames = self._decode(latents, chunk, **(decode_opts or {}))
        if output_type == "device":
            return PipelineOutput(frames=frames, latents=latents, n_evals=n_evals)
        frames = frames.cpu().numpy()
        if output_type == "np":
            return PipelineOutput(frames=[frames[b] for b in range(B)],
                                  latents=latents, n_evals=n_evals)
        from PIL import Image

        return PipelineOutput(
            frames=[[Image.fromarray(f) for f in frames[b]] for b in range(B)],
            latents=latents, n_evals=n_evals)


class AnimateDiffPipeline(VideoDiffusionPipeline):
    """SD-1.5 + motion modules (the reference's flagship pipeline)."""

    denoiser_cls = UNetMotion
    denoiser_config_cls = UNetMotionConfig
