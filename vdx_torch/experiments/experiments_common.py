"""The experiment CLIs' shared pipeline loader (port of
experiments/experiments_common.py)."""

from __future__ import annotations


def load_pipeline(tiny: bool = False, scheduler: str = "ddim",
                  variable_steps: int = 50, checkpoint=None,
                  device: str = "cuda"):
    """The full (bf16 SD-1.5) or tiny (fp32) AnimateDiff pipeline on
    ``device``. Weights: the port's checkpoint directory ``checkpoint``
    (``save_checkpoint``: one .safetensors per component; vdx's Orbax
    directories are not read, ROADMAP F10) when given, else seeded random
    weights from seed 0. ``variable_steps`` (default 50, at least the
    grid's largest step count) pads every request's tables to one length,
    as vdx's one program serves every step count."""
    from vdx_torch.core.dtypes import BF16_POLICY, FP32_POLICY
    from vdx_torch.pipelines import AnimateDiffPipeline

    kwargs = dict(scheduler=scheduler, variable_steps=variable_steps,
                  device=device)
    if tiny:
        from vdx_torch.models.clip_text import CLIPTextConfig
        from vdx_torch.models.unet_motion import UNetMotionConfig
        from vdx_torch.models.vae import VAEConfig

        kwargs.update(unet_config=UNetMotionConfig.tiny(),
                      vae_config=VAEConfig.tiny(),
                      text_config=CLIPTextConfig.tiny(), policy=FP32_POLICY)
    else:
        kwargs.update(policy=BF16_POLICY)
    if checkpoint:
        pipe = AnimateDiffPipeline(**kwargs)
        pipe.load_checkpoint(checkpoint)
        return pipe
    return AnimateDiffPipeline.with_random_params(seed=0, **kwargs)
