from vdx_torch.pipelines.base import (AnimateDiffPipeline, PABConfig,
                                      PipelineOutput, SkipConfig)
from vdx_torch.pipelines.context import ContextConfig

__all__ = ["AnimateDiffPipeline", "ContextConfig", "PABConfig",
           "PipelineOutput", "SkipConfig"]
