from vdx_torch.pipelines.base import (AnimateDiffPipeline, PipelineOutput,
                                      SkipConfig)

__all__ = ["AnimateDiffPipeline", "PipelineOutput", "SkipConfig"]
