from vdx_torch.nn.freeu import FreeUConfig
from vdx_torch.pipelines.base import (AnimateDiffPipeline, PABConfig,
                                      PipelineOutput, SkipConfig,
                                      VideoDiffusionPipeline)
from vdx_torch.pipelines.context import ContextConfig
from vdx_torch.pipelines.svd import SVDImg2VidPipeline
from vdx_torch.pipelines.text_to_video_ms import TextToVideoMSPipeline

__all__ = ["AnimateDiffPipeline", "ContextConfig", "FreeUConfig", "PABConfig",
           "PipelineOutput", "SkipConfig", "SVDImg2VidPipeline",
           "TextToVideoMSPipeline", "VideoDiffusionPipeline"]
