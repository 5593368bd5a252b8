from vdx_torch.pipelines.base import AnimateDiffPipeline, PipelineOutput

__all__ = ["AnimateDiffPipeline", "PipelineOutput"]
