from vdx_torch.serving.server import (
    BatchingGenerationService,
    GenerationServer,
    GenerationService,
    Img2VidService,
    JobManager,
    ProgressRelay,
)

__all__ = ["BatchingGenerationService", "GenerationServer",
           "GenerationService", "Img2VidService", "JobManager",
           "ProgressRelay"]
