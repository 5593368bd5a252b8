"""Training data: frame-folder clips, the batching loader, the prefetch to
the card and the VAE encode (``loader``)."""

from vdx_torch.data.loader import (FrameFolderDataset, VideoClipLoader,
                                   encode_clips_to_latents,
                                   prefetch_to_device)

__all__ = ["FrameFolderDataset", "VideoClipLoader", "encode_clips_to_latents",
           "prefetch_to_device"]
