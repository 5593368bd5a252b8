from vdx_torch.io.frames import export_to_gif, save_frames

__all__ = ["export_to_gif", "save_frames"]
