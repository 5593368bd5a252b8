"""Frame and GIF files (port of vdx/io/frames.py): the study's artifacts,
``frames/frame_%04d.png`` and ``{id}.gif`` at 8 fps (reference
experiments/05_grid_search_ablation.py:172-188).

Host-side work through Pillow, imported when a file is written: the
port's compute path never needs it. Frames are uint8 [H, W, 3] numpy
arrays or PIL images.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Union

import numpy as np


def _as_pil(frames):
    from PIL import Image

    return [Image.fromarray(f) if isinstance(f, np.ndarray) else f
            for f in frames]


def export_to_gif(frames: Sequence, path: Union[str, Path], fps: int = 8) -> Path:
    """A looping GIF at ``fps`` (diffusers' ``export_to_gif`` defaults).

    Every frame is quantised to ONE palette, median cut over a strip of
    64x64 thumbnails of all frames, with Floyd-Steinberg dithering, so
    the palette does not change from frame to frame (vdx's choice; PIL's
    per-frame palettes shimmer)."""
    pil = _as_pil(frames)
    path = Path(path)
    from PIL import Image

    strip = np.concatenate(
        [np.asarray(f.convert("RGB").resize((64, 64))) for f in pil], axis=0)
    palette = Image.fromarray(strip).quantize(colors=256, method=Image.MEDIANCUT)
    quantized = [f.convert("RGB").quantize(palette=palette,
                                           dither=Image.FLOYDSTEINBERG)
                 for f in pil]
    quantized[0].save(path, save_all=True, append_images=quantized[1:],
                      optimize=False, duration=int(1000 / fps), loop=0)
    return path


def save_frames(frames: Sequence, frames_dir: Union[str, Path],
                digits: int = 4) -> List[Path]:
    """``frames_dir/frame_%0{digits}d.png``, one file a frame."""
    frames_dir = Path(frames_dir)
    frames_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, frame in enumerate(_as_pil(frames)):
        p = frames_dir / f"frame_{i:0{digits}d}.png"
        frame.save(p)
        paths.append(p)
    return paths
