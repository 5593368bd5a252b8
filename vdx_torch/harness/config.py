"""Experiment configuration, the grid study's contract (port of
vdx/harness/config.py).

``ExperimentConfig`` has the reference dataclass's fields in its order
(reference experiments/05_grid_search_ablation.py:101-114), so
``config.json`` is byte for byte vdx's: the analysis layer keys off these
names (07:67-90), and the file is the resume commit marker. Also the
study's fixed grids and its prompt bank (05:40-94).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

SEED = 42
NUM_FRAMES = 16
HEIGHT = 512
WIDTH = 512
DEFAULT_CFG = 7.5
DEFAULT_STEPS = 25
CFG_VALUES = [5.0, 6.0, 7.0, 7.5, 8.0, 9.0]
STEPS_VALUES = [15, 20, 25, 30, 40, 50]

# The study's six test videos with baseline + enhanced prompt pairs
# (configuration data mirrored from reference 05:57-94 — the prompt bank IS
# the benchmark definition).
TEST_VIDEOS = {
    "birds_flying": {
        "prompt_baseline": "birds flying across a blue sky, nature documentary",
        "negative_baseline": "bad quality, blurry, distorted",
        "prompt_enhanced": "birds flying across a blue sky, nature documentary, smooth motion, consistent shapes",
        "negative_enhanced": "flickering, morphing birds, changing shapes, unstable, jittery feathers, bad quality, blurry, distorted",
    },
    "corgi_beach": {
        "prompt_baseline": "a corgi walking on the beach, sunset lighting, high quality",
        "negative_baseline": "bad quality, blurry, distorted",
        "prompt_enhanced": "a corgi walking on the beach, sunset lighting, steady camera, smooth motion, high quality",
        "negative_enhanced": "flickering water, unstable waves, jittery, morphing, shaky, bad quality, blurry, distorted",
    },
    "mig21_missile": {
        "prompt_baseline": "MiG-21 fighter jet firing missile, action shot, cinematic",
        "negative_baseline": "bad quality, blurry, distorted",
        "prompt_enhanced": "MiG-21 fighter jet firing missile, smooth motion blur, cinematic, steady tracking shot",
        "negative_enhanced": "flickering, jittery, teleporting, inconsistent trail, morphing, bad quality, blurry, distorted",
    },
    "woman_waving": {
        "prompt_baseline": "a woman waving her hand, portrait, studio lighting",
        "negative_baseline": "bad quality, blurry, distorted",
        "prompt_enhanced": "a woman waving her hand, portrait, studio lighting, smooth natural motion",
        "negative_enhanced": "flickering hands, morphing fingers, jittery, distorted hands, bad quality, blurry, deformed",
    },
    "portrait": {
        "prompt_baseline": "portrait of a man with glasses, professional photo, static pose",
        "negative_baseline": "bad quality, blurry, distorted",
        "prompt_enhanced": "portrait of a man with glasses, professional photo, static pose, consistent lighting",
        "negative_enhanced": "flickering, changing expression, morphing face, unstable features, bad quality, blurry, distorted",
    },
    "landscape": {
        "prompt_baseline": "a beautiful mountain landscape, lake reflection, golden hour, serene",
        "negative_baseline": "bad quality, blurry, distorted",
        "prompt_enhanced": "a beautiful mountain landscape, lake reflection, golden hour, still water, serene",
        "negative_enhanced": "flickering water, rippling, moving clouds, windy, bad quality, blurry, distorted",
    },
}


@dataclasses.dataclass
class ExperimentConfig:
    """One experiment; serialises to config.json (the resume commit-marker)."""

    experiment_id: str
    video_name: str
    prompt: str
    negative_prompt: str
    guidance_scale: float
    num_inference_steps: int
    phase: str
    seed: int = SEED
    num_frames: int = NUM_FRAMES
    height: int = HEIGHT
    width: int = WIDTH

    def save(self, path: Path) -> None:
        """Atomic write (tmp + rename): config.json is the COMMIT MARKER of
        the resume contract (written last, after frames/GIF — reference
        experiments/05_grid_search_ablation.py:184-187), so a preempted or
        kill -9'd study must never leave a truncated marker that falsely
        marks an experiment complete. POSIX rename is all-or-nothing."""
        import os

        path = Path(path)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: Path) -> "ExperimentConfig":
        with open(path) as f:
            return cls(**json.load(f))
