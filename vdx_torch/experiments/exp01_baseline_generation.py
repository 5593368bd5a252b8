"""Experiment 01: baseline video generation (port of
experiments/01_baseline_generation.py).

The six test videos at the default config (16 frames at 512x512, 25
steps, CFG 7.5, seed 42, the Euler sampler), each saved as a GIF and
per-frame PNGs.

    python -m vdx_torch.experiments.exp01_baseline_generation \\
        [--output DIR] [--tiny] [--checkpoint DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

TEST_PROMPTS = [
    ("corgi_beach", "a corgi walking on the beach, sunset lighting, high quality"),
    ("woman_waving", "a pretty woman waving her hand, portrait, studio lighting"),
    ("landscape", "a beautiful mountain landscape, lake reflection, golden hour"),
    ("portrait", "portrait of a man with glasses, professional photo"),
    ("birds_flying", "birds flying across a blue sky, nature documentary"),
    ("mig21_missile", "A Mig-21 firing a missile, cloudy pink sky in the background, high quality"),
]
NEGATIVE_PROMPT = "bad quality, blurry, distorted, ugly, deformed"

DEFAULT_CONFIG = {
    "num_frames": 16,
    "num_inference_steps": 25,
    "guidance_scale": 7.5,
    "width": 512,
    "height": 512,
}


def load_pipeline(tiny: bool = False, checkpoint=None, device: str = "cuda"):
    """01's pipeline: the Euler sampler, no variable-steps padding."""
    from vdx_torch.experiments.experiments_common import load_pipeline as load

    return load(tiny=tiny, scheduler="euler", variable_steps=0,
                checkpoint=checkpoint, device=device)


def generate_video(pipe, prompt, name, output_dir: Path, seed=42, **kwargs):
    from vdx_torch.io.frames import export_to_gif, save_frames

    config = {**DEFAULT_CONFIG, **kwargs}
    print(f"\nGenerating: {name}")
    print(f"  Prompt: {prompt[:50]}...")
    out = pipe(prompt=prompt, negative_prompt=NEGATIVE_PROMPT, seed=seed,
               output_type="np", **config)
    frames = out.frames[0]
    export_to_gif(frames, output_dir / f"{name}.gif")
    save_frames(frames, output_dir / f"{name}_frames", digits=3)
    print(f"  Saved {len(frames)} frames + GIF")
    return frames


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--output", default="outputs/01_baseline")
    p.add_argument("--tiny", action="store_true",
                   help="tiny configs at reduced resolution (CPU smoke test)")
    p.add_argument("--checkpoint", default=None,
                   help="the port's checkpoint directory (save_checkpoint)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (default cuda)")
    args = p.parse_args(argv)

    output_dir = Path(args.output)
    output_dir.mkdir(parents=True, exist_ok=True)

    pipe = load_pipeline(tiny=args.tiny, checkpoint=args.checkpoint,
                         device=args.device)
    gen_kwargs = {}
    if args.tiny:
        gen_kwargs = dict(height=64, width=64, num_frames=4, num_inference_steps=3)

    print("=" * 60)
    print("Generating baseline videos")
    print("=" * 60)
    for name, prompt in TEST_PROMPTS:
        generate_video(pipe, prompt, name, output_dir, **gen_kwargs)
    print(f"\nOutputs saved to: {output_dir}")


if __name__ == "__main__":
    main()
