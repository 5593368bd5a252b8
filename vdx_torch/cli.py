"""Console entry points of the port (``vdx-torch``; port of vdx/cli.py):

    vdx-torch generate  — one clip from a prompt (gif + per-frame PNGs)
    vdx-torch serve     — the HTTP generation server
    vdx-torch analyze   — basic / comprehensive analysis over metric JSON
    vdx-torch train     — not ported yet (ROADMAP item 14)
    vdx-torch convert   — not ported yet (ROADMAP item 14)

Every command that builds a pipeline runs it on the card unless
``--device cpu`` is given. ``generate`` writes its files through Pillow
and ``analyze`` reads through pandas, on the host that has them;
``serve`` needs neither.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _pipeline_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint", help="the port's checkpoint directory "
                   "(save_checkpoint: one .safetensors per component); "
                   "random weights from seed 0 otherwise")
    p.add_argument("--scheduler", default="ddim",
                   choices=["ddim", "euler", "dpm", "dpm_edm", "edm"])
    p.add_argument("--skip", type=float, default=0.0, metavar="THRESH",
                   help="adaptive step-skip turbo threshold (0 = off)")
    p.add_argument("--freeu", action="store_true",
                   help="FreeU backbone/skip re-weighting (published "
                        "SD-1.5 constants)")
    p.add_argument("--context", type=int, default=0, metavar="FRAMES",
                   help="temporal context window for long clips (0 = off)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs in fp32 (CPU smoke test)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (default cuda)")


def _build_pipeline(args, **extra):
    from vdx_torch.pipelines import AnimateDiffPipeline, ContextConfig
    from vdx_torch.pipelines.base import SkipConfig

    kwargs = dict(extra)
    if args.tiny:
        from vdx_torch.core.dtypes import FP32_POLICY
        from vdx_torch.models.clip_text import CLIPTextConfig
        from vdx_torch.models.unet_motion import UNetMotionConfig
        from vdx_torch.models.vae import VAEConfig

        kwargs.update(unet_config=UNetMotionConfig.tiny(),
                      vae_config=VAEConfig.tiny(),
                      text_config=CLIPTextConfig.tiny(),
                      policy=FP32_POLICY)
    if args.skip > 0:
        kwargs["skip"] = SkipConfig(threshold=args.skip)
    if args.freeu:
        from vdx_torch.nn.freeu import FreeUConfig

        kwargs["freeu"] = FreeUConfig()
    if args.context > 0:
        kwargs["context"] = ContextConfig(
            frames=args.context, stride=max(args.context // 2, 1)
        )
    if args.checkpoint:
        pipe = AnimateDiffPipeline(scheduler=args.scheduler,
                                   device=args.device, **kwargs)
        pipe.load_checkpoint(args.checkpoint)
        return pipe
    return AnimateDiffPipeline.with_random_params(
        seed=0, scheduler=args.scheduler, device=args.device, **kwargs
    )


def generate(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vdx-torch generate",
        description="Generate one video clip (gif + per-frame PNGs)")
    p.add_argument("prompt")
    p.add_argument("--negative-prompt",
                   default="bad quality, blurry, distorted")
    p.add_argument("--output", default="outputs/generate")
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--cfg", type=float, default=7.5)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    _pipeline_args(p)
    args = p.parse_args(argv)

    from vdx_torch.io.frames import export_to_gif, save_frames

    pipe = _build_pipeline(args)
    out = pipe(args.prompt, negative_prompt=args.negative_prompt,
               num_frames=args.num_frames, num_inference_steps=args.steps,
               guidance_scale=args.cfg, height=args.height, width=args.width,
               seed=args.seed, output_type="np")
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    export_to_gif(out.frames[0], outdir / "video.gif")
    save_frames(out.frames[0], outdir / "frames")
    print(f"wrote {outdir}/video.gif + {args.num_frames} frames")
    return 0


def build_server(argv=None):
    """``serve``'s arguments -> a GenerationServer, not started: a
    BatchingGenerationService behind it when --batch-window-ms > 0."""
    p = argparse.ArgumentParser(
        prog="vdx-torch serve", description="HTTP generation server "
        "(POST /generate, /v2v, /jobs; GET /healthz, /jobs/{id})")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help=">0 enables request micro-batching")
    _pipeline_args(p)
    args = p.parse_args(argv)

    from vdx_torch.serving.server import (
        BatchingGenerationService, GenerationServer, GenerationService,
    )

    pipe = _build_pipeline(args)
    svc = (BatchingGenerationService(
               pipe, batch_window_s=args.batch_window_ms / 1e3)
           if args.batch_window_ms > 0 else GenerationService(pipe))
    return GenerationServer(svc, host=args.host, port=args.port)


def serve(argv=None) -> int:
    import threading

    server = build_server(argv)
    server.start()
    host, port = server.httpd.server_address[:2]
    print(f"serving on http://{host}:{port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


def analyze(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vdx-torch analyze",
        description="Grid-search analysis (reference experiments 07/08)")
    p.add_argument("--comprehensive", action="store_true")
    args, rest = p.parse_known_args(argv)
    if args.comprehensive:
        from vdx_torch.analysis.comprehensive import main as m
    else:
        from vdx_torch.analysis.basic import main as m
    m(rest)
    return 0


def _not_ported(name: str):
    def command(argv=None) -> int:
        print(f"vdx-torch {name}: not ported yet; it comes with ROADMAP "
              "Queue 1 item 14 (training and parallel)", file=sys.stderr)
        return 2

    return command


_COMMANDS = {
    "generate": generate,
    "serve": serve,
    "analyze": analyze,
    "train": _not_ported("train"),
    "convert": _not_ported("convert"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(sorted(_COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; one of {sorted(_COMMANDS)}",
              file=sys.stderr)
        return 2
    return _COMMANDS[cmd](argv[1:]) or 0


if __name__ == "__main__":
    raise SystemExit(main())
