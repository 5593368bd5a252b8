"""Console entry points of the port (``vdx-torch``; port of vdx/cli.py):

    vdx-torch generate  — one clip from a prompt (gif + per-frame PNGs)
    vdx-torch serve     — the HTTP generation server
    vdx-torch analyze   — basic / comprehensive analysis over metric JSON
    vdx-torch train     — fine-tune the motion UNet on frame clips (full or
                          LoRA); writes the port's checkpoint directory or
                          a peft-keyed adapter .safetensors
    vdx-torch convert   — diffusers .safetensors -> the port's checkpoint
                          directory (or a LoRA file -> the port's adapter)

Every command that builds a pipeline runs it on the card unless
``--device cpu`` is given. ``generate`` writes its files through Pillow
and ``analyze`` reads through pandas, on the host that has them;
``serve``, ``train`` and ``convert`` need neither.
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


def train(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vdx-torch train",
        description="Fine-tune the motion UNet (eps-prediction DDPM "
        "objective) on a folder of frame clips; full or LoRA")
    p.add_argument("--data", required=True,
                   help="root dir: one subdir of frame PNGs per video")
    p.add_argument("--prompt", default="a video",
                   help="caption used as conditioning for every clip")
    p.add_argument("--out", default="outputs/train",
                   help="output dir (checkpoint/, ema/, or lora.safetensors)")
    p.add_argument("--checkpoint", help="starting checkpoint directory "
                   "(random weights from seed 0 otherwise)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--clip-frames", type=int, default=16)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation micro-batches")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward (activation "
                   "memory stops scaling with depth)")
    p.add_argument("--ema", type=float, default=0.0,
                   help=">0 keeps an EMA of the weights (saved under ema/)")
    p.add_argument("--lora", type=int, default=0, metavar="RANK",
                   help=">0 trains a rank-R LoRA adapter instead of the "
                   "full UNet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs in fp32 (CPU smoke test)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (default cuda)")
    args = p.parse_args(argv)

    from vdx_torch.core import rng
    from vdx_torch.core.lora import init_lora, save_lora
    from vdx_torch.core.safetensors_io import save_file
    from vdx_torch.data import (FrameFolderDataset, VideoClipLoader,
                                encode_clips_to_latents, prefetch_to_device)
    from vdx_torch.parallel.train import (flatten_adapter, init_train_state,
                                          make_lora_train_step,
                                          make_optimizer, make_train_step,
                                          unflatten_adapter)

    args.scheduler, args.skip, args.context, args.freeu = "ddim", 0.0, 0, False
    pipe = _build_pipeline(args)
    # the cond row of the CFG pair; encode_prompt runs under inference
    # mode, and a clone outside it is an ordinary tensor a graph can save
    ctx1 = pipe.encode_prompt(args.prompt)[1:].clone()
    ctx = ctx1.expand((args.batch,) + tuple(ctx1.shape[1:])).contiguous()

    ds = FrameFolderDataset(args.data, clip_frames=args.clip_frames,
                            size=(args.size, args.size))
    loader = VideoClipLoader(ds, batch_size=args.batch, seed=args.seed)
    print(f"dataset: {len(ds)} videos, {ds.num_clips()} clips")

    opt = make_optimizer(args.lr, warmup_steps=args.warmup,
                         total_steps=args.steps)
    model = pipe.unet
    if args.lora > 0:
        adapter = init_lora(model.state_dict(), rank=args.lora, seed=args.seed,
                            rules=pipe._conversion_rules()["unet"][0])
        flat = {n: t.to(pipe.device).requires_grad_()
                for n, t in flatten_adapter(adapter).items()}
        state, opt = init_train_state(model, flat, optimizer=opt)
        step = make_lora_train_step(model, opt, remat=args.remat)
    else:
        state, opt = init_train_state(model, optimizer=opt, ema=args.ema > 0)
        step = make_train_step(model, opt, remat=args.remat,
                               grad_accum=args.accum,
                               ema_decay=args.ema if args.ema > 0 else None)

    def clips():
        while True:  # epochs, each in the loader's seeded order
            yield from loader

    src = prefetch_to_device(clips(), pipe.device)
    key = rng.prng_key(args.seed)
    last = None
    for i in range(args.steps):
        key, sub = rng.split(key)
        lat = encode_clips_to_latents(pipe.vae, next(src)["pixels"])
        state, metrics = step(state, {"latents": lat, "context": ctx}, sub)
        if i % args.log_every == 0 or i == args.steps - 1:
            last = float(metrics["loss"])
            print(f"step {i}: loss {last:.4f}", flush=True)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.lora > 0:
        path = (outdir / "lora.safetensors").resolve()
        save_lora(unflatten_adapter(state.params), path)
        print(f"wrote LoRA adapter -> {path} (pipe.load_lora(path))")
    else:
        pipe.save_checkpoint((outdir / "checkpoint").resolve())
        if state.ema_params is not None:
            (outdir / "ema").mkdir(exist_ok=True)
            save_file(state.ema_params, outdir / "ema" / "unet.safetensors",
                      metadata={"format": "pt", "component": "unet"})
        print(f"wrote checkpoint -> {outdir / 'checkpoint'}")
    print(f"final loss {last:.4f}")
    return 0


# the families' pipelines and tiny configs (vdx's scripts/convert_checkpoint.py)
FAMILIES = ("animatediff", "modelscope", "latte", "svd", "cogvideox")


def _family_pipeline(family: str, tiny: bool, **kw):
    from vdx_torch import pipelines as P
    from vdx_torch.models.clip_text import CLIPTextConfig
    from vdx_torch.models.vae import VAEConfig

    cls = {"animatediff": P.AnimateDiffPipeline,
           "modelscope": P.TextToVideoMSPipeline, "latte": P.LattePipeline,
           "svd": P.SVDImg2VidPipeline, "cogvideox": P.CogVideoXPipeline}[family]
    if tiny:
        text = dict(vae_config=VAEConfig.tiny(), text_config=CLIPTextConfig.tiny())
        if family == "animatediff":
            from vdx_torch.models.unet_motion import UNetMotionConfig as C
            kw.update(unet_config=C.tiny(), **text)
        elif family == "modelscope":
            from vdx_torch.models.unet3d import UNet3DConfig as C
            kw.update(unet_config=C.tiny(), **text)
        elif family == "latte":
            from vdx_torch.models.dit import LatteConfig as C
            kw.update(unet_config=C.tiny(), **text)
        elif family == "svd":
            from vdx_torch.models.clip_vision import CLIPVisionConfig
            from vdx_torch.models.svd_unet import SVDUNetConfig
            kw.update(unet_config=SVDUNetConfig.tiny(),
                      vae_config=VAEConfig.tiny(),
                      vision_config=CLIPVisionConfig.tiny())
        else:
            from vdx_torch.models.cogvideox import (CausalVAEConfig,
                                                    CogVideoXConfig)
            from vdx_torch.models.t5 import T5Config
            kw.update(dit_config=CogVideoXConfig.tiny(),
                      vae_config=CausalVAEConfig.tiny(),
                      t5_config=T5Config.tiny())
    return cls(**kw)


def convert(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vdx-torch convert",
        description="diffusers .safetensors -> the port's checkpoint "
        "directory (one <component>.safetensors each), or a torch LoRA "
        "file (peft / old diffusers / kohya) -> the port's adapter file")
    p.add_argument("--family", required=True, choices=FAMILIES)
    p.add_argument("--src", action="append", default=[],
                   metavar="COMPONENT=PATH",
                   help="repeatable; repeat a component to merge files")
    p.add_argument("--out", help="output checkpoint directory")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs (smoke test)")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                   help="parameter dtype of the converted weights")
    p.add_argument("--no-strict", action="store_true",
                   help="allow missing components/keys (seeded random "
                   "weights from seed 0 for them)")
    p.add_argument("--list-components", action="store_true")
    p.add_argument("--lora", metavar="[COMPONENT=]PATH",
                   help="convert a torch LoRA .safetensors to the port's "
                   "adapter file instead; the component defaults to the "
                   "denoiser")
    p.add_argument("--lora-out", help="output .safetensors for --lora")
    p.add_argument("--device", default="cuda",
                   help="torch device the weights are converted on")
    args = p.parse_args(argv)

    from vdx_torch.core.dtypes import BF16_POLICY, FP32_POLICY

    policy = FP32_POLICY if args.dtype == "fp32" else BF16_POLICY
    pipe = _family_pipeline(args.family, args.tiny, policy=policy,
                            device=args.device)
    specs = pipe._conversion_rules()
    if args.list_components:
        for comp, (rules, allowed) in sorted(specs.items()):
            note = f" ({len(allowed)} documented-uncovered leaves)" if allowed else ""
            print(f"{comp}: {len(rules)} mapped leaves{note}")
        return 0

    if args.lora:
        if not args.lora_out:
            p.error("--lora requires --lora-out")
        from vdx_torch.core.lora import convert_lora_checkpoint, save_lora
        from vdx_torch.core.safetensors_io import load_file

        comp, _, path = args.lora.partition("=")
        if not path:
            comp, path = pipe.denoiser_param_key, comp
        if comp not in specs:
            p.error(f"unknown component {comp!r}; takes {sorted(specs)}")
        lora, report = convert_lora_checkpoint(
            load_file(path), pipe._components()[comp].state_dict(),
            strict=not args.no_strict, rules=specs[comp][0])
        print(f"lora[{comp}]: {len(report['converted'])} sites converted, "
              f"{len(report['skipped'])} targets without lora keys, "
              f"{len(report['unused_lora_keys'])} unused lora keys")
        save_lora(lora, Path(args.lora_out))
        print(f"saved adapter: {args.lora_out} (load with "
              f"pipe.load_lora(path, component={comp!r}))")
        return 0

    if not args.src or not args.out:
        p.error("--src and --out are required (or --list-components)")
    sources: dict = {}
    for item in args.src:
        comp, _, path = item.partition("=")
        if not path:
            p.error(f"--src needs COMPONENT=PATH, got {item!r}")
        sources.setdefault(comp, []).append(path)
    reports = pipe.load_pretrained(sources, strict=not args.no_strict)
    for comp, rep in sorted(reports.items()):
        print(f"{comp}: {len(rep['missing'])} missing, "
              f"{len(rep['shape_errors'])} shape errors, "
              f"{len(rep['unused_checkpoint_keys'])} unused checkpoint keys")
    pipe.save_checkpoint(Path(args.out))
    print(f"saved: {args.out} (load with pipe.load_checkpoint(path))")
    return 0


_COMMANDS = {
    "generate": generate,
    "serve": serve,
    "analyze": analyze,
    "train": train,
    "convert": convert,
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
