"""Batched experiment execution (port of vdx/harness/batched.py).

The reference runs the grid's experiments one after another
(experiments/05_grid_search_ablation.py:316-334). Experiments that share
(steps, frames, height, width) and differ in prompt, CFG and seed run
here as one batch: one denoise loop whose every step is ONE UNet call at
batch 2N (each video's uncond and cond rows), each video guided by its
own scale (``cfg_combine`` with a per-video scale, the pipeline's
``guidance_rescale`` per sample) from its own seed's noise (vdx's
``jax.random.normal(as_key(seed))``, through vdx_torch.core.rng), under
the pipeline's ``sampler_configs``. The group is then decoded in frame
chunks through the pipeline's VAE and left on its device
(:func:`generate_batch`); :func:`run_batched_experiments` writes the
reference's artifacts for it while the next batch runs.

PAB and skip mode keep per-request state the batch does not carry: the
batched runner raises under them, as vdx's does. Under ``context`` the
batch runs the UNet over the whole clip, as vdx's batched program does.

The data axis (vdx's inputs placed as ``P("data")``): with ``mesh=``,
each chunk of N experiments splits over the mesh's ``data`` axis, data
index d running experiments [d N/data, (d + 1) N/data) through the same
loop, and the latents or frames are all-gathered back in config order on
every rank. A chunk the axis does not divide raises ValueError (vdx's
``device_put`` fails). Every rank of the mesh calls the runner (SPMD, as
torchrun starts them). The mesh's first rank reads the resume markers
and sends every rank the list of experiments left to run, so all run the
same chunks whatever their own view of the files; it alone writes each
experiment's artifacts, once. A failure on that rank (reading the
markers, writing the files) is sent on and raised on every rank, so no
rank waits for it in the next collective.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import List, Sequence

import torch
import torch.distributed as dist

from vdx_torch.core import rng
from vdx_torch.harness.config import ExperimentConfig
from vdx_torch.harness.grid import save_experiment
from vdx_torch.parallel.mesh import Mesh, all_gather, axis_index
from vdx_torch.pipelines.base import _Request


def group_configs(configs: Sequence[ExperimentConfig]):
    keyf = lambda c: (c.num_inference_steps, c.num_frames, c.height, c.width)  # noqa: E731
    ordered = sorted(configs, key=keyf)
    return [(k, list(g)) for k, g in itertools.groupby(ordered, key=keyf)]


def batch_context(pipe, configs: Sequence[ExperimentConfig]) -> torch.Tensor:
    """N experiments' prompt pairs -> the batch's context [2N, 77, D],
    (uncond x N, cond x N), the order the loop's CFG split expects."""
    ctx = [pipe.encode_prompt(c.prompt, c.negative_prompt) for c in configs]
    return torch.cat([torch.stack([x[0] for x in ctx]),
                      torch.stack([x[1] for x in ctx])])


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a vdx_torch.parallel.mesh.Mesh (see "
                        f"make_mesh), got {type(mesh).__name__}")


def _data_slice(configs: Sequence[ExperimentConfig], mesh) -> list:
    """This rank's share of the chunk over the data axis."""
    n = mesh.shape["data"]
    if len(configs) % n:
        raise ValueError(f"a chunk of {len(configs)} experiments does not "
                         f"divide over the {n} ranks of the data axis")
    k = len(configs) // n
    with mesh.bind():
        d = axis_index("data")
    return list(configs[d * k:(d + 1) * k])


def _on_first_rank(mesh, fn):
    """``fn()`` -> its result on every rank: run in this process without a
    mesh, else on the first rank and broadcast. An exception there is
    raised on every rank (there as it is, elsewhere as a RuntimeError)."""
    if mesh is None:
        return fn()
    box, err = [None, None], None
    if dist.get_rank() == 0:
        try:
            box[0] = fn()
        except Exception as e:  # raised below, after the others heard of it
            err, box[1] = e, repr(e)
    dist.broadcast_object_list(box, src=0)
    if err is not None:
        raise err
    if box[1] is not None:
        raise RuntimeError(f"the mesh's first rank failed: {box[1]}")
    return box[0]


def _gather_data(x: torch.Tensor, mesh) -> torch.Tensor:
    with mesh.bind():
        return all_gather(x, "data", dim=0)


def denoise_batch(pipe, configs: Sequence[ExperimentConfig],
                  scheduler: str = "ddim", context=None,
                  mesh=None) -> torch.Tensor:
    """The denoise loop of N experiments of one group as one batch ->
    their final latents [N, F, h, w, C] on the pipeline's device.
    ``context``: :func:`batch_context` of ``configs``, when the caller
    encoded the prompts already (the server does, outside its device
    lock). ``mesh``: the batch splits over its data axis and the latents
    come back gathered (``context`` must then be None)."""
    _check_mesh(mesh)
    if mesh is not None:
        if context is not None:
            raise ValueError("denoise_batch over a mesh encodes its own "
                             "share of the prompts: pass context=None")
        return _gather_data(denoise_batch(pipe, _data_slice(configs, mesh),
                                          scheduler), mesh)
    if getattr(pipe, "pab", None) is not None or getattr(pipe, "skip", None) is not None:
        raise ValueError(
            "the batched runner runs its own denoise loop and does not "
            "implement the turbo modes — use a plain pipeline for "
            "batched grids/serving (pab/skip are per-pipeline features)")
    keys = {(c.num_inference_steps, c.num_frames, c.height, c.width)
            for c in configs}
    if len(keys) != 1:
        raise ValueError(f"a batch needs one (steps, frames, height, width); "
                         f"got {sorted(keys)} (group_configs splits them)")
    (steps, F, H, W), = keys
    ds = pipe.vae.config.downscale
    shape = (F, H // ds, W // ds, pipe.unet.config.in_channels)
    dev = pipe.device
    if context is None:
        context = batch_context(pipe, configs)
    scales = torch.tensor([c.guidance_scale for c in configs],
                          dtype=torch.float32, device=dev).view(-1, 1, 1, 1, 1)
    tables = pipe._get_tables(scheduler, steps)
    noise = rng.normal_batch([c.seed for c in configs], shape, dev)
    req = _Request(context, True, scales, scheduler, tables,
                   pipe._sampler_cfg(scheduler), steps)
    return pipe._denoise(req, noise * tables.init_noise_sigma).latents


def generate_batch(pipe, configs: Sequence[ExperimentConfig],
                   scheduler: str = "ddim", decode_chunk: int = 4,
                   mesh=None) -> torch.Tensor:
    """N experiments of one group -> uint8 frames [N, F, H, W, 3] on the
    pipeline's device, returned once the work is queued (no host sync).
    ``mesh``: each data index denoises and decodes its share, and the
    frames come back gathered."""
    _check_mesh(mesh)
    if mesh is not None:
        return _gather_data(generate_batch(pipe, _data_slice(configs, mesh),
                                           scheduler, decode_chunk), mesh)
    latents = denoise_batch(pipe, configs, scheduler)
    F = latents.shape[1]
    chunk = max(1, min(decode_chunk, F))
    while F % chunk:
        chunk -= 1
    return pipe._decode(latents, chunk)


def run_batched_experiments(
    pipe,
    configs: Sequence[ExperimentConfig],
    output_dir: Path,
    scheduler: str = "ddim",
    mesh=None,
    max_batch: int = 8,
    decode_chunk: int = 4,
    log=print,
) -> List[ExperimentConfig]:
    """Run experiments in batches of up to ``max_batch`` per group; the
    grid runner's artifacts and resume marker. Each batch's frames are
    written while the next batch runs on the card. ``mesh``: every chunk
    splits over the data axis (:func:`generate_batch`), every rank of the
    mesh calls this, and the mesh's first rank reads the resume markers
    (its list of what is left is every rank's) and writes the artifacts."""
    _check_mesh(mesh)
    output_dir = Path(output_dir)

    def left():
        output_dir.mkdir(parents=True, exist_ok=True)
        return [i for i, c in enumerate(configs)
                if not (output_dir / c.experiment_id / "config.json").exists()]

    todo_ids = set(_on_first_rank(mesh, left))
    todo = [c for i, c in enumerate(configs) if i in todo_ids]
    for i, c in enumerate(configs):
        if i not in todo_ids:
            log(f"  Skipping {c.experiment_id} (already exists)")

    def flush(frames, cfgs):
        def write():
            for arr, cfg in zip(frames.cpu().numpy(), cfgs):
                save_experiment(arr, cfg, output_dir)

        # every rank waits here until the files are on disk
        _on_first_rank(mesh, write)

    pending = None  # (device frames [N, F, H, W, 3], configs) to write
    for (steps, F, H, W), group in group_configs(todo):
        for start in range(0, len(group), max_batch):
            chunk_cfgs = group[start:start + max_batch]
            log(f"  Batch of {len(chunk_cfgs)} experiments @ steps={steps} "
                f"{H}x{W}x{F}")
            frames = generate_batch(pipe, chunk_cfgs, scheduler, decode_chunk,
                                    mesh=mesh)
            if pending is not None:
                flush(*pending)
            pending = (frames, chunk_cfgs)
    if pending is not None:
        flush(*pending)
    return list(configs)
