"""The rest of the port's mesh on a spawned 4-rank ``gloo`` group on the CPU
in fp32 (tests/test_torch_port_parallel.py's ``spawn``: a file init in
tmp_path, one torch thread a rank, a 60 s group timeout, the ranks joined
within a limit): window-parallel context windows and the data axis.

1. Window parallelism on ``ContextConfig(4, 2)`` (vdx's tests/test_context.py
   CTX) over the frames axis of a 1x4x1 mesh:
   - ``make_windowed_apply(mesh=)`` on the tiny UNetMotion cut to one
     level (32 channels; every pipeline here uses it) at 10 frames
     (four windows, one a rank) and 8 frames (three windows and a
     zero-weight dummy) against the port's sequential
     ``make_windowed_apply`` bit for bit, on every rank, each rank
     evaluating one window, and against vdx's under ``shard_map`` on the
     first 4 devices of the 8-device CPU mesh (its program at XLA O0) at
     ATOL = 2e-5 (measured 2.5e-6);
   - AnimateDiff with ``frame_shards=4`` and the context at 10 frames,
     its latents bit for bit against the port's one-process context
     pipeline on the same weights and seed (vdx's exactness argument:
     no frame lies in more than two windows);
   - 3 frames falling through to the local denoiser (no window wrapper
     runs), decoded shard-local with the frame axis padded to 4 and
     trimmed (a frame a rank): the uint8 frames equal the one-process
     pipeline's at the decode chunk the sharding gives, one frame.
2. The data axis on a 4x1x1 mesh: four experiments' gathered latents
   (``denoise_batch(mesh=)``) against vdx's batched program with its
   inputs placed as ``P("data")`` on 4 devices (O0) at
   test_torch_port_harness's BATCH_ATOL, and bit for bit against the
   one-process runner at the ranks' batch (one experiment a call: the
   CPU's fp32 sums change with the UNet's batch, at ~1e-5);
   ``run_batched_experiments(mesh=)``'s artifacts byte for byte against
   that one-process run's; the first rank's resume markers decide for
   every rank (run again, it finds all four done where the other ranks
   see an empty folder: every rank skips all four and none writes), and
   a failure there (its output folder is a file) is raised on every
   rank, not left waiting in a collective; a chunk of 3 raises
   ValueError on every rank; and ``prefetch_to_device(sharding=)`` lays
   each batch out as DTensors of the global shape whose local parts are
   the rank's slices (batch over data, frames over frames on a 2x2x1
   mesh, the context over data).

The worker functions import no jax: the spawned ranks import this module.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_parallel import spawn

ATOL = 2e-5
BATCH_ATOL = 2e-3  # tests/test_torch_port_harness.py
N_RANKS = 4
CTX = (4, 2)
WINDOW_FRAMES = (10, 8)
GEN = dict(height=64, width=64, num_inference_steps=2, seed=7)
QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unet_cfg(pkg="port"):
    """The tiny UNetMotion cut to one level (32 channels): vdx's sharded
    programs compile in about a third of the four levels' time."""
    import dataclasses

    if pkg == "vdx":
        from vdx.models.unet_motion import UNetMotionConfig as C
    else:
        from vdx_torch.models.unet_motion import UNetMotionConfig as C
    return dataclasses.replace(C.tiny(), block_out_channels=(32,),
                               down_block_has_attn=(True,))


def _pipe_kwargs(**extra):
    from vdx_torch.core.dtypes import FP32_POLICY as P
    from vdx_torch.models.clip_text import CLIPTextConfig
    from vdx_torch.models.vae import VAEConfig

    return dict(unet_config=_unet_cfg(), vae_config=VAEConfig.tiny(),
                text_config=CLIPTextConfig.tiny(), policy=P, scheduler="ddim",
                device="cpu", **extra)


def _window_inputs(F):
    """A CFG batch of 2 at F frames of 8x8 latents, its timestep and text."""
    rng = np.random.default_rng(F)
    return (rng.standard_normal((2, F, 8, 8, 4)).astype(np.float32),
            np.float32([500.0, 500.0]),
            rng.standard_normal((2, 7, 64)).astype(np.float32))


def _unet():
    from vdx_torch.core.dtypes import FP32_POLICY as P
    from vdx_torch.models.unet_motion import UNetMotion

    return UNetMotion(_unet_cfg(), P).eval()


def _windowed(model, F, mesh=None):
    """The port's windowed apply of ``model`` at F frames: sequential, or
    window-parallel over ``mesh``'s frames axis."""
    from vdx_torch.pipelines.context import ContextConfig, make_windowed_apply

    return make_windowed_apply(model, total_frames=F, out_channels=4,
                               cfg=ContextConfig(*CTX), mesh=mesh)


def _window_worker(rank, tmp):
    from vdx_torch.parallel.mesh import make_mesh
    from vdx_torch.pipelines import AnimateDiffPipeline, ContextConfig
    from vdx_torch.pipelines import context as C

    mesh = make_mesh(1, N_RANKS, 1)
    model = _unet()
    model.load_state_dict(torch.load(f"{tmp}/unet.pt"))
    out = {}
    for F in WINDOW_FRAMES:
        x, t, c = map(torch.from_numpy, _window_inputs(F))
        C.window_evals.update(sequential=0, sharded=0)
        with torch.no_grad():
            out[f"apply/{F}"] = _windowed(model, F, mesh)(x, t, c).numpy()
        assert C.window_evals == {"sequential": 0, "sharded": 1}, (F, C.window_evals)
    pipe = AnimateDiffPipeline.with_random_params(seed=0, **_pipe_kwargs(
        frame_shards=N_RANKS, context=ContextConfig(*CTX)))
    out["pipe/10"] = pipe("a fox", num_frames=10, output_type="latent",
                          **GEN).latents.numpy()
    C.window_evals.update(sequential=0, sharded=0)
    out["pipe/3"] = pipe("a fox", num_frames=3, output_type="np", **GEN).frames[0]
    assert C.window_evals == {"sequential": 0, "sharded": 0}, C.window_evals
    np.savez(f"{tmp}/window_{rank}.npz", **out)


def _vdx_windowed(params, F):
    import jax.numpy as jnp

    from test_torch_port_models import _compile_o0
    from vdx.core.dtypes import FP32_POLICY as JP
    from vdx.models.unet_motion import UNetMotion
    from vdx.parallel.mesh import make_mesh
    from vdx.pipelines.context import ContextConfig, make_windowed_apply_sharded

    jm = UNetMotion(_unet_cfg("vdx"), policy=JP)
    apply = make_windowed_apply_sharded(
        jm.apply, total_frames=F, out_channels=4, cfg=ContextConfig(*CTX),
        mesh=make_mesh(1, N_RANKS, 1))
    args = (params, *map(jnp.asarray, _window_inputs(F)))
    return np.asarray(_compile_o0(apply, *args)(*args))


def test_window_parallel_matches_vdx_and_sequential(tmp_path):
    from test_torch_port_modelscope import whole_pair

    from vdx_torch.core import convert as TC
    from vdx_torch.pipelines import AnimateDiffPipeline, ContextConfig

    model = _unet()
    params = whole_pair(model, "unet", _unet_cfg("vdx"), TC.rules_for(model), 31)
    torch.save(model.state_dict(), tmp_path / "unet.pt")
    wait = spawn(_window_worker, tmp_path, str(tmp_path))
    # while the ranks run: vdx's window-parallel apply, the port's
    # sequential one and the port's one-process context pipeline
    vdx = {F: _vdx_windowed(params, F) for F in WINDOW_FRAMES}
    with torch.no_grad():
        seq = {F: _windowed(model, F)(*map(torch.from_numpy, _window_inputs(F))).numpy()
               for F in WINDOW_FRAMES}
    pipe = AnimateDiffPipeline.with_random_params(seed=0, **_pipe_kwargs(
        context=ContextConfig(*CTX)))
    local = {"pipe/10": pipe("a fox", num_frames=10, output_type="latent",
                             **GEN).latents.numpy(),
             "pipe/3": pipe("a fox", num_frames=3, output_type="np", decode_chunk=1,
                            **GEN).frames[0]}
    wait()
    for rank in range(N_RANKS):
        got = np.load(tmp_path / f"window_{rank}.npz")
        for F in WINDOW_FRAMES:
            g = got[f"apply/{F}"]
            assert np.array_equal(g, seq[F]), (rank, F)
            err = float(np.max(np.abs(g - vdx[F])))
            assert err <= ATOL, (rank, F, err)
        assert np.array_equal(got["pipe/10"], local["pipe/10"]), rank
        assert got["pipe/3"].shape == (3, 64, 64, 3) and local["pipe/3"].std() > 0
        assert np.array_equal(got["pipe/3"], local["pipe/3"]), rank


# ----------------------------------------------------------------------
# the data axis
# ----------------------------------------------------------------------
def _configs():
    """Four experiments of one group (8 frames, 64x64, 2 DDIM steps)."""
    import dataclasses

    from vdx_torch import harness as TH

    plan = TH.plan_grid_search("cfg", "corgi_beach")
    size = dict(num_frames=8, height=64, width=64, num_inference_steps=2)
    prompts = (None, "a red panda eating bamboo", None, "a fox in the snow")
    return [dataclasses.replace(plan[i % len(plan)], seed=7 + 5 * i, **size,
                                **({} if p is None else {"prompt": p}))
            for i, p in enumerate(prompts)]


def _tiny_pipe():
    from vdx_torch.pipelines import AnimateDiffPipeline

    pipe = AnimateDiffPipeline(**_pipe_kwargs())
    pipe.init_params(0)
    return pipe


def _batches():
    rng = np.random.default_rng(3)
    return [{"latents": rng.standard_normal((4, 6, 2, 2, 4)).astype(np.float32),
             "context": rng.standard_normal((4, 3, 8)).astype(np.float32)}
            for _ in range(2)]


def _check_prefetch(mesh):
    """Every batch as DTensors of the global shape, the local parts this
    rank's slices."""
    from torch.distributed.tensor import DTensor

    from vdx_torch.data.loader import prefetch_to_device
    from vdx_torch.parallel.mesh import axis_index, batch_sharding, video_sharding

    sharding = {"latents": video_sharding(mesh), "context": batch_sharding(mesh)}
    want = _batches()
    got = list(prefetch_to_device(iter(want), sharding=sharding))
    nd, nf = mesh.shape["data"], mesh.shape["frames"]
    with mesh.bind():
        d, f = axis_index("data"), axis_index("frames")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("latents", "context"):
            assert isinstance(g[k], DTensor) and tuple(g[k].shape) == w[k].shape, k
        b, fl = 4 // nd, 6 // nf
        lat = w["latents"][d * b:(d + 1) * b, f * fl:(f + 1) * fl]
        assert np.array_equal(g["latents"].to_local().numpy(), lat)
        assert np.array_equal(g["context"].to_local().numpy(),
                              w["context"][d * b:(d + 1) * b])
        assert np.array_equal(g["latents"].full_tensor().numpy(), w["latents"])


def _data_worker(rank, tmp):
    from vdx_torch import harness as TH
    from vdx_torch.parallel.mesh import make_mesh

    mesh = make_mesh(N_RANKS, 1, 1)
    pipe, configs = _tiny_pipe(), _configs()
    lat = TH.denoise_batch(pipe, configs, "ddim", mesh=mesh)
    TH.run_batched_experiments(pipe, configs, f"{tmp}/mesh", mesh=mesh,
                               max_batch=4, **QUIET)
    # the first rank's resume markers are every rank's: it sees the four
    # experiments done, the other ranks an empty folder of their own
    own, seen = Path(f"{tmp}/mesh" if rank == 0 else f"{tmp}/elsewhere_{rank}"), []
    TH.run_batched_experiments(pipe, configs, own, mesh=mesh, max_batch=4,
                               log=seen.append)
    assert seen == [f"  Skipping {c.experiment_id} (already exists)"
                    for c in configs], (rank, seen)
    assert rank == 0 or not own.exists(), rank
    # a failure on the first rank (its output folder is a file) is raised
    # on every rank
    blocker = Path(f"{tmp}/blocker")
    if rank == 0:
        blocker.write_text("")
    with pytest.raises(FileExistsError if rank == 0 else RuntimeError):
        TH.run_batched_experiments(pipe, configs, blocker if rank == 0 else own,
                                   mesh=mesh, max_batch=4, **QUIET)
    with pytest.raises(ValueError, match="does not divide"):
        TH.generate_batch(pipe, configs[:3], "ddim", mesh=mesh)
    _check_prefetch(make_mesh(2, 2, 1))
    np.save(f"{tmp}/latents_{rank}.npy", lat.numpy())


def _vdx_batched(pipe, configs):
    """vdx's batched denoise program on the port's weights with its
    inputs placed as P("data") over 4 devices (O0) -> latents [N, ...]."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vdx.core import convert as VC
    from vdx.core.dtypes import FP32_POLICY as JP
    from vdx.core.rng import as_key
    from vdx.harness import batched as JB
    from vdx.models.clip_text import CLIPTextConfig
    from vdx.models.vae import VAEConfig
    from vdx.parallel.mesh import make_mesh
    from vdx.pipelines import AnimateDiffPipeline

    # vdx's pipeline on the port's weights (the port's rules), as
    # tests/test_torch_port_harness.py's _vdx_pipe
    rules = pipe._conversion_rules()
    params = {}
    for name, m in pipe._components().items():
        sd = {k: v.numpy() for k, v in m.state_dict().items()}
        params[name] = VC.unflatten_params(
            {p: tr(sd[hf]) for p, (hf, tr) in rules[name][0].items() if hf in sd})
    jpipe = AnimateDiffPipeline(
        unet_config=_unet_cfg("vdx"), vae_config=VAEConfig.tiny(),
        text_config=CLIPTextConfig.tiny(), policy=JP, scheduler="ddim",
        params=params)
    denoise = JB._batched_denoise_fn(jpipe, 2, (1, 8, 8, 8, 4), "ddim")
    sh = NamedSharding(make_mesh(N_RANKS, 1, 1), P("data"))
    contexts = jnp.asarray(np.stack(
        [pipe.encode_prompt(c.prompt, c.negative_prompt).numpy() for c in configs]))
    keys = jnp.stack([as_key(c.seed) for c in configs])
    scales = jnp.asarray([c.guidance_scale for c in configs], jnp.float32)
    args = (jpipe.params["unet"],
            *(jax.device_put(a, sh) for a in (keys, contexts, scales)))
    run = denoise.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return np.asarray(run(*args))[:, 0]


def test_data_axis_matches_vdx_and_one_process(tmp_path):
    from vdx_torch import harness as TH

    wait = spawn(_data_worker, tmp_path, str(tmp_path))
    pipe, configs = _tiny_pipe(), _configs()
    want = _vdx_batched(pipe, configs)
    # the one-process run at the ranks' batch, one experiment a call (the
    # CPU's fp32 sums change with the UNet's batch, at ~1e-5)
    one = np.concatenate([TH.denoise_batch(pipe, [c], "ddim").numpy()
                          for c in configs])
    TH.run_batched_experiments(pipe, configs, tmp_path / "one", max_batch=1, **QUIET)
    wait()
    for rank in range(N_RANKS):
        got = np.load(tmp_path / f"latents_{rank}.npy")
        assert got.shape == (4, 8, 8, 8, 4) and np.array_equal(got, one), rank
        np.testing.assert_allclose(got, want, rtol=0, atol=BATCH_ATOL)
    files = sorted(p.relative_to(tmp_path / "one")
                   for p in (tmp_path / "one").rglob("*") if p.is_file())
    assert len(files) == 4 * 10  # 8 PNGs, the GIF and config.json each
    assert files == sorted(p.relative_to(tmp_path / "mesh")
                           for p in (tmp_path / "mesh").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "mesh" / f).read_bytes() == (tmp_path / "one" / f).read_bytes(), f
