"""Frame-sharded denoisers and pipelines of the port, on a spawned 4-rank
``gloo`` group on the CPU in fp32 (tests/test_torch_port_parallel.py's
``spawn``: a file init in tmp_path, one torch thread a rank, a 60 s group
timeout, the ranks joined within a limit).

* The sharded apply (parallel/frame_parallel.py) of UNetMotion, the SVD
  UNet, UNet3D and Latte at the tiny configs at 8x8, for ``seq_impl``
  "ulysses" and "ring", each against vdx's LOCAL apply on the same
  weights and the real frames, at vdx's own bar for its sharded apply,
  2e-4 (tests/test_frame_parallel.py): 6 frames over the frames axis of
  a 2x2x1 mesh (3 a rank, each data replica on its own pair of ranks),
  6 frames over 4 ranks (ragged: padded to 8, the last shard holds only
  padding) and, for Latte, 5 frames over 4 ranks (a shard of one real
  frame and one pad; the pipelines below take that case through the
  UNets). The pad slots hold garbage of magnitude 50 and
  ``frames_valid`` is the real count. The tiny Latte's temporal blocks
  take the Ulysses swap; the UNets' 1x1 level (one position at one
  video) falls back to the ring.
* The pipeline surface: AnimateDiff with ``frame_shards=4`` at 5 frames,
  SVD at 6 frames (``decode_chunk=2``, and ``decode_chunk=4``, which the
  sharding cuts to the shard's 2 frames), and AnimateDiff under PAB at 5
  frames, each against vdx's pipeline with ``frame_shards=4`` on the same
  weights and seed (its programs compiled at XLA optimisation level 0),
  and, but for the changed decode chunk, against the port's local
  pipeline, at one uint8 level; ``dispatch_steps`` under the mesh and a
  mesh larger than the group raise.
* The rejections without a process group: ``frame_shards`` raises, an
  unknown ``seq_impl`` raises ValueError, CogVideoX keeps vdx's
  ValueError, and context windows with ``frame_shards`` (window
  parallelism, tests/test_torch_port_mesh_axes.py) raise the same
  RuntimeError, for the mesh they build.

The worker functions import no jax: the spawned ranks import this module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_port_parallel import spawn

# vdx's bar for its own sharded apply against its local one
# (tests/test_frame_parallel.py:40-41); measured 1e-6 - 5e-6 here
ATOL = 2e-4
N_RANKS = 4
SEQ_IMPLS = ("ulysses", "ring")
HW = 8
# (model, real frames, mesh): "2x2" shards the frames over 2 ranks of a
# 2x2x1 mesh, "1x4" over all 4 (ragged where 4 does not divide)
CASES = [(k, 6, m) for k in ("motion", "svd", "unet3d", "latte")
         for m in ("2x2", "1x4")] + [("latte", 5, "1x4")]
MESHES = {"2x2": (2, 2, 1), "1x4": (1, 4, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_model(kind):
    """The port denoiser of ``kind`` at the tiny config, fp32, on the CPU,
    and its input channels."""
    from vdx_torch.core.dtypes import FP32_POLICY as P

    if kind == "motion":
        from vdx_torch.models.unet_motion import UNetMotion, UNetMotionConfig
        return UNetMotion(UNetMotionConfig.tiny(), P), 4
    if kind == "svd":
        from vdx_torch.models.svd_unet import SVDUNetConfig, UNetSpatioTemporal
        return UNetSpatioTemporal(SVDUNetConfig.tiny(), P), 8
    if kind == "unet3d":
        from vdx_torch.models.unet3d import UNet3D, UNet3DConfig
        return UNet3D(UNet3DConfig.tiny(), P), 4
    from vdx_torch.models.dit import LatteConfig, LatteDiT
    return LatteDiT(LatteConfig.tiny(), P), 4


def _inputs(kind, F, shards):
    """Seeded numpy inputs: the sample at F rounded up to the shards
    (garbage in the pad slots), the timestep and the conditioning."""
    rng = np.random.default_rng(F)
    cin = 8 if kind == "svd" else 4
    x = rng.standard_normal((1, F, HW, HW, cin)).astype(np.float32)
    garbage = 50 * np.random.default_rng(9).standard_normal(
        (1, (-F) % shards, HW, HW, cin)).astype(np.float32)
    x = np.concatenate([x, garbage], axis=1)
    if kind == "svd":
        cond = (rng.standard_normal((1, 1, 64)).astype(np.float32),
                np.float32([[6.0, 127.0, 0.02]]))
        t = np.float32([0.5])
    else:
        cond = (rng.standard_normal((1, 7, 64)).astype(np.float32),)
        t = np.float32([500.0])
    return x, t, cond


def _denoiser_worker(rank, tmp):
    from vdx_torch.parallel.frame_parallel import make_frame_sharded_denoiser
    from vdx_torch.parallel.mesh import make_mesh

    meshes = {name: make_mesh(*shape) for name, shape in MESHES.items()}
    models, out = {}, {}
    for kind, F, mname in CASES:
        if kind not in models:
            models[kind], _ = _port_model(kind)
            models[kind].load_state_dict(torch.load(f"{tmp}/{kind}.pt"))
            models[kind].eval()
        model, mesh = models[kind], meshes[mname]
        x, t, cond = _inputs(kind, F, mesh.shape["frames"])
        for seq in SEQ_IMPLS:
            apply = make_frame_sharded_denoiser(
                mesh, n_conditioning=len(cond), seq_impl=seq)
            with torch.no_grad():
                got = apply(model, torch.from_numpy(x), torch.from_numpy(t),
                            *map(torch.from_numpy, cond),
                            frames_valid=F if x.shape[1] != F else None)
            out[f"{kind}/{F}/{mname}/{seq}"] = got.numpy()
    if rank == 0:
        np.savez(f"{tmp}/denoisers.npz", **out)


def _vdx_local(kind, params, F):
    import jax.numpy as jnp

    from test_torch_port_models import _compile_o0
    from vdx.core.dtypes import FP32_POLICY as JP

    if kind == "motion":
        from vdx.models.unet_motion import UNetMotion as J, UNetMotionConfig as JC
    elif kind == "svd":
        from vdx.models.svd_unet import SVDUNetConfig as JC, UNetSpatioTemporal as J
    elif kind == "unet3d":
        from vdx.models.unet3d import UNet3D as J, UNet3DConfig as JC
    else:
        from vdx.models.dit import LatteConfig as JC, LatteDiT as J
    x, t, cond = _inputs(kind, F, 1)
    args = (params, jnp.asarray(x), jnp.asarray(t),
            *map(jnp.asarray, cond))
    jm = J(JC.tiny(), policy=JP)
    return np.asarray(_compile_o0(jm.apply, *args)(*args))


def test_sharded_denoisers_match_vdx_local(tmp_path):
    from test_torch_port_modelscope import whole_pair
    from vdx.models.dit import LatteConfig
    from vdx.models.svd_unet import SVDUNetConfig
    from vdx.models.unet3d import UNet3DConfig
    from vdx.models.unet_motion import UNetMotionConfig

    from vdx_torch.core import convert as TC

    # the port's copy of vdx's rules (Latte's names the port's per-block
    # adaLN, ROADMAP F14)
    jcfgs = {"motion": (UNetMotionConfig.tiny(), TC.unet_motion_rules),
             "svd": (SVDUNetConfig.tiny(), TC.svd_unet_rules),
             "unet3d": (UNet3DConfig.tiny(), TC.unet3d_rules),
             "latte": (LatteConfig.tiny(), TC.latte_dit_rules)}
    params = {}
    for i, (kind, (jcfg, rules)) in enumerate(jcfgs.items()):
        model, _ = _port_model(kind)
        params[kind] = whole_pair(model, "unet", jcfg, rules(jcfg), 20 + i)
        torch.save(model.state_dict(), tmp_path / f"{kind}.pt")
    wait = spawn(_denoiser_worker, tmp_path, str(tmp_path))
    want = {(k, F): _vdx_local(k, params[k], F)  # while the ranks run
            for k, F in sorted({(k, F) for k, F, _ in CASES})}
    wait()
    got = np.load(tmp_path / "denoisers.npz")
    for kind, F, mname in CASES:
        for seq in SEQ_IMPLS:
            g = got[f"{kind}/{F}/{mname}/{seq}"]
            assert np.all(np.isfinite(g)), (kind, F, mname, seq)
            err = float(np.max(np.abs(g[:, :F] - want[kind, F])))
            assert err <= ATOL, (kind, F, mname, seq, err)


# ----------------------------------------------------------------------
# the pipeline surface
# ----------------------------------------------------------------------
def _pipe_kwargs(family, **extra):
    from vdx_torch.core.dtypes import FP32_POLICY as P
    from vdx_torch.models.vae import VAEConfig

    kw = dict(vae_config=VAEConfig.tiny(), policy=P, device="cpu", **extra)
    if family == "svd":
        from vdx_torch.models.clip_vision import CLIPVisionConfig
        from vdx_torch.models.svd_unet import SVDUNetConfig
        return dict(unet_config=SVDUNetConfig.tiny(),
                    vision_config=CLIPVisionConfig.tiny(), **kw)
    from vdx_torch.models.clip_text import CLIPTextConfig
    from vdx_torch.models.unet_motion import UNetMotionConfig
    return dict(unet_config=UNetMotionConfig.tiny(),
                text_config=CLIPTextConfig.tiny(), **kw)


def _pab():
    from vdx_torch.pipelines import PABConfig

    return PABConfig(spatial_interval=2, temporal_interval=2, cross_interval=2,
                     warmup_steps=1, cooldown_steps=1)


# two steps; three under PAB, whose middle step is served from the cache
GEN = dict(num_frames=5, height=64, width=64, num_inference_steps=2, seed=7,
           output_type="np")
SVD_GEN = dict(num_frames=6, height=64, width=64, num_inference_steps=2,
               seed=3, decode_chunk=2, output_type="np")
# the SVD temporal decoder's chunk of 4 frames: 6 frames over 4 shards hold
# 2 a shard, so the sharded decode takes chunks of 2, the local one 4 + 2
SVD_GEN_CHUNK4 = dict(SVD_GEN, decode_chunk=4)


def _svd_image():
    return np.random.default_rng(7).random((64, 64, 3)).astype(np.float32)


def _run_pipelines(shards):
    """-> ({case: frames}, {family: pipeline}) of the pipeline cases at
    ``shards`` ("svd_chunk4" only sharded: its local decode differs)."""
    from vdx_torch.pipelines import AnimateDiffPipeline, SVDImg2VidPipeline

    fs = {} if shards == 1 else {"frame_shards": shards}
    ad = AnimateDiffPipeline.with_random_params(seed=0, **_pipe_kwargs("ad", **fs))
    pab = AnimateDiffPipeline.with_random_params(
        seed=0, **_pipe_kwargs("ad", pab=_pab(), **fs))
    svd = SVDImg2VidPipeline.with_random_params(seed=0, **_pipe_kwargs("svd", **fs))
    out = {"animatediff": ad("portrait", **GEN).frames[0],
           "pab": pab("portrait", **{**GEN, "num_inference_steps": 3}).frames[0],
           "svd": svd(_svd_image(), **SVD_GEN).frames[0]}
    if shards > 1:
        out["svd_chunk4"] = svd(_svd_image(), **SVD_GEN_CHUNK4).frames[0]
    return out, {"ad": ad, "svd": svd}


def _pipeline_worker(rank, tmp):
    from vdx_torch.pipelines import AnimateDiffPipeline

    out, pipes = _run_pipelines(N_RANKS)
    with pytest.raises(ValueError, match="single-chip"):
        pipes["ad"]("portrait", dispatch_steps=1, **GEN)
    with pytest.raises(ValueError, match="world_size == 8"):
        AnimateDiffPipeline(**_pipe_kwargs("ad", frame_shards=8))
    if rank == 0:
        np.savez(f"{tmp}/pipelines.npz", **out)


def _compile_at_o0(jpipe):
    """vdx's pipeline with its programs compiled at XLA optimisation level
    0 (tests/test_torch_port_pipeline.py's slice_run does so by hand)."""
    get = jpipe._get_program

    def get_program(**kw):
        prog, done = get(**kw), {}

        def run(*args):
            if "exe" not in done:
                done["exe"] = prog.lower(*args).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
            return done["exe"](*args)

        return run

    jpipe._get_program = get_program
    return jpipe


def _vdx_sharded_pipelines(pipes):
    """The cases through vdx's pipelines with ``frame_shards=4`` (the first
    4 devices of the 8-device CPU mesh), on the weights of the port's
    local pipelines carried into vdx's trees by the port's copy of vdx's
    rules. -> {case: frames}"""
    from test_torch_port_modelscope import vdx_tree
    from vdx.core.dtypes import FP32_POLICY as JP
    from vdx.models.clip_text import CLIPTextConfig
    from vdx.models.clip_vision import CLIPVisionConfig
    from vdx.models.svd_unet import SVDUNetConfig
    from vdx.models.unet_motion import UNetMotionConfig
    from vdx.models.vae import VAEConfig
    from vdx.pipelines import (AnimateDiffPipeline, PABConfig,
                               SVDImg2VidPipeline)

    def params(pipe):
        rules = pipe._conversion_rules()
        return {name: vdx_tree({k: v.numpy() for k, v in m.state_dict().items()},
                               rules[name][0])
                for name, m in pipe._components().items()}

    common = dict(vae_config=VAEConfig.tiny(), policy=JP, frame_shards=N_RANKS)
    ad_kw = dict(unet_config=UNetMotionConfig.tiny(),
                 text_config=CLIPTextConfig.tiny(),
                 params=params(pipes["ad"]), **common)
    ad = _compile_at_o0(AnimateDiffPipeline(**ad_kw))
    jpab = _compile_at_o0(AnimateDiffPipeline(
        pab=PABConfig(**dataclasses.asdict(_pab())), **ad_kw))
    svd = _compile_at_o0(SVDImg2VidPipeline(
        unet_config=SVDUNetConfig.tiny(), vision_config=CLIPVisionConfig.tiny(),
        params=params(pipes["svd"]), **common))
    return {"animatediff": ad("portrait", **GEN).frames[0],
            "pab": jpab("portrait", **{**GEN, "num_inference_steps": 3}).frames[0],
            "svd": svd(_svd_image(), **SVD_GEN).frames[0],
            "svd_chunk4": svd(_svd_image(), **SVD_GEN_CHUNK4).frames[0]}


def test_sharded_pipelines_match_local(tmp_path):
    """The port's frame-sharded pipelines against vdx's frame-sharded ones
    on the same weights and seed, and, where the two must agree, against
    the port's local pipelines, at one uint8 level."""
    wait = spawn(_pipeline_worker, tmp_path, str(tmp_path))
    local, pipes = _run_pipelines(1)  # while the ranks run
    vdx_sharded = _vdx_sharded_pipelines(pipes)
    wait()
    got = np.load(tmp_path / "pipelines.npz")
    assert sorted(got.files) == sorted(vdx_sharded)
    for against, wants in (("vdx frame_shards=4", vdx_sharded),
                           ("the port's local pipeline", local)):
        for case, w in wants.items():
            g = got[case]
            assert g.shape == w.shape and g.dtype == np.uint8, (against, case)
            diff = int(np.max(np.abs(g.astype(np.int32) - w.astype(np.int32))))
            assert diff <= 1 and w.std() > 0, (against, case, diff)


def test_frame_shards_rejections():
    from vdx_torch.models.cogvideox import CausalVAEConfig, CogVideoXConfig
    from vdx_torch.models.t5 import T5Config
    from vdx_torch.parallel.frame_parallel import make_frame_sharded_unet
    from vdx_torch.pipelines import (AnimateDiffPipeline, CogVideoXPipeline,
                                     ContextConfig)

    with pytest.raises(RuntimeError, match="process group"):
        AnimateDiffPipeline(**_pipe_kwargs("ad", frame_shards=4))
    with pytest.raises(ValueError, match="unknown seq_impl"):
        AnimateDiffPipeline(**_pipe_kwargs("ad", frame_shards=4, seq_impl="tree"))
    with pytest.raises(ValueError, match="unknown seq_impl"):
        make_frame_sharded_unet(None, seq_impl="tree")
    with pytest.raises(ValueError, match="frame-sharded"):
        CogVideoXPipeline(CogVideoXConfig.tiny(), CausalVAEConfig.tiny(),
                          t5_config=T5Config.tiny(), device="cpu",
                          frame_shards=2)
    # window parallelism builds its mesh, which needs the process group
    with pytest.raises(RuntimeError, match="process group"):
        AnimateDiffPipeline(**_pipe_kwargs(
            "ad", frame_shards=2, context=ContextConfig(frames=8, stride=4)))
