"""The port's grid study runners (vdx_torch.harness, vdx_torch.io) against
vdx's on the CPU: the plan, config.json's bytes, the artifacts and the
resume marker, the manifest, the measurement pass, and the batched runner.

The tiny port pipeline (fp32) runs the plan's experiments at 8 frames,
64x64, 2 DDIM steps. vdx's side compiles no pipeline: its writers read
the port's output tree, and its batched denoise program
(``_batched_denoise_fn``) is compiled once at XLA optimisation level 0 on
vdx weights carried over from the port's.

Tolerances:
  * plan, config.json, PNG and GIF bytes, manifest: identical;
  * the measurement JSON: test_torch_port_metrics' bar (1e-5 relative,
    spreads at 1e-5 of their mean or squared mean), keys in vdx's order;
  * batched latents against vdx's program after 2 steps: 2e-3 absolute,
    the slice test's bar for the port's own 2-step trajectory
    (tests/test_torch_port_pipeline.py: 1e-3 a step);
  * a batch's video against its single call on the CPU: identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_metrics import _ordered, _same_json
from vdx.core import convert as VC
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.core.rng import as_key
from vdx.harness import batched as JB
from vdx.harness import config as JCfg
from vdx.harness import grid as JG
from vdx.io import frames as JIO
from vdx.metrics.flow import OpticalFlowEstimator as JFlow
from vdx.metrics.lpips import LPIPSMetric as JLPIPSMetric
from vdx.metrics.lpips import load_torch_weights
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import VAEConfig as JVC
from vdx.pipelines import AnimateDiffPipeline as JPipe
from vdx_torch import harness as TH
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.harness import config as TCfg
from vdx_torch.io import frames as TIO
from vdx_torch.metrics.flow import OpticalFlowEstimator as TFlow
from vdx_torch.metrics.lpips import LPIPSMetric
from vdx_torch.models.clip_text import CLIPTextConfig as TCC
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.models.vae import VAEConfig as TVC
from vdx_torch.pipelines import AnimateDiffPipeline as TPipe
from vdx_torch.pipelines import PABConfig, SkipConfig
from vdx_torch.schedulers.ddim import DDIMConfig

SIZE = dict(num_frames=8, height=64, width=64, num_inference_steps=2)
BATCH_ATOL = 2e-3
QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tiny_port(**kw):
    return TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                 text_config=TCC.tiny(), policy=TP, scheduler="ddim",
                 device="cpu", **kw)


@pytest.fixture(scope="module")
def tiny():
    pipe = _tiny_port()
    pipe.init_params(0)
    return pipe


def _sibling(pipe, **kw):
    """Another port pipeline on ``pipe``'s modules (its own options)."""
    other = _tiny_port(**kw)
    other.unet, other.vae, other.text_encoder = pipe.unet, pipe.vae, pipe.text_encoder
    return other


class _AtTestSize:
    """The tiny pipeline running the plan's experiments at SIZE (their
    prompts, CFG and seeds as planned); counts its calls."""

    def __init__(self, pipe):
        self.pipe, self.calls = pipe, 0

    def __call__(self, **kw):
        self.calls += 1
        return self.pipe(**dict(kw, **SIZE))


def _asdicts(configs):
    return [dataclasses.asdict(c) for c in configs]


def _check_plan_and_configs(tmp_path):
    for name in ("SEED", "NUM_FRAMES", "HEIGHT", "WIDTH", "DEFAULT_CFG",
                 "DEFAULT_STEPS", "CFG_VALUES", "STEPS_VALUES", "TEST_VIDEOS"):
        assert getattr(TCfg, name) == getattr(JCfg, name), name
    filters = [None, "a", "_", "zzz", *JCfg.TEST_VIDEOS]
    for phase in ("all", "cfg", "steps", "prompt", "none"):
        for video_filter in filters:
            got = TH.plan_grid_search(phase, video_filter)
            want = JG.plan_grid_search(phase, video_filter)
            assert _asdicts(got) == _asdicts(want), (phase, video_filter)
    plan = TH.plan_grid_search()
    # 84 planned, 78 distinct: cfg 7.5 at 25 steps is in both sweeps
    assert len(plan) == 84 and len({c.experiment_id for c in plan}) == 78
    for c in plan:
        c.save(tmp_path / "t.json")
        JCfg.ExperimentConfig(**dataclasses.asdict(c)).save(tmp_path / "j.json")
        assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
        assert TCfg.ExperimentConfig.load(tmp_path / "t.json") == c
    # group_configs on a mixed plan (steps and sizes)
    mixed = [dataclasses.replace(c, num_frames=8 + 8 * (i % 2), height=64 * (1 + i % 3))
             for i, c in enumerate(plan[::3])]
    got = TH.group_configs(mixed)
    want = JB.group_configs([JCfg.ExperimentConfig(**dataclasses.asdict(c))
                             for c in mixed])
    assert [(k, _asdicts(g)) for k, g in got] == [(k, _asdicts(g)) for k, g in want]


def _check_frame_files(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 24, 32, 3), dtype=np.uint8)
    for name, mod in (("t", TIO), ("j", JIO)):
        mod.save_frames(frames, tmp_path / name / "frames")
        mod.export_to_gif(frames, tmp_path / name / "x.gif")
    for i in range(4):
        png = f"frames/frame_{i:04d}.png"
        want = (tmp_path / "j" / png).read_bytes()
        assert (tmp_path / "t" / png).read_bytes() == want
    assert (tmp_path / "t" / "x.gif").read_bytes() == (tmp_path / "j" / "x.gif").read_bytes()


def test_plan_config_and_files_match_vdx(tmp_path):
    _check_plan_and_configs(tmp_path)
    _check_frame_files(tmp_path)


def _check_grid_run(tiny, tmp_path):
    """Both save paths write the same tree; config.json is vdx's bytes; a
    re-run skips everything; a missing marker re-generates its one."""
    runs = {}
    for overlap in (True, False):
        out = tmp_path / f"grid_{overlap}"
        pipe = _AtTestSize(tiny)
        configs = TH.run_grid_search(pipe, phase="prompt", video_filter="corgi",
                                     output_dir=out, overlap_io=overlap, **QUIET)
        assert pipe.calls == 2 and len(configs) == 2
        runs[overlap] = (out, configs)
    (out, configs), (serial, _) = runs[True], runs[False]
    for c in configs:
        d = out / c.experiment_id
        assert sorted(p.name for p in d.iterdir()) == sorted(
            ["frames", f"{c.experiment_id}.gif", "config.json"])
        pngs = sorted((d / "frames").glob("*.png"))
        assert [p.name for p in pngs] == [f"frame_{i:04d}.png" for i in range(8)]
        for p in pngs:
            assert p.read_bytes() == (serial / c.experiment_id / "frames" / p.name).read_bytes()
        JCfg.ExperimentConfig(**dataclasses.asdict(c)).save(tmp_path / "j.json")
        assert (d / "config.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    lines = []
    pipe = _AtTestSize(tiny)
    TH.run_grid_search(pipe, phase="prompt", video_filter="corgi",
                       output_dir=out, log=lines.append)
    assert pipe.calls == 0 and len([m for m in lines if "Skipping" in m]) == 2
    (out / configs[1].experiment_id / "config.json").unlink()
    TH.run_grid_search(pipe, phase="prompt", video_filter="corgi",
                       output_dir=out, **QUIET)
    assert pipe.calls == 1
    assert TH.generate_manifest(out) == JG.generate_manifest(out)
    return out


def _check_measurement(out, tmp_path):
    """The port's measurement pass and vdx's over the port's tree, with
    the same LPIPS weights and the numpy flow."""
    metric = LPIPSMetric(seed=0, device="cpu")
    jmetric = JLPIPSMetric(params=load_torch_weights(
        {k: v.numpy() for k, v in metric.model.state_dict().items()}))
    got = TH.measure_experiments(out, tmp_path / "m_t", lpips_metric=metric,
                                 flow_estimator=TFlow("numpy"), device="cpu",
                                 **QUIET)
    JG.measure_experiments(out, tmp_path / "m_j", lpips_metric=jmetric,
                           flow_estimator=JFlow("numpy"), **QUIET)
    assert len(got) == 2 and all(m.num_frames == 8 for m in got)
    names = sorted(p.name for p in (tmp_path / "m_j").iterdir())
    assert sorted(p.name for p in (tmp_path / "m_t").iterdir()) == names
    assert "grid_search_results.json" in names and len(names) == 3
    for name in names:
        _same_json(_ordered(tmp_path / "m_t" / name),
                   _ordered(tmp_path / "m_j" / name), name)


def test_grid_search_artifacts_and_measurement_match_vdx(tiny, tmp_path):
    out = _check_grid_run(tiny, tmp_path)
    _check_measurement(out, tmp_path)


def _experiments():
    base = TH.plan_grid_search("cfg", "corgi_beach")
    return [dataclasses.replace(base[0], seed=42, **SIZE),
            dataclasses.replace(base[-1], seed=7,
                                prompt="a red panda eating bamboo", **SIZE)]


def _vdx_pipe(tiny):
    """vdx's pipeline on the port's weights (its rules), for its batched
    denoise program."""
    rule_sets = {"unet": VC.unet_motion_rules(JUC.tiny()),
                 "vae": VC.vae_rules(JVC.tiny()),
                 "text": VC.clip_text_rules(JCC.tiny())}
    modules = {"unet": tiny.unet, "vae": tiny.vae, "text": tiny.text_encoder}
    params = {}
    for name, rules in rule_sets.items():
        sd = {k: v.numpy() for k, v in modules[name].state_dict().items()}
        params[name] = VC.unflatten_params(
            {p: tr(sd[hf]) for p, (hf, tr) in rules.items() if hf in sd})
    return JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                 text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                 params=params)


def _single_latents(pipe, c):
    return pipe(c.prompt, negative_prompt=c.negative_prompt,
                guidance_scale=c.guidance_scale, seed=c.seed,
                output_type="latent", **SIZE).latents


def _check_against_serial(tiny, tmp_path):
    """Each video of the batch is its single call, under plain CFG and
    under the pipeline's guidance_rescale and sampler_configs; the batched
    runner writes the serial runner's files."""
    configs = _experiments()
    rescaled = _sibling(tiny, guidance_rescale=0.7, sampler_configs={
        "ddim": DDIMConfig(timestep_spacing="trailing")})
    for pipe in (tiny, rescaled):
        lat = TH.denoise_batch(pipe, configs, "ddim")
        assert tuple(lat.shape) == (2, 8, 8, 8, 4)
        for b, c in enumerate(configs):
            assert torch.equal(lat[b], _single_latents(pipe, c)[0])
    frames = TH.generate_batch(tiny, configs, "ddim", decode_chunk=4)
    assert frames.dtype == torch.uint8 and tuple(frames.shape) == (2, 8, 64, 64, 3)
    TH.run_batched_experiments(tiny, configs, tmp_path / "batched", **QUIET)
    for b, c in enumerate(configs):
        TH.save_experiment(TH.generate_video(tiny, c, output_type="np"), c,
                           tmp_path / "serial")
        for name in [f"frames/frame_{i:04d}.png" for i in range(8)] + [
                f"{c.experiment_id}.gif", "config.json"]:
            assert (tmp_path / "batched" / c.experiment_id / name).read_bytes() \
                == (tmp_path / "serial" / c.experiment_id / name).read_bytes(), name
    lines = []
    TH.run_batched_experiments(tiny, configs, tmp_path / "batched", log=lines.append)
    assert len([m for m in lines if "Skipping" in m]) == 2
    return configs


def _check_against_vdx(tiny, configs):
    jpipe = _vdx_pipe(tiny)
    shape = (1, 8, 8, 8, 4)
    denoise = JB._batched_denoise_fn(jpipe, 2, shape, "ddim")
    contexts = jnp.asarray(np.stack(
        [tiny.encode_prompt(c.prompt, c.negative_prompt).numpy() for c in configs]))
    args = (jpipe.params["unet"], jnp.stack([as_key(c.seed) for c in configs]),
            contexts, jnp.asarray([c.guidance_scale for c in configs], jnp.float32))
    run = denoise.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    want = np.asarray(run(*args))[:, 0]
    got = TH.denoise_batch(tiny, configs, "ddim").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BATCH_ATOL)


def _check_rejections(tiny, tmp_path):
    configs = _experiments()
    for pipe in (_sibling(tiny, pab=PABConfig()), _sibling(tiny, skip=SkipConfig())):
        with pytest.raises(ValueError, match="turbo modes"):
            TH.run_batched_experiments(pipe, configs, tmp_path / "x", **QUIET)
    # the data axis takes a Mesh (tests/test_torch_port_mesh_axes.py)
    with pytest.raises(TypeError, match="Mesh"):
        TH.run_batched_experiments(tiny, configs, tmp_path / "x", mesh=object(), **QUIET)
    with pytest.raises(ValueError, match="group_configs"):
        TH.denoise_batch(tiny, [configs[0], dataclasses.replace(
            configs[1], num_inference_steps=3)])


def test_batched_runner_matches_serial_and_vdx(tiny, tmp_path):
    configs = _check_against_serial(tiny, tmp_path)
    _check_against_vdx(tiny, configs)
    _check_rejections(tiny, tmp_path)
