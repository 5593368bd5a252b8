"""The port's AnimateDiff slice against vdx's, end to end on the CPU (fp32,
tiny configs), plus the DDIM scheduler, the CFG combine, the sampler-
generic denoise loop and the pipeline's surface.

vdx's AnimateDiffPipeline compiles two programs (the only vdx pipeline
compiles in the port's tests), each at XLA optimisation level 0 (vdx's
own O0 and default builds differ by up to 8e-5 in these latents and one
uint8 level in the frames): 8 frames at 64x64, 2 DDIM steps, CFG 7.5;
and the pipeline's default sampler, Euler, at a non-square 64x128, 2
steps, CFG 7.5.
The port gets the same weights through
vdx_torch.core.convert.params_from_jax and the vdx program's initial noise (jax.random.normal(as_key(seed), latent_shape),
as vdx's ``_noise_maker`` draws it).

Per-step latents: vdx's compiled program takes its scheduler tables as
runtime arguments, so running it again with step 1 turned into the
identity update (DDIM: alpha_prod_prev = alpha_prod_t; Euler: the next
sigma equal to the current one) returns the latents after step 0 from
the same executable.

Tolerances: one UNet call agrees to ~2e-5 (test_torch_port_models); the
CFG combine u + 7.5 (c - u) scales an eps difference by up to 16, and the
DDIM step by up to sqrt(1 - a) / sqrt(a) + 1 < 3 at these timesteps, so
latents after a step agree to 16 * 3 * 2e-5 ~= 1e-3 (atol, on O(1)
latents). Frames: within one uint8 level.

Euler's first step feeds the UNet t = 999.0, where each side's fp32
timestep embedding sits up to ~5e-5 off the float64 one and the tiny UNet
outputs differ by up to ~1e-4 (ROADMAP Queue 3). The Euler update
x + eps (sigma' - sigma) moves that by the CFG factor (up to 16) times
|sigma' - sigma| (at most the initial sigma, 14.6): 1e-4 * 16 * 14.6
~= 2.5e-2 (atol; these random weights give latents up to ~100).

The multistep samplers are held in the port's loop against a loop
composed here from vdx's sampler functions, fed the port UNet's outputs
(no vdx program per sampler): the carry must thread the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdx.core import convert as VC
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.core.rng import as_key
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import VAEConfig as JVC
from vdx.pipelines import AnimateDiffPipeline as JPipe
from vdx_torch.core.convert import params_from_jax
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.models.clip_text import CLIPTextConfig as TCC
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.models.vae import VAEConfig as TVC
from vdx_torch.pipelines import AnimateDiffPipeline as TPipe
from vdx_torch.pipelines import ContextConfig, PABConfig
from vdx_torch.pipelines.base import _Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

PROMPT = "a corgi walking on the beach, sunset lighting, high quality"
NEG = "bad quality, blurry, distorted"
SEED = 1234
LATENT_SHAPE = (1, 8, 8, 8, 4)
EULER_SHAPE = (1, 8, 8, 16, 4)  # 64x128 pixels
STEP_ATOL = 1e-3
EULER_STEP_ATOL = 2.5e-2


def _tiny_port(**kw):
    return TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                 text_config=TCC.tiny(), policy=TP, scheduler="ddim",
                 device="cpu", **kw)


@pytest.fixture(scope="module")
def slice_run():
    """Port weights from its own random init, carried into vdx's trees by
    vdx's rules, run through vdx's pipeline once; the port loads them back
    through params_from_jax."""
    seed_pipe = _tiny_port()
    seed_pipe.init_params(0)
    rule_sets = {"unet": VC.unet_motion_rules(JUC.tiny()),
                 "vae": VC.vae_rules(JVC.tiny()),
                 "text": VC.clip_text_rules(JCC.tiny())}
    modules = {"unet": seed_pipe.unet, "vae": seed_pipe.vae,
               "text": seed_pipe.text_encoder}
    params = {}
    for name, rules in rule_sets.items():
        sd = {k: v.numpy() for k, v in modules[name].state_dict().items()}
        params[name] = VC.unflatten_params(
            {p: tr(sd[hf]) for p, (hf, tr) in rules.items() if hf in sd})
    jpipe = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                  text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                  params=params)
    # vdx's __call__, stage by stage (encode_prompt -> _run_generate's
    # program -> _postprocess), with the program compiled at XLA
    # optimisation level 0: 18 s on one core against 35 s at the default.
    cond = jpipe.encode_prompt(PROMPT, NEG)
    prog = jpipe._get_program(scheduler="ddim", guidance=True,
                              latent_shape=LATENT_SHAPE, num_steps=2, chunk=8)
    tables = jpipe._get_tables("ddim", 2)
    args = (jpipe.params, jpipe._seed_keys(SEED, 1), cond, jnp.float32(7.5),
            tables)
    run = prog.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    latents, frames_u8 = run(*args)
    out = jpipe._postprocess(latents, frames_u8, None, "np", 1)
    identity_step1 = tables._replace(
        alpha_prod_prev=tables.alpha_prod_prev.at[1].set(tables.alpha_prod_t[1]))
    lat_step0, _ = run(*args[:4], identity_step1)
    noise = jax.random.normal(as_key(SEED), LATENT_SHAPE, jnp.float32)

    # Euler, the pipeline's default sampler, at a non-square size
    prog = jpipe._get_program(scheduler="euler", guidance=True,
                              latent_shape=EULER_SHAPE, num_steps=2, chunk=8)
    etables = jpipe._get_tables("euler", 2)
    eargs = args[:4] + (etables,)
    erun = prog.lower(*eargs).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    elat, eframes = erun(*eargs)
    eout = jpipe._postprocess(elat, eframes, None, "np", 1)
    elat0, _ = erun(*args[:4], etables._replace(
        sigmas=etables.sigmas.at[2].set(etables.sigmas[1])))

    tpipe = _tiny_port()
    tpipe.load_state_dicts({
        name: params_from_jax(
            {k: np.asarray(v) for k, v in VC.flatten_params(params[name]).items()},
            name, cfg)
        for name, cfg in (("unet", JUC.tiny()), ("vae", JVC.tiny()),
                          ("text", JCC.tiny()))})
    return dict(jax_out=out, jax_cond=np.array(cond),
                jax_step0=np.array(lat_step0), noise=np.array(noise),
                tpipe=tpipe, euler_out=eout, euler_step0=np.array(elat0),
                euler_noise=np.array(jax.random.normal(
                    as_key(SEED), EULER_SHAPE, jnp.float32)))


def _check_prompt_encoding(slice_run):
    got = slice_run["tpipe"].encode_prompt(PROMPT, NEG).numpy()
    assert got.shape == (2, 77, 64)
    np.testing.assert_allclose(got, slice_run["jax_cond"], atol=2e-5)


def _loop(tp, ctx, sched, tables, noise):
    """The port's denoise loop (CFG 7.5) from ``noise`` (vdx's)."""
    req = _Request(ctx, True, 7.5, sched, tables, None, len(tables.timesteps))
    return tp._denoise(req, noise * tables.init_noise_sigma).latents


def _check_latents_after_each_step(slice_run):
    tp = slice_run["tpipe"]
    ctx = torch.from_numpy(slice_run["jax_cond"].copy())
    for sched, out, want0, noise, shape, atol in (
            ("ddim", slice_run["jax_out"], slice_run["jax_step0"],
             slice_run["noise"], LATENT_SHAPE, STEP_ATOL),
            ("euler", slice_run["euler_out"], slice_run["euler_step0"],
             slice_run["euler_noise"], EULER_SHAPE, EULER_STEP_ATOL)):
        tables = tp._get_tables(sched, 2)
        noise = torch.from_numpy(noise)
        want1 = np.asarray(out.latents)
        step0, _ = tp.denoise_step(noise * tables.init_noise_sigma, 0, ctx,
                                   7.5, True, sched, tables)
        np.testing.assert_allclose(step0.numpy(), want0, atol=atol)
        # step 1 from matched inputs (vdx's latents after step 0) ...
        step1, _ = tp.denoise_step(torch.from_numpy(want0.copy()), 1, ctx,
                                   7.5, True, sched, tables)
        np.testing.assert_allclose(step1.numpy(), want1, atol=atol)
        # ... and the port's own trajectory from the same noise
        final = _loop(tp, ctx, sched, tables, noise)
        np.testing.assert_allclose(final.numpy(), want1, atol=2 * atol)


def _check_multistep_carry_against_vdx_samplers(slice_run):
    """The port's loop (its samplers, its carry) against a loop composed
    from vdx's sampler functions, both fed the port UNet's outputs."""
    import vdx.schedulers as JS
    from vdx.schedulers.common import cfg_combine as j_cfg

    tp = slice_run["tpipe"]
    ctx = torch.from_numpy(slice_run["jax_cond"].copy())
    noise = slice_run["noise"]
    n = 3
    for sched in ("dpm", "dpm_edm", "unipc"):
        got = _loop(tp, ctx, sched, tp._get_tables(sched, n),
                    torch.from_numpy(noise))
        js, jt = JS.get_sampler(sched), JS.make_tables_for(sched, n)
        x = jnp.asarray(noise) * jt.init_noise_sigma
        state = js.init_state(x)
        for i in range(n):
            model_in = js.scale_model_input(jnp.concatenate([x, x]), i, jt)
            t_b = torch.from_numpy(np.array(jt.timesteps[i])).expand(2)
            with torch.inference_mode():
                eps = tp.unet(torch.from_numpy(np.array(model_in)), t_b, ctx)
            u, c = np.split(eps.numpy(), 2)
            x, state = js.step_multistep(
                x, j_cfg(jnp.asarray(u), jnp.asarray(c), 7.5), i, state, jt)
        want = np.asarray(x)
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                   err_msg=sched)


def _check_frames_within_one_level(slice_run):
    tp = slice_run["tpipe"]
    for out, hw in ((slice_run["jax_out"], (64, 64)),
                    (slice_run["euler_out"], (64, 128))):
        want = out.frames[0]
        lat = torch.from_numpy(np.array(out.latents))
        got = tp._decode(lat, 8)[0].numpy()
        assert got.shape == want.shape == (8, *hw, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, diff.max()
        assert want.std() > 0


def _check_call_runs_the_slice_end_to_end(slice_run):
    """__call__ on the port (its own seeded noise, no latents_in): uint8
    frames of the requested shape, deterministic in the seed, and vdx's
    seeded call's frames within one uint8 level: the seed gives vdx's
    initial noise (vdx_torch.core.rng; the values within 4 fp32 ulps)."""
    tp = slice_run["tpipe"]
    kw = dict(negative_prompt=NEG, num_frames=8, height=64, width=64,
              num_inference_steps=2, guidance_scale=7.5, seed=SEED,
              output_type="np")
    noise = tp.initial_noise(LATENT_SHAPE, SEED).numpy()
    want_noise = slice_run["noise"]
    assert (np.abs(noise - want_noise)
            <= 4 * np.spacing(np.abs(want_noise))).all()
    a = tp(PROMPT, **kw).frames[0]
    b = tp(PROMPT, **kw).frames[0]
    assert a.shape == (8, 64, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    want = slice_run["jax_out"].frames[0]
    diff = np.abs(a.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    lat = tp(PROMPT, **dict(kw, output_type="latent")).latents
    assert tuple(lat.shape) == LATENT_SHAPE
    # the pipeline's own default sampler (Euler) through __call__
    dflt = TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                 text_config=TCC.tiny(), policy=TP, device="cpu")
    assert dflt.scheduler == "euler"
    dflt.unet, dflt.vae, dflt.text_encoder = tp.unet, tp.vae, tp.text_encoder
    e = dflt(PROMPT, **dict(kw, width=128, num_inference_steps=1)).frames[0]
    assert e.shape == (8, 64, 128, 3) and e.dtype == np.uint8 and e.std() > 0


def _check_ddim_tables_and_steps():
    from vdx.schedulers import ddim as JD
    from vdx_torch.schedulers import ddim as TD

    for n in (2, 25, 50):
        jt, tt = JD.make_tables(n), TD.make_tables(n)
        np.testing.assert_array_equal(tt.timesteps.numpy(), np.asarray(jt.timesteps))
        np.testing.assert_array_equal(tt.alpha_prod_t.numpy(),
                                      np.asarray(jt.alpha_prod_t))
        np.testing.assert_array_equal(tt.alpha_prod_prev.numpy(),
                                      np.asarray(jt.alpha_prod_prev))
        assert tt.init_noise_sigma == jt.init_noise_sigma
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((1, 4, 8, 8, 4)).astype(np.float32)
    jt, tt = JD.make_tables(25), TD.make_tables(25)
    for i in range(25):  # the same fp32 operations in the same order
        want = np.asarray(JD.step(jnp.asarray(x), jnp.asarray(eps), i, jt))
        got = TD.step(torch.from_numpy(x), torch.from_numpy(eps), i, tt).numpy()
        np.testing.assert_array_equal(got, want)
    assert TD.scale_model_input(torch.from_numpy(x), 0, tt).data_ptr() != 0


def _check_cfg_combine(rescale):
    from vdx.schedulers.common import cfg_combine as J
    from vdx_torch.schedulers.common import cfg_combine as T

    rng = np.random.default_rng(1)
    u, c = (rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    want = np.asarray(J(jnp.asarray(u), jnp.asarray(c), 7.5, rescale))
    got = T(torch.from_numpy(u), torch.from_numpy(c), 7.5, rescale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _check_to_uint8():
    from vdx.pipelines.base import _to_uint8 as J
    from vdx_torch.pipelines.base import _to_uint8 as T

    x = np.concatenate([np.linspace(-1.2, 1.2, 4001, dtype=np.float32),
                        (np.arange(256, dtype=np.float32) + 0.5) / 127.5 - 1.0])
    np.testing.assert_array_equal(T(torch.from_numpy(x)).numpy(),
                                  np.asarray(J(jnp.asarray(x))))


def _check_random_init_follows_vdx_rules():
    """fan-in-scaled normals (fan-in in vdx's layout), ones for norm
    scales, zeros for biases — drawn on the parameters' device."""
    from vdx_torch.pipelines.base import random_init_

    p = _tiny_port()
    n = random_init_(p.unet, torch.Generator().manual_seed(0))
    assert n == sum(q.numel() for q in p.unet.parameters())
    sd = p.unet.state_dict()
    w = sd["down_blocks.0.resnets.0.conv1.weight"]  # [O, I, 3, 3]
    assert abs(w.std().item() * (w[0].numel() ** 0.5) - 1.0) < 0.05
    assert torch.all(sd["down_blocks.0.resnets.0.norm1.weight"] == 1)
    assert torch.all(sd["down_blocks.0.resnets.0.conv1.bias"] == 0)
    random_init_(p.text_encoder, torch.Generator().manual_seed(0))
    emb = p.text_encoder.text_model.embeddings.token_embedding.weight
    assert abs(emb.std().item() * emb.shape[0] ** 0.5 - 1.0) < 0.05


def _check_surface_raises(slice_run):
    """vdx's request surface runs (each call's parity with vdx is held in
    tests/test_torch_port_requests.py and test_torch_port_video2video.py);
    frame sharding needs a process group of as many ranks
    (tests/test_torch_port_frame_parallel.py), and a mesh or seq_impl
    without frame_shards > 1 is ignored, as vdx ignores them."""
    tp = slice_run["tpipe"]
    kw = dict(num_frames=8, height=64, width=64, num_inference_steps=2,
              output_type="latent")
    clip = np.zeros((8, 64, 64, 3), np.uint8)
    assert tuple(tp(PROMPT, video=clip, strength=0.5, **kw).latents.shape) \
        == LATENT_SHAPE
    assert torch.equal(tp(PROMPT, dispatch_steps=1, **kw).latents,
                       tp(PROMPT, **kw).latents)
    assert tuple(tp([PROMPT, NEG], seed=[1, 2], **kw).latents.shape) \
        == (2,) + LATENT_SHAPE[1:]
    assert torch.equal(tp(PROMPT, guidance_scale=np.full(2, 7.5), **kw).latents,
                       tp(PROMPT, guidance_scale=7.5, **kw).latents)
    dev = tp(PROMPT, **dict(kw, output_type="device", num_inference_steps=1))
    assert torch.is_tensor(dev.frames) and dev.frames.dtype == torch.uint8
    assert tuple(dev.frames.shape) == (1, 8, 64, 64, 3)
    # any other output_type gives PIL frames, as vdx's _postprocess does
    u8 = dev.frames.numpy()
    for other in ("pil", "PIL", "frames"):
        out = tp(PROMPT, **dict(kw, output_type=other, num_inference_steps=1))
        want = JPipe._postprocess(None, None, jnp.asarray(u8), None, other, 1)
        for frames in (out.frames, want.frames):
            assert len(frames) == 1 and len(frames[0]) == 8
            np.testing.assert_array_equal(
                np.stack([np.asarray(f) for f in frames[0]]), u8[0])
    with pytest.raises(ValueError, match="unknown sampler"):
        tp(PROMPT, scheduler="heun", **kw)
    with pytest.raises(ValueError, match="unknown sampler"):
        TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
              text_config=TCC.tiny(), device="cpu", scheduler="heun")
    with pytest.raises(RuntimeError, match="process group"):
        _tiny_port(frame_shards=2)
    for kwargs in (dict(mesh=object()), dict(seq_impl="ring")):
        assert _tiny_port(**kwargs).mesh is None
    # PAB, context windows, LoRA and checkpoints are in (item 10b): the
    # pipeline takes them, and rejects what vdx rejects
    assert _tiny_port(pab=PABConfig()).pab == PABConfig()
    assert _tiny_port(context=ContextConfig()).context == ContextConfig()
    for call, match in ((lambda: tp.set_lora_scale(0.5), "no LoRA active"),
                        (tp.unload_lora, "no LoRA active"),
                        (lambda: tp.load_pretrained({}), "missing components"),
                        (lambda: tp.load_pretrained({"clip": {}}), "unknown"),
                        (lambda: TPipe.from_pretrained(
                            {}, unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                            text_config=TCC.tiny(), device="cpu"),
                         "missing components")):
        with pytest.raises(ValueError, match=match):
            call()


def _check_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        p = TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                  text_config=TCC.tiny(), scheduler="ddim")
        assert p.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                  text_config=TCC.tiny(), scheduler="ddim")


# A few tests per file, each looping over its cases: pytest-xdist's
# loadfile mode hands out files with many tests first, and this file's few
# tests keep it behind the suite's heavy files.
def test_slice_matches_vdx(slice_run):
    _check_prompt_encoding(slice_run)
    _check_latents_after_each_step(slice_run)
    _check_frames_within_one_level(slice_run)
    _check_call_runs_the_slice_end_to_end(slice_run)
    _check_multistep_carry_against_vdx_samplers(slice_run)


def test_scheduler_math_matches_vdx():
    _check_ddim_tables_and_steps()
    for rescale in (0.0, 0.7):
        _check_cfg_combine(rescale)
    _check_to_uint8()


def test_pipeline_surface(slice_run):
    _check_random_init_follows_vdx_rules()
    _check_surface_raises(slice_run)
    _check_runs_on_cuda_unless_asked_for_the_cpu()
