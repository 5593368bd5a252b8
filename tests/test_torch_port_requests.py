"""The port's AnimateDiff request surface against vdx's, on the CPU (fp32,
tiny configs): prompt batches with per-video seeds, per-step guidance
schedules, guidance_rescale and FreeU through one vdx program; the port's
loop modes (variable_steps, dispatch_steps, skip, progress) against its
own plain loop; the module-level pieces against vdx's; and the calls the
surface rejects, with vdx's exception types.

vdx compiles one pipeline program here (at XLA optimisation level 0, as
tests/test_torch_port_pipeline.py): B = 2 prompts with seeds
[1234, 77], the schedule [7.5, 5.0], guidance_rescale 0.7 and FreeU at
its defaults, 2 DDIM steps, 8 frames at 64x64. Per-step latents come from
the same executable with step 1 made the identity update (its tables are
runtime arguments). Bars, as in tests/test_torch_port_pipeline.py:
latents 1e-3 after a step, frames one uint8 level.

The batch's noise: vdx draws video b from its own key (``_noise_maker``'s
vmap); its threefry bits equal the port's exactly, and the normals carry
the ErfInv polynomial's rounding, within 4 fp32 ulps of each element
(tests/test_torch_port_rng.py). The port's batch draw equals its single
draws bit for bit, and its video b equals its own single call with seed b
bit for bit (one CPU, the same kernels at both batch sizes; on the card
other batch sizes may pick other cuBLAS and cuDNN algorithms).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_models import (_compile_o0, _jax_params,
                                    _load_through_port_converter)
from vdx.core import convert as VC
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.unet_motion import UNetMotion as JU
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import VAEConfig as JVC
from vdx.nn import freeu as JF
from vdx.pipelines import AnimateDiffPipeline as JPipe
from vdx.pipelines import PABConfig
from vdx.pipelines import SkipConfig as JSkip
from vdx_torch.core import rng
from vdx_torch.core.convert import params_from_jax
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.models.clip_text import CLIPTextConfig as TCC
from vdx_torch.models.unet_motion import UNetMotion as TU
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.models.vae import VAEConfig as TVC
from vdx_torch.nn import freeu as TF
from vdx_torch.pipelines import AnimateDiffPipeline as TPipe
from vdx_torch.pipelines import SkipConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PROMPTS = ["a corgi walking on the beach, sunset lighting",
           "a red panda eating bamboo in the snow"]
NEG = "bad quality, blurry"
SEEDS = [1234, 77]
SHAPE = (2, 8, 8, 8, 4)
SCHEDULE = np.array([7.5, 5.0], np.float32)
RESCALE = 0.7
STEP_ATOL = 1e-3
# the port-only checks: 4 frames, output_type="latent"
SMALL = dict(negative_prompt=NEG, num_frames=4, height=64, width=64,
             output_type="latent")


def tiny_port(**kw):
    return TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                 text_config=TCC.tiny(), policy=TP, scheduler="ddim",
                 device="cpu", **kw)


def vdx_params(tpipe):
    """The port's weights in vdx's trees, carried by vdx's own rules."""
    rule_sets = {"unet": VC.unet_motion_rules(JUC.tiny()),
                 "vae": VC.vae_rules(JVC.tiny()),
                 "text": VC.clip_text_rules(JCC.tiny())}
    modules = {"unet": tpipe.unet, "vae": tpipe.vae, "text": tpipe.text_encoder}
    params = {}
    for name, rules in rule_sets.items():
        sd = {k: v.numpy() for k, v in modules[name].state_dict().items()}
        params[name] = VC.unflatten_params(
            {p: tr(sd[hf]) for p, (hf, tr) in rules.items() if hf in sd})
    return params


def load_from_vdx(tpipe, params):
    """vdx's trees into the port through its converter."""
    tpipe.load_state_dicts({
        name: params_from_jax(
            {k: np.asarray(v) for k, v in VC.flatten_params(params[name]).items()},
            name, cfg)
        for name, cfg in (("unet", JUC.tiny()), ("vae", JVC.tiny()),
                          ("text", JCC.tiny()))})
    return tpipe


def compile_o0(prog, args, **kw):
    return prog.lower(*args, **kw).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def sibling(base, **kw):
    """A tiny port pipeline with other loop knobs over ``base``'s modules."""
    p = tiny_port(**kw)
    p.unet, p.vae, p.text_encoder = base.unet, base.vae, base.text_encoder
    return p


@pytest.fixture(scope="module")
def batch_run():
    seed_pipe = tiny_port()
    seed_pipe.init_params(0)
    params = vdx_params(seed_pipe)
    jpipe = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                  text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                  params=params, guidance_rescale=RESCALE, freeu=JF.FreeUConfig())
    cond = jpipe.encode_prompt(PROMPTS, NEG)
    prog = jpipe._get_program(scheduler="ddim", guidance=True,
                              latent_shape=SHAPE, num_steps=2, chunk=8)
    tables = jpipe._get_tables("ddim", 2)
    keys = jpipe._seed_keys(SEEDS, 2)
    args = (jpipe.params, keys, cond, jnp.asarray(SCHEDULE), tables)
    run = compile_o0(prog, args)
    latents, frames = run(*args)
    lat0, _ = run(*args[:4], tables._replace(
        alpha_prod_prev=tables.alpha_prod_prev.at[1].set(tables.alpha_prod_t[1])))
    draws = jax.vmap(lambda k: (jax.random.bits(k, SHAPE[1:], jnp.uint32),
                                jax.random.normal(k, SHAPE[1:], jnp.float32)))
    bits, noise = draws(keys)
    tpipe = load_from_vdx(tiny_port(guidance_rescale=RESCALE,
                                    freeu=TF.FreeUConfig()), params)
    return dict(jpipe=jpipe, cond=np.array(cond), latents=np.array(latents),
                frames=np.array(frames), step0=np.array(lat0),
                bits=np.array(bits), noise=np.array(noise), tpipe=tpipe,
                base=seed_pipe)


def _check_batched_noise(run):
    tp = run["tpipe"]
    got = tp.initial_noise(SHAPE, SEEDS)
    for b, seed in enumerate(SEEDS):
        np.testing.assert_array_equal(
            rng.random_bits(seed, SHAPE[1:]).numpy(),
            run["bits"][b].astype(np.int64))
        assert torch.equal(got[b], rng.normal(seed, SHAPE[1:]))
    want = run["noise"]
    assert (np.abs(got.numpy() - want) <= 4 * np.spacing(np.abs(want))).all()
    # a scalar seed serves every video of the batch
    same = tp.initial_noise(SHAPE, SEEDS[0])
    assert torch.equal(same[0], same[1]) and torch.equal(same[0], got[0])


def _check_batch_steps_and_frames(run):
    tp = run["tpipe"]
    ctx = tp.encode_prompt(PROMPTS, NEG)
    np.testing.assert_allclose(ctx.numpy(), run["cond"], atol=2e-5)
    ctx = torch.from_numpy(run["cond"].copy())
    tables = tp._get_tables("ddim", 2)
    sched = torch.from_numpy(SCHEDULE)
    noise = torch.from_numpy(run["noise"].copy())
    step0, _ = tp.denoise_step(noise, 0, ctx, sched, True, "ddim", tables)
    np.testing.assert_allclose(step0.numpy(), run["step0"], atol=STEP_ATOL)
    step1, _ = tp.denoise_step(torch.from_numpy(run["step0"].copy()), 1, ctx,
                               sched, True, "ddim", tables)
    np.testing.assert_allclose(step1.numpy(), run["latents"], atol=STEP_ATOL)
    # __call__ from the port's own seeded noise
    kw = dict(negative_prompt=NEG, num_frames=8, height=64, width=64,
              num_inference_steps=2, guidance_scale=SCHEDULE)
    out = tp(PROMPTS, seed=SEEDS, output_type="np", **kw)
    np.testing.assert_allclose(out.latents.numpy(), run["latents"],
                               atol=2 * STEP_ATOL)
    for b in range(2):
        got, want = out.frames[b], run["frames"][b]
        assert got.shape == want.shape == (8, 64, 64, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, (b, diff.max())
        single = tp(PROMPTS[b], seed=SEEDS[b], output_type="np", **kw)
        assert torch.equal(single.latents[0], out.latents[b])
        np.testing.assert_array_equal(single.frames[0], got)
    dev = tp(PROMPTS, seed=SEEDS, output_type="device", **kw)
    assert torch.is_tensor(dev.frames) and dev.frames.dtype == torch.uint8
    assert tuple(dev.frames.shape) == (2, 8, 64, 64, 3)
    np.testing.assert_array_equal(dev.frames.numpy(), np.stack(out.frames))


def test_prompt_batch_matches_vdx(batch_run):
    _check_batched_noise(batch_run)
    _check_batch_steps_and_frames(batch_run)


def _check_variable_steps_equal_static(base):
    var = sibling(base, variable_steps=8)
    for sched, n in (("ddim", 3), ("euler", 2), ("dpm", 3)):
        kw = dict(SMALL, scheduler=sched, num_inference_steps=n, seed=5)
        for g in (7.5, np.linspace(8.0, 6.0, n).astype(np.float32)):
            assert torch.equal(var("a fox", guidance_scale=g, **kw).latents,
                               base("a fox", guidance_scale=g, **kw).latents), sched
    tables = var._get_tables("euler", 2, 8)
    assert tables.timesteps.shape == (8,) and tables.sigmas.shape == (9,)


def _check_dispatch_segments_equal_monolithic(base):
    skipping = sibling(base, skip=SkipConfig(threshold=0.5, warmup_steps=1,
                                             cooldown_steps=1))
    for pipe, sched in ((base, "ddim"), (base, "dpm"), (skipping, "ddim"),
                        (skipping, "dpm")):
        kw = dict(SMALL, scheduler=sched, num_inference_steps=5, seed=6)
        whole = pipe("a fox", **kw)
        for k in (1, 2, 3):
            seg = pipe("a fox", dispatch_steps=k, **kw)
            assert torch.equal(seg.latents, whole.latents), (sched, k)
            assert (seg.n_evals is None) == (pipe.skip is None)
            if pipe.skip is not None:
                assert int(seg.n_evals) == int(whole.n_evals)


def _check_skip_and_progress(base):
    calls = []
    exact = sibling(base, skip=SkipConfig(threshold=0.0),
                    progress=lambda i, n: calls.append((i, n)))
    for sched in ("ddim", "unipc"):
        kw = dict(SMALL, scheduler=sched, num_inference_steps=6, seed=7)
        calls.clear()
        out = exact("a fox", **kw)
        assert torch.equal(out.latents, base("a fox", **kw).latents), sched
        assert out.n_evals.dtype == torch.int32 and int(out.n_evals) == 6
        assert calls == [(i, 6) for i in range(6)]
    calls.clear()
    skipping = sibling(base, skip=SkipConfig(threshold=10.0, warmup_steps=2,
                                             cooldown_steps=1),
                       progress=lambda i, n: calls.append((i, n)))
    out = skipping("a fox", **dict(SMALL, num_inference_steps=6, seed=7))
    # steps 0, 1 (warm-up) and 5 (cool-down) evaluate; the drift of 2-4
    # stays under 10
    assert int(out.n_evals) == 3 == len(calls)
    assert [i for i, _ in calls] == [0, 1, 5]
    assert torch.isfinite(out.latents).all()


def _check_pad_tables():
    import vdx.schedulers as JS
    from vdx.schedulers.common import pad_tables as j_pad
    import vdx_torch.schedulers as TS
    from vdx_torch.schedulers.common import pad_tables as t_pad

    for name in ("ddim", "euler", "dpm", "edm", "dpm_edm", "unipc"):
        for n, m in ((3, 8), (4, 4)):
            want = j_pad(JS.make_tables_for(name, n), n, m)._asdict()
            got = t_pad(TS.make_tables_for(name, n), n, m)._asdict()
            assert got.keys() == want.keys()
            for k, w in want.items():
                w = np.asarray(w)
                g = got[k].numpy()
                assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
                np.testing.assert_array_equal(g, w, err_msg=f"{name}.{k}")


def _check_cfg_rescale_per_video():
    """The rescale's std is per sample: a batch of two equals each video
    alone (up to the reduction's order), and vdx's batched combine."""
    from vdx.schedulers.common import cfg_combine as J
    from vdx_torch.schedulers.common import cfg_combine as T

    r = np.random.default_rng(3)
    u, c = (r.standard_normal((2, 4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    c[1] *= 5.0  # videos of different spread
    u_t, c_t = torch.from_numpy(u), torch.from_numpy(c)
    batch = T(u_t, c_t, 7.5, RESCALE)
    alone = torch.cat([T(u_t[b:b + 1], c_t[b:b + 1], 7.5, RESCALE)
                       for b in range(2)])
    np.testing.assert_allclose(batch.numpy(), alone.numpy(), rtol=1e-6, atol=1e-6)
    want = np.asarray(J(jnp.asarray(u), jnp.asarray(c), 7.5, RESCALE))
    np.testing.assert_allclose(batch.numpy(), want, atol=1e-5)


def _check_freeu_functions():
    r = np.random.default_rng(4)
    for shape in ((2, 8, 8, 16), (3, 7, 9, 8)):
        x = r.standard_normal(shape).astype(np.float32)
        skip = r.standard_normal(shape).astype(np.float32)
        for t, s in ((1, 0.9), (1, 0.2), (2, 0.5)):
            want = np.asarray(JF.fourier_filter(jnp.asarray(x), t, s))
            got = TF.fourier_filter(torch.from_numpy(x), t, s).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5)
        xt = torch.from_numpy(x)
        assert TF.fourier_filter(xt, 1, 1.0) is xt  # the identity is exact
        for stage in (0, 1, 2):
            jx, js = JF.apply_freeu(stage, jnp.asarray(x), jnp.asarray(skip),
                                    JF.FreeUConfig())
            tx, ts = TF.apply_freeu(stage, xt, torch.from_numpy(skip),
                                    TF.FreeUConfig())
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def _check_unet_attn_impl_and_freeu():
    """The UNet built with attn_impl="xla" and FreeU against vdx's UNet
    applied with the same settings, at the block bar 2e-5 (timesteps away
    from 1000, test_torch_port_models)."""
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 4, 8, 8, 4)).astype(np.float32)
    ctx = r.standard_normal((2, 7, 64)).astype(np.float32)
    t = np.array([10, 400], np.int32)
    tm = TU(TUC.tiny(), TP, attn_impl="xla", freeu=TF.FreeUConfig())
    params = _jax_params(tm, VC.unet_motion_rules(JUC.tiny()), 5)
    jm = JU(JUC.tiny(), policy=JP, attn_impl="xla", freeu=JF.FreeUConfig())
    want = np.asarray(_compile_o0(jm.apply, params, x, t, ctx)(params, x, t, ctx))
    _load_through_port_converter(tm, params, "unet", JUC.tiny())
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, t, ctx))).numpy()
        plain = TU(TUC.tiny(), TP)
        plain.load_state_dict(tm.state_dict())
        base = plain(*(torch.from_numpy(a) for a in (x, t, ctx))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(got - base).max() > 1e-3  # FreeU changed the output


def test_port_loop_modes_and_modules(batch_run):
    base = batch_run["base"]
    _check_variable_steps_equal_static(base)
    _check_dispatch_segments_equal_monolithic(base)
    _check_skip_and_progress(base)
    _check_pad_tables()
    _check_cfg_rescale_per_video()
    _check_freeu_functions()
    _check_unet_attn_impl_and_freeu()


def _same_error(vdx_call, port_call, exc, match=None):
    """vdx and the port reject the call with the same exception type."""
    with pytest.raises(exc, match=match):
        vdx_call()
    with pytest.raises(exc, match=match):
        port_call()


def test_surface_rejects_what_vdx_rejects(batch_run):
    jpipe, tp = batch_run["jpipe"], batch_run["tpipe"]
    kw = dict(num_frames=8, height=64, width=64, num_inference_steps=2)
    _same_error(lambda: jpipe(PROMPTS, guidance_scale=np.full(3, 7.5), **kw),
                lambda: tp(PROMPTS, guidance_scale=np.full(3, 7.5), **kw),
                ValueError, "3 entries for 2 steps")
    _same_error(lambda: jpipe(PROMPTS, seed=[1, 2, 3], **kw),
                lambda: tp(PROMPTS, seed=[1, 2, 3], **kw), AssertionError)
    _same_error(lambda: jpipe(PROMPTS[0], seed=[1, 2], **kw),
                lambda: tp(PROMPTS[0], seed=[1, 2], **kw), ValueError)
    _same_error(lambda: JPipe(unet_config=JUC.tiny(), pab=PABConfig(),
                              skip=JSkip()),
                lambda: tiny_port(pab=object(), skip=SkipConfig()),
                ValueError, "pick one")
    _same_error(lambda: JSkip(warmup_steps=0), lambda: SkipConfig(warmup_steps=0),
                ValueError)
    _same_error(lambda: JSkip(threshold=-1.0), lambda: SkipConfig(threshold=-1.0),
                ValueError)
    # sampler_configs: a sampler without a config warns once, then runs
    # on the module's defaults
    from vdx.schedulers.ddim import DDIMConfig as JDDIM
    from vdx_torch.schedulers.ddim import DDIMConfig as TDDIM

    jcfg = JPipe(unet_config=JUC.tiny(), sampler_configs={"ddim": JDDIM()})
    tcfg = sibling(batch_run["base"], sampler_configs={"ddim": TDDIM()})
    for pipe in (jcfg, tcfg):
        with pytest.warns(UserWarning, match="none for scheduler='euler'"):
            assert pipe._sampler_cfg("euler") is None
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert pipe._sampler_cfg("euler") is None
            assert pipe._sampler_cfg("ddim") is not None
    small = dict(SMALL, num_inference_steps=2, seed=3)
    with pytest.warns(UserWarning):
        out = tcfg("a fox", scheduler="dpm", **small)
    assert torch.equal(out.latents,
                       batch_run["base"]("a fox", scheduler="dpm", **small).latents)
    # a config reaches the sampler: DDIM with trailing spacing differs
    trailing = sibling(batch_run["base"], sampler_configs={
        "ddim": TDDIM(timestep_spacing="trailing")})
    assert not torch.equal(trailing("a fox", **small).latents,
                           batch_run["base"]("a fox", **small).latents)
