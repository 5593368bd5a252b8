"""The port's AnimateDiff slice against vdx's, end to end on the CPU (fp32,
tiny configs), plus the DDIM scheduler, the CFG combine and the pipeline's
surface.

vdx's AnimateDiffPipeline runs once (the only vdx pipeline compile in the
port's tests): 8 frames at 64x64, 2 DDIM steps, CFG 7.5, its program
compiled at XLA optimisation level 0 (vdx's own O0 and default builds
differ by up to 8e-5 in these latents and one uint8 level in the frames).
The port gets the same weights through
vdx_torch.core.convert.params_from_jax and the vdx program's initial noise (jax.random.normal(as_key(seed), latent_shape),
as vdx's ``_noise_maker`` draws it).

Per-step latents: vdx's compiled program takes its scheduler tables as
runtime arguments, so running it again with step 1 turned into the
identity update (alpha_prod_prev = alpha_prod_t) returns the latents
after step 0 from the same executable.

Tolerances: one UNet call agrees to ~2e-5 (test_torch_port_models); the
CFG combine u + 7.5 (c - u) scales an eps difference by up to 16, and the
DDIM step by up to sqrt(1 - a) / sqrt(a) + 1 < 3 at these timesteps, so
latents after a step agree to 16 * 3 * 2e-5 ~= 1e-3 (atol, on O(1)
latents). Frames: within one uint8 level.
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
STEP_ATOL = 1e-3


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

    tpipe = _tiny_port()
    tpipe.load_state_dicts({
        name: params_from_jax(
            {k: np.asarray(v) for k, v in VC.flatten_params(params[name]).items()},
            name, cfg)
        for name, cfg in (("unet", JUC.tiny()), ("vae", JVC.tiny()),
                          ("text", JCC.tiny()))})
    return dict(jax_out=out, jax_cond=np.array(cond),
                jax_step0=np.array(lat_step0), noise=np.array(noise),
                tpipe=tpipe)


def _check_prompt_encoding(slice_run):
    got = slice_run["tpipe"].encode_prompt(PROMPT, NEG).numpy()
    assert got.shape == (2, 77, 64)
    np.testing.assert_allclose(got, slice_run["jax_cond"], atol=2e-5)


def _check_latents_after_each_step(slice_run):
    tp = slice_run["tpipe"]
    ctx = torch.from_numpy(slice_run["jax_cond"].copy())
    tables = tp._get_tables(2)
    noise = torch.from_numpy(slice_run["noise"])
    want0 = slice_run["jax_step0"]
    want1 = np.asarray(slice_run["jax_out"].latents)
    step0 = tp.denoise_step(noise, 0, ctx, 7.5, True, tables)
    np.testing.assert_allclose(step0.numpy(), want0, atol=STEP_ATOL)
    # step 1 from matched inputs (vdx's latents after step 0) ...
    step1 = tp.denoise_step(torch.from_numpy(want0.copy()), 1, ctx, 7.5, True,
                            tables)
    np.testing.assert_allclose(step1.numpy(), want1, atol=STEP_ATOL)
    # ... and the port's own trajectory from the same noise
    final = tp._denoise(ctx, 7.5, True, tables, LATENT_SHAPE, SEED,
                        latents_in=noise)
    np.testing.assert_allclose(final.numpy(), want1, atol=2 * STEP_ATOL)


def _check_frames_within_one_level(slice_run):
    tp = slice_run["tpipe"]
    want = slice_run["jax_out"].frames[0]
    lat = torch.from_numpy(np.array(slice_run["jax_out"].latents))
    got = tp._decode(lat, 8)[0].numpy()
    assert got.shape == want.shape == (8, 64, 64, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert want.std() > 0


def _check_call_runs_the_slice_end_to_end(slice_run):
    """__call__ on the port (its own seeded noise): uint8 frames of the
    requested shape, deterministic in the seed."""
    tp = slice_run["tpipe"]
    kw = dict(negative_prompt=NEG, num_frames=8, height=64, width=64,
              num_inference_steps=2, guidance_scale=7.5, seed=SEED,
              output_type="np")
    a = tp(PROMPT, **kw).frames[0]
    b = tp(PROMPT, **kw).frames[0]
    assert a.shape == (8, 64, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    lat = tp(PROMPT, **dict(kw, output_type="latent")).latents
    assert tuple(lat.shape) == LATENT_SHAPE


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
    tp = slice_run["tpipe"]
    kw = dict(num_frames=8, height=64, width=64, num_inference_steps=1)
    with pytest.raises(NotImplementedError):
        tp(PROMPT, video=np.zeros((8, 64, 64, 3), np.uint8), **kw)
    with pytest.raises(NotImplementedError):
        tp(PROMPT, dispatch_steps=1, **kw)
    with pytest.raises(NotImplementedError):
        tp(PROMPT, scheduler="euler", **kw)
    with pytest.raises(NotImplementedError):
        tp([PROMPT, PROMPT], **kw)
    with pytest.raises(NotImplementedError):
        tp(PROMPT, guidance_scale=np.full(1, 7.5), **kw)
    with pytest.raises(NotImplementedError):
        tp(PROMPT, output_type="device", **kw)
    with pytest.raises(NotImplementedError):
        TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
              text_config=TCC.tiny(), device="cpu")  # default scheduler: euler


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


def test_scheduler_math_matches_vdx():
    _check_ddim_tables_and_steps()
    for rescale in (0.0, 0.7):
        _check_cfg_combine(rescale)
    _check_to_uint8()


def test_pipeline_surface(slice_run):
    _check_random_init_follows_vdx_rules()
    _check_surface_raises(slice_run)
    _check_runs_on_cuda_unless_asked_for_the_cpu()
