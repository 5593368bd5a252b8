"""The port's video2video against vdx's, on the CPU (fp32, tiny configs):
the AutoencoderKL encoder, the samplers' ``add_noise``/``add_noise_at``,
one vdx video2video program under skip turbo mode, and the calls
video2video rejects, with vdx's exception types.

vdx compiles one pipeline program here (XLA optimisation level 0): a
clip of 8 frames at 64x64 in two 4-frame encode and decode chunks, 8 DDIM
steps at strength 0.5 (steps 4-7 run), CFG 7.5, under
SkipConfig(threshold=10, warmup 2, cool-down 1): the warm-up window
starts at t_start, so steps 4 and 5 are forced evaluations, 7 is the
cool-down's, and step 6 reuses step 5's output (its drift stays far under
10): n_evals is 3 on both sides (a warm-up counted from step 0 would
give 2). Bars, as in tests/test_torch_port_pipeline.py: 1e-3 a denoiser
evaluation on the latents, so 3e-3 after three (that file's rule for its
two-step trajectory), frames one uint8 level; the encoder at the block
bar 2e-5 (tests/test_torch_port_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_models import (_compile_o0, _jax_params,
                                    _load_through_port_converter)
from test_torch_port_requests import (NEG, compile_o0, load_from_vdx,
                                      tiny_port, vdx_params)
from vdx.core import convert as VC
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import AutoencoderKL as JV
from vdx.models.vae import VAEConfig as JVC
from vdx.pipelines import AnimateDiffPipeline as JPipe
from vdx.pipelines import PABConfig
from vdx.pipelines import SkipConfig as JSkip
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.models.vae import AutoencoderKL as TV
from vdx_torch.pipelines import PABConfig as TPABConfig
from vdx_torch.pipelines import SkipConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PROMPT = "a corgi running through autumn leaves"
SEED = 4321
N, STRENGTH, T_START = 8, 0.5, 4
CHUNK = 4
LATENT_SHAPE = (1, 8, 8, 8, 4)
SKIP = dict(threshold=10.0, warmup_steps=2, cooldown_steps=1)
ATOL = 1e-3


def clip_u8(frames=8, size=64, phase=0.0):
    """A smooth moving pattern, [F, size, size, 3] uint8."""
    f, y, x = np.meshgrid(np.arange(frames), np.arange(size), np.arange(size),
                          indexing="ij")
    chans = [np.sin(0.2 * x + 0.3 * f + phase + c) * np.cos(0.15 * y - 0.1 * f + c)
             for c in (0.0, 1.0, 2.0)]
    return np.round(127.5 + 127.5 * np.stack(chans, -1)).astype(np.uint8)


def _check_encoder():
    r = np.random.default_rng(8)
    x = np.tanh(r.standard_normal((2, 64, 64, 3))).astype(np.float32)
    tm = TV(JVC.tiny(), TP)
    params = _jax_params(tm, VC.vae_rules(JVC.tiny()), 8)
    jm = JV(JVC.tiny(), policy=JP)
    _load_through_port_converter(tm, params, "vae", JVC.tiny())  # strict load
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for method in ("encode_moments", "encode"):
            fn = lambda p, xx, m=method: jm.apply(p, xx, method=getattr(jm, m))  # noqa: E731
            want = np.asarray(_compile_o0(fn, params, x)(params, x))
            got = getattr(tm, method)(xt).numpy()
            assert got.shape == want.shape, method
            np.testing.assert_allclose(got, want, atol=2e-5, err_msg=method)
        enc = tm.encoder(xt)
        assert tuple(enc.shape) == (2, 8, 8, 8)
        # a sampled posterior: mean + std * n from the generator, scaled
        mean, logvar = tm.encode_moments(xt).chunk(2, dim=-1)
        n = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
        want = (mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * n) \
            * JVC.tiny().scaling_factor
        got = tm.encode(xt, generator=torch.Generator().manual_seed(3))
        assert torch.equal(got, want)


def _check_add_noise():
    import vdx.schedulers as JS
    import vdx_torch.schedulers as TS

    r = np.random.default_rng(9)
    x, n = (r.standard_normal((2, 4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    xt, nt = torch.from_numpy(x), torch.from_numpy(n)
    for t in (0, 501, 999):
        want = np.asarray(JS.ddim.add_noise(jnp.asarray(x), jnp.asarray(n), t))
        got = TS.ddim.add_noise(xt, nt, t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for name in ("ddim", "euler", "edm"):
        jt, tt = JS.make_tables_for(name, N), TS.make_tables_for(name, N)
        for i in range(N):
            want = np.asarray(JS.get_sampler(name).add_noise_at(
                jnp.asarray(x), jnp.asarray(n), i, jt))
            got = TS.get_sampler(name).add_noise_at(xt, nt, i, tt)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5,
                                       err_msg=f"{name} step {i}")


def test_encoder_and_add_noise_match_vdx():
    _check_encoder()
    _check_add_noise()


@pytest.fixture(scope="module")
def v2v_run():
    seed_pipe = tiny_port()
    seed_pipe.init_params(1)
    params = vdx_params(seed_pipe)
    jpipe = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                  text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                  params=params, skip=JSkip(**SKIP))
    cond = jpipe.encode_prompt(PROMPT, NEG)
    prog = jpipe._get_program(scheduler="ddim", guidance=True,
                              latent_shape=LATENT_SHAPE, num_steps=N,
                              chunk=CHUNK, t_start=T_START, encode_chunk=CHUNK)
    video = jnp.asarray(clip_u8()[None].astype(np.float32) / 127.5 - 1.0)
    args = (jpipe.params, jpipe._seed_keys(SEED, 1), cond, jnp.float32(7.5),
            jpipe._get_tables("ddim", N))
    latents, frames, n_evals = compile_o0(prog, args, video=video)(*args, video=video)
    tpipe = load_from_vdx(tiny_port(skip=SkipConfig(**SKIP)), params)
    return dict(jpipe=jpipe, params=params, tpipe=tpipe, latents=np.array(latents),
                frames=np.array(frames), n_evals=int(n_evals))


def test_video2video_matches_vdx(v2v_run):
    tp = v2v_run["tpipe"]
    kw = dict(negative_prompt=NEG, strength=STRENGTH, num_inference_steps=N,
              seed=SEED, decode_chunk=CHUNK, output_type="np")
    clip = clip_u8()
    out = tp(PROMPT, video=clip, **kw)
    assert v2v_run["n_evals"] == 3 and int(out.n_evals) == 3
    np.testing.assert_allclose(out.latents.numpy(), v2v_run["latents"],
                               atol=3 * ATOL)
    got, want = out.frames[0], v2v_run["frames"][0]
    assert got.shape == want.shape == (8, 64, 64, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    # float input in [-1, 1], and a [B, F, H, W, 3] batch of one, agree
    as_float = tp(PROMPT, video=clip[None].astype(np.float32) / 127.5 - 1.0, **kw)
    assert torch.equal(as_float.latents, out.latents)
    np.testing.assert_array_equal(as_float.frames[0], got)
    # the chunked encode is the per-chunk encode
    with torch.inference_mode():
        x = torch.from_numpy(clip).float() / 127.5 - 1.0
        z = tp._encode(x[None], CHUNK)
        assert torch.equal(z[0, :CHUNK], tp.vae.encode(x[:CHUNK]))
    # the loop runs steps [t_start, N) only, and evaluates at 4, 5 and 7
    calls = []
    tp.progress_callback = lambda i, n: calls.append((i, n))
    try:
        tp(PROMPT, video=clip, **dict(kw, output_type="latent"))
    finally:
        tp.progress_callback = None
    assert calls == [(4, N), (5, N), (7, N)]


def test_video2video_rejects_what_vdx_rejects(v2v_run):
    jpipe, tp = v2v_run["jpipe"], v2v_run["tpipe"]
    clip = clip_u8()
    kw = dict(num_inference_steps=N, seed=SEED)
    for call_kw, match in ((dict(scheduler="dpm"), "ddim/euler/edm"),
                           (dict(strength=0.0), "strength"),
                           (dict(strength=1.5), "strength"),
                           (dict(dispatch_steps=2), "dispatch_steps")):
        for pipe in (jpipe, tp):
            with pytest.raises(ValueError, match=match):
                pipe(PROMPT, video=clip, **kw, **call_kw)
    for pipe in (jpipe, tp):
        with pytest.raises(ValueError, match="video batch 1 != prompt batch 2"):
            pipe([PROMPT, NEG], video=clip, **kw)
    # PAB: vdx and the port reject it with video
    jpab = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                 text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                 params=v2v_run["params"], pab=PABConfig())
    for pipe in (jpab, tiny_port(pab=TPABConfig())):
        with pytest.raises(ValueError, match="video2video does not compose with PAB"):
            pipe(PROMPT, video=clip, **kw)
