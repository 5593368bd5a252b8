"""The ModelScope family of the port against vdx's, on the CPU in fp32 at
the tiny configs: TemporalConv and UNet3D at the block bar (2e-5,
tests/test_block_parity.py:46), UNet3D plain and then with FreeU over a
Pyramid Attention Broadcast refresh call and a cached one (outputs and
caches), then one vdx TextToVideoMSPipeline
program (2 DDIM steps, 4 frames at 64x64, XLA optimisation level 0)
against the port's ``__call__`` from the same seed.

Every leaf is random: numpy weights with a seed laid out by the port
module's state_dict (fan-in-scaled kernels, norm scales 1 + 0.1 n,
biases and the rest 0.1 n), carried into vdx's tree by vdx's rules and
back into the port through vdx_torch.core.convert (params_from_jax for a
whole component, state_from_rules for a block). No zero-initialised leaf
hides a branch: TemporalConv's last conv is random here (vdx initialises
it to zeros).

Bars for the pipeline: the port draws vdx's noise within 4 fp32 ulps
(tests/test_torch_port_rng.py); one UNet call agrees to ~2e-5, the CFG
combine at 7.5 scales an eps difference by up to 16 and a DDIM step by
up to 3, so latents after two steps sit within PIPE_ATOL (1e-3, the
AnimateDiff pipeline test's bar; measured 2.0e-4); frames within one
uint8 level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_models import _compile_o0
from vdx.core import convert as VC
from vdx.core.dtypes import FP32_POLICY as JP
from vdx_torch.core import convert as TC
from vdx_torch.core.dtypes import FP32_POLICY as TP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ATOL = 2e-5
# latents after two DDIM steps at CFG 7.5 (see the docstring), as
# tests/test_torch_port_pipeline.py's STEP_ATOL: one UNet call's ~2e-5
# times the CFG factor (up to 16) times the DDIM step's (up to 3).
# Measured 2.0e-4 on latents up to 11 (7.8e-5 with the frame convs as
# Conv3d: the sums' order moves it)
PIPE_ATOL = 1e-3
PROMPT = "a corgi walking on the beach, sunset lighting, high quality"
NEG = "bad quality, blurry, distorted"
SEED = 1234


def random_state(module, seed):
    """Seeded numpy weights for every entry of ``module``'s state_dict:
    fan-in-scaled kernels, norm scales near 1, every other leaf (biases,
    mix factors, embeddings of one dim) 0.1 n."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if v.dim() >= 2:
            w = rng.standard_normal(v.shape) / np.sqrt(v[0].numel())
        elif k.endswith("weight"):
            w = 1.0 + 0.1 * rng.standard_normal(v.shape)
        else:
            w = 0.1 * rng.standard_normal(v.shape)
        sd[k] = w.astype(np.float32)
    return sd


def vdx_tree(sd, rules):
    """The port's numpy state in vdx's tree, by ``rules``."""
    return VC.unflatten_params({p: tr(sd[hf]) for p, (hf, tr) in rules.items()
                                if hf in sd})


def flat(params):
    return {k: np.asarray(v) for k, v in VC.flatten_params(params).items()}


def sub_rules(fn):
    """A block's rules with the prefixes dropped: vdx path -> torch key of
    the block on its own."""
    return {k[2:]: (v[2:], tr) for k, (v, tr) in fn("P", "H").items()}


def block_pair(tmod, rules, seed):
    """Random weights into the port block (through the port's converter
    run backwards over ``rules``) and vdx's tree of them."""
    params = vdx_tree(random_state(tmod, seed), rules)
    tmod.load_state_dict(TC.state_from_rules(flat(params), rules), strict=True)
    return params


def whole_pair(tmod, component, jcfg, rules, seed):
    """Random weights for a whole component: vdx's tree by vdx's rules, the
    port's module filled through params_from_jax."""
    params = vdx_tree(random_state(tmod, seed), rules)
    tmod.load_state_dict(TC.params_from_jax(flat(params), component, jcfg),
                         strict=True)
    return params


# Pyramid Attention Broadcast flags of two UNet calls: every attention
# computes and fills the cache, then spatial and temporal attention are
# served from it while cross-attention computes again
PAB_STEPS = ({"spatial": True, "cross": True, "temporal": True},
             {"spatial": False, "cross": True, "temporal": False})


def check_pab_freeu(jmod, tm, params, rules, inputs, what):
    """vdx's UNet ``jmod`` (built with ``pab`` and FreeU) and the port's
    ``tm`` (the same weights and FreeU) over PAB_STEPS, one input each:
    both outputs and the cache after each call at the block bar, with the
    port's cache keys (module names) mapped onto vdx's paths by ``rules``.
    vdx's side is one program with the flags as inputs, run once a step;
    its cache starts at zeros of the port's first cache's shapes."""
    names = {hf[:-len(".to_q.weight")]: p[:-len("to_q/kernel")] + "out"
             for p, (hf, _) in rules.items() if hf.endswith(".to_q.weight")}

    def apply(variables, flags, *args):
        return jmod.apply(variables, *args, pab_refresh=flags,
                          mutable=["pab_cache"])

    cache = prog = None
    for step, (flags, args) in enumerate(zip(PAB_STEPS, inputs)):
        with torch.no_grad():
            got, cache = tm(*(torch.from_numpy(a) for a in args),
                            pab_refresh=flags, pab_cache=cache)
        jflags = {k: np.bool_(v) for k, v in flags.items()}
        if prog is None:
            zeros = VC.unflatten_params({names[k]: np.zeros(v.shape, np.float32)
                                         for k, v in cache.items()})["params"]
            variables = {"params": params["params"], "pab_cache": zeros}
            prog = _compile_o0(apply, variables, jflags, *args)
        want, mut = prog(variables, jflags, *args)
        close(got, want, ATOL, f"{what} PAB step {step}")
        jcache = flat(mut["pab_cache"])
        assert sorted(names[k] for k in cache) == sorted(jcache), what
        for k, v in cache.items():
            close(v, jcache[names[k]], ATOL, f"{what} PAB cache {k}")
        variables = {"params": params["params"], "pab_cache": mut["pab_cache"]}
    # the cached call is not the plain one: the bar sees the broadcast
    with torch.no_grad():
        plain = tm(*(torch.from_numpy(a) for a in inputs[-1]))
    assert (plain - got).abs().max() > 100 * ATOL, what


def close(got, want, atol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, (what, err)
    return err


def _check_modules():
    from vdx.models import unet3d as J
    from vdx_torch.models import unet3d as T

    rng = np.random.default_rng(0)
    # TemporalConv: 32 channels (32 groups) and 24 (8 groups), 4 frames
    for C in (32, 24):
        tm = T.TemporalConv(C, TP)
        params = block_pair(tm, sub_rules(TC._temporal_conv_rules), C)
        x = rng.standard_normal((8, 4, 6, C), np.float32)
        want = J.TemporalConv(policy=JP).apply(params, jnp.asarray(x), 4)
        with torch.no_grad():
            close(tm(torch.from_numpy(x), 4), want, ATOL, f"TemporalConv {C}")

    cfg = J.UNet3DConfig.tiny()
    tm = T.UNet3D(T.UNet3DConfig.tiny(), TP)
    params = whole_pair(tm, "unet", cfg, VC.unet3d_rules(cfg), 1)
    x = rng.standard_normal((2, 4, 8, 8, 4), np.float32)
    ctx = rng.standard_normal((2, 7, 64), np.float32)
    t = np.array([10, 10], np.int32)
    want = _compile_o0(J.UNet3D(cfg, policy=JP).apply, params, x, t, ctx)(
        params, x, t, ctx)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, t, ctx)))
    close(got, want, ATOL, "UNet3D")
    # PAB and FreeU on two levels at 16x16, attention in level 0 and the
    # mid block (FreeU's box filter inside the 8x8 and 16x16 up stages;
    # a shorter compile than the tiny UNet's): a refresh call, then one
    # served from the cache
    from vdx.nn.freeu import FreeUConfig as JFreeU
    from vdx_torch.nn.freeu import FreeUConfig as TFreeU

    two = dict(block_out_channels=(32, 64), down_block_has_attn=(True, False))
    pcfg = dataclasses.replace(cfg, **two)
    tm = T.UNet3D(dataclasses.replace(T.UNet3DConfig.tiny(), **two), TP,
                  freeu=TFreeU())
    rules = VC.unet3d_rules(pcfg)
    params = whole_pair(tm, "unet", pcfg, rules, 2)
    inputs = [(rng.standard_normal((2, 4, 16, 16, 4), np.float32),
               np.array([t0, t0], np.int32), ctx) for t0 in (500, 480)]
    check_pab_freeu(J.UNet3D(pcfg, policy=JP, pab=True, freeu=JFreeU()), tm,
                    params, rules, inputs, "UNet3D")
    # the text config: ViT-H widths, quick-GELU
    from vdx.pipelines.text_to_video_ms import vit_h_text_config as JV
    from vdx_torch.pipelines.text_to_video_ms import vit_h_text_config as TV

    assert {k: getattr(TV(), k) for k in vars(JV())} == vars(JV())
    # heads C // 64 with head dim 64 at every level of the published config
    ms = T.UNet3DConfig.modelscope()
    assert [T._heads(ms, c) for c in ms.block_out_channels] == [5, 10, 20, 20]


@pytest.fixture(scope="module")
def ms_run():
    """One vdx TextToVideoMSPipeline program (DDIM, 2 steps) on weights
    that the port's tiny pipeline carries."""
    from vdx.models.clip_text import CLIPTextConfig as JCC
    from vdx.models.unet3d import UNet3DConfig as JUC
    from vdx.models.vae import VAEConfig as JVC
    from vdx.pipelines import TextToVideoMSPipeline as JPipe
    from vdx.core.rng import as_key
    from vdx_torch.models.clip_text import CLIPTextConfig as TCC
    from vdx_torch.models.unet3d import UNet3DConfig as TUC
    from vdx_torch.models.vae import VAEConfig as TVC
    from vdx_torch.pipelines import TextToVideoMSPipeline as TPipe

    tp = TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
               text_config=TCC.tiny(), policy=TP, device="cpu")
    rules = {"unet": VC.unet3d_rules(JUC.tiny()), "vae": VC.vae_rules(JVC.tiny()),
             "text": VC.clip_text_rules(JCC.tiny())}
    cfgs = {"unet": JUC.tiny(), "vae": JVC.tiny(), "text": JCC.tiny()}
    params = {}
    for i, (name, module) in enumerate(tp._components().items()):
        params[name] = whole_pair(module, name, cfgs[name], rules[name], 10 + i)
    tp._has_params = True
    jp = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
               text_config=JCC.tiny(), policy=JP, params=params)
    assert jp.scheduler == tp.scheduler == "ddim"
    shape = (1, 4, 8, 8, 4)
    cond = jp.encode_prompt(PROMPT, NEG)
    prog = jp._get_program(scheduler="ddim", guidance=True, latent_shape=shape,
                           num_steps=2, chunk=4)
    args = (jp.params, as_key(SEED), cond, jnp.float32(7.5),
            jp._get_tables("ddim", 2))
    latents, frames = prog.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return dict(tp=tp, cond=np.array(cond), latents=np.array(latents),
                frames=np.array(frames)[0])


def _check_pipeline(run):
    tp = run["tp"]
    np.testing.assert_allclose(tp.encode_prompt(PROMPT, NEG).numpy(),
                               run["cond"], atol=ATOL)
    kw = dict(negative_prompt=NEG, num_frames=4, height=64, width=64,
              num_inference_steps=2, guidance_scale=7.5, seed=SEED)
    out = tp(PROMPT, output_type="np", **kw)
    close(out.latents, run["latents"], PIPE_ATOL, "latents after 2 DDIM steps")
    got, want = out.frames[0], run["frames"]
    assert got.shape == want.shape == (4, 64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= 1 and want.std() > 0
    # the family base's options on UNet3D: PAB at interval 1 everywhere
    # and FreeU-free defaults reproduce the plain call
    from vdx_torch.pipelines import PABConfig, TextToVideoMSPipeline

    pab = TextToVideoMSPipeline(
        unet_config=tp.unet.config, vae_config=tp.vae.config,
        text_config=tp.text_encoder.config, policy=TP, device="cpu",
        pab=PABConfig(spatial_interval=1, temporal_interval=1, cross_interval=1))
    pab.unet, pab.vae, pab.text_encoder = tp.unet, tp.vae, tp.text_encoder
    assert torch.equal(pab(PROMPT, output_type="latent", **kw).latents,
                       out.latents)


def test_modules_match_vdx():
    _check_modules()


def test_pipeline_matches_vdx(ms_run):
    _check_pipeline(ms_run)
