"""The Latte family of the port against vdx's, on the CPU in fp32 at the
tiny configs.

Modules at the block bar (2e-5, tests/test_block_parity.py:46): the tanh
GELU feed-forward, DiTBlock with and without cross-attention, LatteDiT,
and LatteDiT loaded from a diffusers-keyed state_dict (the global
``adaln_single.linear`` plus a ``scale_shift_table`` a block) through the
port's ``LattePipeline.load_pretrained`` against vdx's
``convert_checkpoint`` of the same dict. Pyramid Attention Broadcast
against vdx's modules: a refresh call and a call served from the cache
(spatial and temporal self-attention cached, cross-attention computed),
outputs and every cached attention output. One vdx LattePipeline program
(2 DDIM steps, 4 frames at 64x64) against the port's ``__call__``, then
the family's surface on the port: FreeU rejected with vdx's ValueError,
video2video, a LoRA adapter loaded and unloaded.

Every leaf is random (numpy weights from a seed laid out by the port
module's state_dict), so no zero-initialised leaf of vdx's hides a
branch: with vdx's init the adaLN gates and ``final_proj`` are zero and
every block is the identity. vdx runs jitted at XLA optimisation level 0.

Bars for the pipeline, as tests/test_torch_port_modelscope.py: latents
after two DDIM steps at CFG 7.5 within PIPE_ATOL (1e-3), frames within
one uint8 level.
"""

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
# latents after two DDIM steps at CFG 7.5: one denoiser call's ~2e-5 times
# the CFG factor (up to 16) times the DDIM step's (up to 3), as
# tests/test_torch_port_modelscope.py
PIPE_ATOL = 1e-3
PROMPT = "birds flying across a blue sky, nature documentary"
NEG = "bad quality, blurry, distorted"
SEED = 1234
# Pyramid Attention Broadcast flags of two calls: every attention computes
# and fills the cache, then the self-attentions are served from it while
# cross-attention computes again
LATTE_PAB = ({"spatial": True, "cross": True, "temporal": True},
             {"spatial": False, "cross": True, "temporal": False})


# ----------------------------------------------------------------------
# helpers (tests/test_torch_port_cogvideox.py uses them too)
# ----------------------------------------------------------------------
def random_state(module, seed):
    """Seeded numpy weights for every entry of ``module``'s state_dict:
    fan-in-scaled kernels and tables, norm scales near 1, every other leaf
    0.1 n."""
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


def flat(params):
    return {k: np.asarray(v) for k, v in VC.flatten_params(params).items()}


def sub_rules(rules, ours: str, theirs: str):
    """The rules under vdx prefix ``ours`` and port prefix ``theirs``, both
    prefixes dropped: a block's rules on its own."""
    return {p[len(ours):]: (hf[len(theirs):], tr) for p, (hf, tr) in rules.items()
            if p.startswith(ours) and hf.startswith(theirs)}


def pair(tmod, rules, seed, component=None, config=None):
    """Random weights for the port module and vdx's tree of them: the
    numpy state into vdx's layout by ``rules``, then back into the port
    through vdx_torch.core.convert (``params_from_jax`` for a whole
    component, ``state_from_rules`` for a block)."""
    sd = random_state(tmod, seed)
    params = VC.unflatten_params({p: tr(sd[hf]) for p, (hf, tr) in rules.items()
                                  if hf in sd})
    state = (TC.params_from_jax(flat(params), component, config) if component
             else TC.state_from_rules(flat(params), rules))
    tmod.load_state_dict(state, strict=True)
    return params


def close(got, want, atol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, (what, err)
    return err


def check_pab(jmod, tm, params, rules, inputs, steps, what):
    """vdx's denoiser ``jmod`` (built with ``pab``) and the port's ``tm``
    (the same weights) over ``steps`` (refresh flags a call), one input
    each: outputs and every cached attention output at the block bar, the
    port's cache keys (module names) mapped onto vdx's paths by ``rules``.
    vdx's side is one program with the flags as inputs; its cache starts
    at zeros of the port's first cache's shapes. The last call, served
    from the cache, differs from the plain call by more than 100 bars."""
    names = {hf[:-len(".to_q.weight")]: p[:-len("to_q/kernel")] + "out"
             for p, (hf, _) in rules.items() if hf.endswith(".to_q.weight")}

    def apply(variables, flags, *args):
        return jmod.apply(variables, *args, pab_refresh=flags,
                          mutable=["pab_cache"])

    cache = prog = None
    for step, (flags, args) in enumerate(zip(steps, inputs)):
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
    with torch.no_grad():
        plain = tm(*(torch.from_numpy(a) for a in inputs[-1]))
    assert (plain - got).abs().max() > 100 * ATOL, what


# ----------------------------------------------------------------------
def _diffusers_latte_state(sd, cfg, seed):
    """A diffusers-keyed Latte state_dict from the port's numpy state: the
    per-block adaLN replaced by one global ``adaln_single.linear`` and a
    ``scale_shift_table`` [6, D] a block, all random."""
    rng = np.random.default_rng(seed)
    D = cfg.hidden_size
    sd = {k: v for k, v in sd.items() if ".adaln." not in k}
    sd["adaln_single.linear.weight"] = (
        rng.standard_normal((6 * D, D)) / np.sqrt(D)).astype(np.float32)
    sd["adaln_single.linear.bias"] = 0.1 * rng.standard_normal(6 * D).astype(
        np.float32)
    for i in range(cfg.depth):
        hp = (f"transformer_blocks.{i // 2}" if i % 2 == 0
              else f"temporal_transformer_blocks.{i // 2}")
        sd[f"{hp}.scale_shift_table"] = (
            0.1 * rng.standard_normal((6, D))).astype(np.float32)
    return sd


def test_modules_match_vdx():
    from vdx.models import dit as J
    from vdx.nn.attention import GELUFeedForward as JFF
    from vdx_torch.models import dit as T
    from vdx_torch.nn.attention import GELUFeedForward as TFF
    from vdx_torch.pipelines import LattePipeline

    rng = np.random.default_rng(0)
    cfg = J.LatteConfig.tiny()
    D = cfg.hidden_size
    rules = TC.latte_dit_rules(cfg)

    # the tanh-GELU feed-forward (net.0.proj, net.2)
    tm = TFF(D, 4, TP)
    params = pair(tm, sub_rules(rules, "blocks_0/mlp/", "transformer_blocks.0.ff."),
                  0)
    x = rng.standard_normal((3, 5, D), np.float32)
    with torch.no_grad():
        close(tm(torch.from_numpy(x)), JFF(D, policy=JP).apply(params, x), ATOL,
              "GELUFeedForward")

    # DiTBlock: spatial (cross-attention to 7 text tokens) and temporal
    c = rng.standard_normal((6, D), np.float32)
    ctx = rng.standard_normal((6, 7, cfg.cross_attention_dim), np.float32)
    for cross, (ours, theirs) in ((True, ("blocks_0/", "transformer_blocks.0.")),
                                  (False, ("blocks_1/",
                                           "temporal_transformer_blocks.0."))):
        tm = T.DiTBlock(T.LatteConfig.tiny(), cross, TP)
        params = pair(tm, sub_rules(rules, ours, theirs), 1 + cross)
        x = rng.standard_normal((6, 9, D), np.float32)
        args = (x, c, ctx) if cross else (x, c)
        want = J.DiTBlock(cfg, use_cross_attn=cross, policy=JP).apply(params, *args)
        with torch.no_grad():
            got = tm(*(torch.from_numpy(a) for a in args))
        close(got, want, ATOL, f"DiTBlock cross={cross}")

    # LatteDiT, then the same program on a diffusers-keyed checkpoint
    tm = T.LatteDiT(T.LatteConfig.tiny(), TP)
    params = pair(tm, rules, 3, "unet", cfg)
    x = rng.standard_normal((2, 3, 8, 8, 4), np.float32)
    t = np.array([500, 500], np.int32)
    ctx = rng.standard_normal((2, 7, cfg.cross_attention_dim), np.float32)
    jm = J.LatteDiT(cfg, policy=JP)
    prog = _compile_o0(jm.apply, params, x, t, ctx)
    with torch.no_grad():
        close(tm(*(torch.from_numpy(a) for a in (x, t, ctx))),
              prog(params, x, t, ctx), ATOL, "LatteDiT")

    sd = _diffusers_latte_state(random_state(tm, 4), cfg, 5)
    jparams, report = VC.convert_checkpoint(
        sd, jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, t, ctx),
        VC.latte_dit_rules(cfg))
    assert not report["missing"] and not report["unused_checkpoint_keys"]
    pipe = LattePipeline(unet_config=T.LatteConfig.tiny(), policy=TP,
                         device="cpu")
    got_report = pipe.load_pretrained(
        {"unet": {k: torch.from_numpy(v) for k, v in sd.items()}}, strict=False)
    assert got_report["unet"] == {"missing": [], "shape_errors": [],
                                  "unused_checkpoint_keys": []}
    with torch.no_grad():
        got = pipe.unet(*(torch.from_numpy(a) for a in (x, t, ctx)))
    close(got, prog(jparams, x, t, ctx), ATOL, "LatteDiT from a diffusers dict")


def test_pab_matches_vdx():
    """LatteDiT under PAB (spatial, temporal and cross sites) against
    vdx's, 16x16 latents of 3 frames: a refresh call, then one served from
    the cache."""
    from vdx.models import dit as J
    from vdx_torch.models import dit as T

    rng = np.random.default_rng(1)
    cfg = J.LatteConfig.tiny()
    rules = TC.latte_dit_rules(cfg)
    tm = T.LatteDiT(T.LatteConfig.tiny(), TP)
    params = pair(tm, rules, 6, "unet", cfg)
    ctx = rng.standard_normal((2, 7, cfg.cross_attention_dim), np.float32)
    inputs = [(rng.standard_normal((2, 3, 16, 16, 4), np.float32),
               np.array([t0, t0], np.int32), ctx) for t0 in (500, 480)]
    check_pab(J.LatteDiT(cfg, policy=JP, pab=True), tm, params, rules, inputs,
              LATTE_PAB, "LatteDiT")


@pytest.fixture(scope="module")
def latte_run():
    """One vdx LattePipeline program (DDIM, 2 steps) on weights that the
    port's tiny pipeline carries."""
    from vdx.core.rng import as_key
    from vdx.models.clip_text import CLIPTextConfig as JCC
    from vdx.models.dit import LatteConfig as JLC
    from vdx.models.vae import VAEConfig as JVC
    from vdx.pipelines import LattePipeline as JPipe
    from vdx_torch.models.clip_text import CLIPTextConfig as TCC
    from vdx_torch.models.dit import LatteConfig as TLC
    from vdx_torch.models.vae import VAEConfig as TVC
    from vdx_torch.pipelines import LattePipeline as TPipe

    tp = TPipe(unet_config=TLC.tiny(), vae_config=TVC.tiny(),
               text_config=TCC.tiny(), policy=TP, device="cpu")
    cfgs = {"unet": JLC.tiny(), "vae": JVC.tiny(), "text": JCC.tiny()}
    rules = {n: r for n, (r, _) in tp._conversion_rules().items()}
    params = {}
    for i, (name, module) in enumerate(tp._components().items()):
        params[name] = pair(module, rules[name], 10 + i, name, cfgs[name])
    tp._has_params = True
    jp = JPipe(unet_config=JLC.tiny(), vae_config=JVC.tiny(),
               text_config=JCC.tiny(), policy=JP, params=params)
    assert jp.scheduler == tp.scheduler == "ddim"
    cond = jp.encode_prompt(PROMPT, NEG)
    prog = jp._get_program(scheduler="ddim", guidance=True,
                           latent_shape=(1, 4, 8, 8, 4), num_steps=2, chunk=4)
    args = (jp.params, as_key(SEED), cond, jnp.float32(7.5),
            jp._get_tables("ddim", 2))
    latents, frames = prog.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return dict(tp=tp, cond=np.array(cond), latents=np.array(latents),
                frames=np.array(frames)[0])


def test_pipeline_matches_vdx(latte_run):
    from vdx_torch.core.lora import init_lora
    from vdx_torch.nn.freeu import FreeUConfig
    from vdx_torch.pipelines import LattePipeline

    tp = latte_run["tp"]
    np.testing.assert_allclose(tp.encode_prompt(PROMPT, NEG).numpy(),
                               latte_run["cond"], atol=ATOL)
    kw = dict(negative_prompt=NEG, num_frames=4, height=64, width=64,
              num_inference_steps=2, guidance_scale=7.5, seed=SEED)
    out = tp(PROMPT, output_type="np", **kw)
    close(out.latents, latte_run["latents"], PIPE_ATOL,
          "latents after 2 DDIM steps")
    got, want = out.frames[0], latte_run["frames"]
    assert got.shape == want.shape == (4, 64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= 1 and want.std() > 0

    # the family's surface: FreeU rejected as vdx, video2video, LoRA
    with pytest.raises(ValueError, match="FreeU"):
        LattePipeline(unet_config=tp.unet.config, freeu=FreeUConfig(),
                      device="cpu")
    clip = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3), np.uint8)
    v2v = tp(PROMPT, video=clip, strength=0.5, output_type="np", **kw).frames[0]
    assert v2v.shape == (4, 64, 64, 3) and not np.array_equal(v2v, got)
    lat = dict(kw, output_type="latent")
    base = tp(PROMPT, **lat).latents
    tree = init_lora(tp.unet.state_dict(), rank=2,
                     rules=tp._conversion_rules()["unet"][0])
    rng = np.random.default_rng(5)
    tree = {k: {"a": v["a"], "b": torch.from_numpy(
        0.1 * rng.standard_normal(tuple(v["b"].shape)).astype(np.float32))}
        for k, v in tree.items()}
    assert any(".temporal_transformer_blocks." in "." + k for k in tree)
    tp.load_lora(tree)
    assert not torch.equal(tp(PROMPT, **lat).latents, base)
    tp.unload_lora()
    assert torch.equal(tp(PROMPT, **lat).latents, base)
