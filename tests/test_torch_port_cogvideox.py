"""The CogVideoX family of the port against vdx's, on the CPU in fp32 at
the tiny configs.

Modules at the block bar (2e-5, tests/test_block_parity.py:46): the
shared pieces (``rope_3d`` with a text segment, ``Attention`` with biased
q/k/v, the per-head q/k LayerNorm and RoPE, ``dynamic_cfg_schedule``),
T5Encoder over a padded id batch, CausalConv3d (edge padding, strides 2),
CausalVAEEncoder and CausalVAEDecoder, CogVideoXBlock with and without
RoPE, CogVideoXDiT with ``use_rotary`` True and False. Pyramid Attention
Broadcast on the joint attention against vdx's modules (a refresh call,
then one served from the cache). The pipeline's surface on the port: T5
offloaded against resident (the prompt cache hit, then cleared past 16
entries), ``load_pretrained`` then ``save_checkpoint`` with T5 offloaded,
and FreeU, ``context`` and ``frame_shards`` rejected with vdx's exception
types. One vdx CogVideoXPipeline program (DDIM with v-prediction,
``dynamic_cfg``, 5 frames = 2 latent frames at 64x64, the decode in
spatial tiles of 4 latent pixels, 8 decoded frames trimmed to 5) against
the port's ``__call__``.

Every leaf is random (tests/test_torch_port_latte.py's helpers): vdx
zero-initialises the adaLN linears and ``final_proj``, which would make
every block the identity. vdx runs jitted at XLA optimisation level 0.
Bars for the pipeline as tests/test_torch_port_modelscope.py: latents
after two steps within PIPE_ATOL (1e-3; the dynamic guidance stays below
6, and a v-prediction DDIM step scales the model output by at most 1),
frames within one uint8 level.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_latte import (ATOL, PIPE_ATOL, check_pab, close, pair,
                                   sub_rules)
from test_torch_port_models import _compile_o0
from vdx.core.dtypes import FP32_POLICY as JP
from vdx_torch.core import convert as TC
from vdx_torch.core.dtypes import FP32_POLICY as TP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PROMPT = "a panda playing guitar in a bamboo forest"
NEG = "bad quality, blurry"
SEED = 1234


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def test_modules_match_vdx():
    from vdx.models import cogvideox as J
    from vdx.models import t5 as J5
    from vdx.nn.attention import Attention as JA
    from vdx.nn.embeddings import rope_3d as jrope
    from vdx.schedulers.common import dynamic_cfg_schedule as jdyn
    from vdx_torch.models import cogvideox as T
    from vdx_torch.models import t5 as T5
    from vdx_torch.nn.attention import Attention as TA
    from vdx_torch.nn.embeddings import rope_3d as trope
    from vdx_torch.schedulers.common import dynamic_cfg_schedule as tdyn

    rng = np.random.default_rng(0)
    for g, n in ((6.0, 50), (7.5, 7), (1.0, 3)):
        np.testing.assert_array_equal(tdyn(g, n), jdyn(g, n))
    cfg = J.CogVideoXConfig.tiny()
    D, heads = cfg.hidden_size, cfg.num_heads
    hd = D // heads
    # RoPE tables: frames x rows x cols, 5 text rows of identity
    want = jrope(2, 3, 4, hd, text_len=5)
    got = trope(2, 3, 4, hd, text_len=5)
    for g, w in zip(got, want):
        close(g, w, 1e-6, "rope_3d")
    rope_j, rope_t = want, got

    # Attention: biased q/k/v, per-head q/k LayerNorm, RoPE
    rules = sub_rules(TC.cogvideox_dit_rules(cfg), "blocks_0/attn/",
                      "transformer_blocks.0.attn1.")
    tm = TA(D, heads, hd, policy=TP, qkv_bias=True, qk_norm=True)
    params = pair(tm, rules, 0)
    x = rng.standard_normal((2, 29, D), np.float32)
    jm = JA(D, heads, hd, qkv_bias=True, qk_norm=True, policy=JP)
    for rj, rt in ((None, None), (rope_j, rope_t)):
        with torch.no_grad():
            got = tm(torch.from_numpy(x), rope=rt)
        close(got, jm.apply(params, x, rope=rj), ATOL,
              f"Attention rope={rj is not None}")

    # T5 over a padded id batch (the tokenizer's EOS padding)
    t5 = T5.T5Encoder(T5.T5Config.tiny(), TP)
    params = pair(t5, TC.t5_encoder_rules(J5.T5Config.tiny()), 1, "t5",
                  J5.T5Config.tiny())
    ids = np.full((2, 12), 7, np.int32)
    ids[0, :5] = rng.integers(0, 512, 5)
    ids[1, :9] = rng.integers(0, 512, 9)
    jt5 = J5.T5Encoder(J5.T5Config.tiny(), policy=JP)
    with torch.no_grad():
        close(t5(torch.from_numpy(ids)),
              _compile_o0(jt5.apply, params, ids)(params, ids), ATOL, "T5Encoder")

    # CausalConv3d: edge padding, strides 2 on every axis
    cc = T.CausalConv3d(6, 8, strides=(2, 2, 2), policy=TP)
    params = pair(cc, sub_rules(TC._causal_conv_rules("c", "c"), "c/", "c."), 2)
    x = rng.standard_normal((1, 5, 7, 9, 6), np.float32)
    with torch.no_grad():
        close(cc(torch.from_numpy(x)),
              J.CausalConv3d(8, strides=(2, 2, 2), policy=JP).apply(params, x),
              ATOL, "CausalConv3d")

    # the causal VAE: encoder [1, 5, 32, 32, 3], decoder [1, 2, 4, 4, 16]
    vcfg = J.CausalVAEConfig.tiny()
    for comp, cls, jcls, shape in (
            ("vae_enc", T.CausalVAEEncoder, J.CausalVAEEncoder, (1, 5, 32, 32, 3)),
            ("vae_dec", T.CausalVAEDecoder, J.CausalVAEDecoder, (1, 2, 4, 4, 16))):
        tm = cls(T.CausalVAEConfig.tiny(), TP)
        params = pair(tm, TC._COMPONENT_RULES[comp](vcfg), 3, comp, vcfg)
        x = rng.standard_normal(shape, np.float32)
        want = _compile_o0(jcls(vcfg, policy=JP).apply, params, x)(params, x)
        with torch.no_grad():
            close(tm(torch.from_numpy(x)), want, ATOL, comp)

    # CogVideoXBlock with and without RoPE: 5 text + 2x3x4 video tokens
    vid = rng.standard_normal((2, 24, D), np.float32)
    txt = rng.standard_normal((2, 5, D), np.float32)
    c = rng.standard_normal((2, cfg.time_embed_dim), np.float32)
    tb = T.CogVideoXBlock(T.CogVideoXConfig.tiny(), TP)
    params = pair(tb, sub_rules(TC.cogvideox_dit_rules(cfg), "blocks_0/",
                                "transformer_blocks.0."), 4)
    jb = J.CogVideoXBlock(cfg, policy=JP)
    for rj, rt in ((None, None), (rope_j, rope_t)):
        with torch.no_grad():
            gv, gt = tb(*_t(vid, txt, c), rope=rt)
        wv, wt = jb.apply(params, vid, txt, c, rope=rj)
        close(gv, wv, ATOL, f"CogVideoXBlock video rope={rj is not None}")
        close(gt, wt, ATOL, f"CogVideoXBlock text rope={rj is not None}")

    # CogVideoXDiT: RoPE (the tiny default) and the 2B's sinusoidal PE
    x = rng.standard_normal((2, 2, 8, 8, 16), np.float32)
    t = np.array([700, 700], np.int32)
    states = rng.standard_normal((2, cfg.max_text_len, cfg.text_dim), np.float32)
    for rotary in (True, False):
        jc = J.CogVideoXConfig(**{**vars(cfg), "use_rotary": rotary})
        tm = T.CogVideoXDiT(T.CogVideoXConfig(**vars(jc)), TP)
        params = pair(tm, TC.cogvideox_dit_rules(jc), 5, "dit", jc)
        jm = J.CogVideoXDiT(jc, policy=JP)
        with torch.no_grad():
            close(tm(*_t(x, t, states)),
                  _compile_o0(jm.apply, params, x, t, states)(params, x, t, states),
                  ATOL, f"CogVideoXDiT use_rotary={rotary}")


def _tiny_port(**kw):
    from vdx_torch.models.cogvideox import CausalVAEConfig, CogVideoXConfig
    from vdx_torch.models.t5 import T5Config
    from vdx_torch.pipelines import CogVideoXPipeline

    return CogVideoXPipeline(dit_config=CogVideoXConfig.tiny(),
                             vae_config=CausalVAEConfig.tiny(),
                             t5_config=T5Config.tiny(), policy=TP, device="cpu",
                             **kw)


def test_pab_and_surface(tmp_path):
    from vdx.models import cogvideox as J
    from vdx.nn.freeu import FreeUConfig as JFreeU
    from vdx.pipelines import CogVideoXPipeline as JPipe
    from vdx.pipelines.context import ContextConfig as JCtx
    from vdx_torch.models import cogvideox as T
    from vdx_torch.nn.freeu import FreeUConfig
    from vdx_torch.pipelines import ContextConfig

    # PAB on the joint attention: a refresh call, then one from the cache
    rng = np.random.default_rng(1)
    cfg = J.CogVideoXConfig.tiny()
    rules = TC.cogvideox_dit_rules(cfg)
    tm = T.CogVideoXDiT(T.CogVideoXConfig.tiny(), TP)
    params = pair(tm, rules, 6, "dit", cfg)
    states = rng.standard_normal((2, cfg.max_text_len, cfg.text_dim), np.float32)
    inputs = [(rng.standard_normal((2, 2, 8, 8, 16), np.float32),
               np.array([t0, t0], np.int32), states) for t0 in (900, 880)]
    check_pab(J.CogVideoXDiT(cfg, policy=JP, pab=True), tm, params, rules,
              inputs, ({"joint": True}, {"joint": False}), "CogVideoXDiT")

    # T5 offloaded against resident; the prompt cache hit, then cleared
    resident = _tiny_port()
    resident.init_params(3)
    off = _tiny_port(offload_text_encoder=True)
    off.load_state_dicts({k: m.state_dict()
                          for k, m in resident._components().items()})
    want = resident.encode_prompt(PROMPT, NEG)
    got = off.encode_prompt(PROMPT, NEG)
    assert torch.equal(got, want) and off._t5_offloaded
    assert off.encode_prompt(PROMPT, NEG) is got  # a hit
    for i in range(17):
        off.encode_prompt(f"prompt {i}")
    assert len(off._text_cache) == 1 and off.encode_prompt(PROMPT, NEG) is not got
    # load_pretrained then save_checkpoint with T5 offloaded: complete files
    sources = {k: {n: t.clone() for n, t in m.state_dict().items()}
               for k, m in resident._components().items()}
    reports = off.load_pretrained(sources)
    assert all(not r["missing"] and not r["unused_checkpoint_keys"]
               for r in reports.values())
    assert not off._text_cache
    off.save_checkpoint(tmp_path / "ckpt")
    back = _tiny_port()
    back.load_checkpoint(tmp_path / "ckpt")
    for k, m in back._components().items():
        theirs = resident._components()[k].state_dict()
        assert all(torch.equal(t, theirs[n]) for n, t in m.state_dict().items()), k
    assert torch.equal(back.encode_prompt(PROMPT, NEG), want)

    # rejections, with vdx's exception types
    vcfg = dict(dit_config=J.CogVideoXConfig.tiny(),
                vae_config=J.CausalVAEConfig.tiny())
    for kw, jkw in (({"freeu": FreeUConfig()}, {"freeu": JFreeU()}),
                    ({"context": ContextConfig()}, {"context": JCtx()}),
                    ({"frame_shards": 2}, {"frame_shards": 2})):
        with pytest.raises(Exception) as port_err:
            _tiny_port(**kw)
        if "context" in jkw:  # vdx's CogVideoXPipeline has no such keyword
            assert port_err.type is ValueError
            assert "context windows do not apply" in str(port_err.value)
            continue
        with pytest.raises(Exception) as vdx_err:
            JPipe(**vcfg, **jkw)
        assert port_err.type is vdx_err.type, (kw, port_err, vdx_err)


@pytest.fixture(scope="module")
def cog_run():
    """One vdx CogVideoXPipeline program (DDIM v-prediction, dynamic CFG,
    2 steps, tiled and trimmed decode) on weights that the port's tiny
    pipeline carries."""
    from vdx.core.rng import as_key
    from vdx.models.cogvideox import CausalVAEConfig as JVC
    from vdx.models.cogvideox import CogVideoXConfig as JDC
    from vdx.models.t5 import T5Config as J5C
    from vdx.pipelines import CogVideoXPipeline as JPipe
    from vdx.schedulers.common import dynamic_cfg_schedule

    tp = _tiny_port()
    cfgs = {"dit": JDC.tiny(), "t5": J5C.tiny(), "vae_enc": JVC.tiny(),
            "vae_dec": JVC.tiny()}
    rules = {n: r for n, (r, _) in tp._conversion_rules().items()}
    params = {}
    for i, (name, module) in enumerate(tp._components().items()):
        params[name] = pair(module, rules[name], 10 + i, name, cfgs[name])
    tp._has_params = True
    jp = JPipe(dit_config=JDC.tiny(), vae_config=JVC.tiny(), t5_config=J5C.tiny(),
               policy=JP, params=params)
    assert jp.scheduler == tp.scheduler == "ddim"
    assert {k: dataclasses.asdict(v) for k, v in jp.sampler_configs.items()} \
        == {k: dataclasses.asdict(v) for k, v in tp.sampler_configs.items()}
    cond = jp.encode_prompt(PROMPT, NEG)
    opts = {"trim": 5, "spatial_tile": 4, "tile_overlap": 8}
    prog = jp._get_program(scheduler="ddim", guidance=True,
                           latent_shape=(1, 2, 8, 8, 16), num_steps=2, chunk=2,
                           decode_opts=opts)
    args = (jp.params, as_key(SEED), cond,
            jnp.float32(dynamic_cfg_schedule(6.0, 2)), jp._get_tables("ddim", 2))
    latents, frames = prog.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return dict(tp=tp, cond=np.array(cond), latents=np.array(latents),
                frames=np.array(frames)[0])


def test_pipeline_matches_vdx(cog_run):
    tp = cog_run["tp"]
    np.testing.assert_allclose(tp.encode_prompt(PROMPT, NEG).numpy(),
                               cog_run["cond"], atol=ATOL)
    out = tp(PROMPT, negative_prompt=NEG, num_frames=5, height=64, width=64,
             num_inference_steps=2, guidance_scale=6.0, dynamic_cfg=True,
             seed=SEED, decode_spatial_tile=4, output_type="np")
    close(out.latents, cog_run["latents"], PIPE_ATOL, "latents after 2 steps")
    got, want = out.frames[0], cog_run["frames"]
    assert got.shape == want.shape == (5, 64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= 1 and want.std() > 0
