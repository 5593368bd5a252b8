"""The SVD family of the port against vdx's, on the CPU in fp32 at the tiny
configs:

* blocks and models at the block bar (2e-5, tests/test_block_parity.py:46):
  AlphaBlender, SpatioTemporalResBlock, TransformerSpatioTemporal,
  UNetSpatioTemporal (plain, then with FreeU over a Pyramid Attention
  Broadcast refresh call and a cached one), CLIPVisionModel,
  TemporalDecoder, and
  decode_spatial_tiled (a tile smaller than the plane, vdx's blend
  against the port's over the same per-tile decode);
* the resizes: the vision resize against ``jax.image.resize(...,
  "bilinear")`` (antialiased) at 576x1024 -> 224 and at the tiny size,
  within RESIZE_ATOL; the service's resize against Pillow's BILINEAR,
  bit for bit;
* one vdx SVDImg2VidPipeline program (2 EDM steps, 4 frames at 64x64,
  decode_chunk 2, noise_aug 0.1, per-frame guidance 1.0 -> 3.0, XLA
  optimisation level 0) against the port's ``__call__`` from the same
  seed: latents within PIPE_ATOL (1e-3, see there: the first step from
  sigma 700 cancels latents of magnitude ~2800), frames within one uint8
  level.

Weights: every leaf random, as tests/test_torch_port_modelscope.py (the
zero-initialised leaves of vdx's init, SpatioTemporalResBlock's tconv2 and
the mix factors' constant, are random here, so every branch shows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_models import _compile_o0
from test_torch_port_modelscope import (ATOL, block_pair, check_pab_freeu,
                                        close, flat, random_state, sub_rules,
                                        vdx_tree, whole_pair)
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


# the resize sums fp32 products in another order (two einsums here, one
# three-operand einsum in jax): measured 2.4e-7 on [0, 1] pixels
RESIZE_ATOL = 1e-6
# latents after two EDM steps: SVD's sigma_max is 700, so the first
# Euler step x + (sigma' - sigma) d cancels two fp32 terms of magnitude
# ~700 * |noise| (up to ~2800, an ulp of 2.4e-4) into O(1) latents; the
# two sides round those terms in another order. Measured 2.5e-4 (2.5e-4
# with vdx's noise fed in, so not the noise's 4 ulps); the bar is 4 ulps
# at 2800. The other checks at the stated bars.
PIPE_ATOL = 1e-3
SEED = 77


def _check_blocks():
    from vdx.models import svd_unet as J
    from vdx_torch.models import svd_unet as T

    rng = np.random.default_rng(0)
    # AlphaBlender alone: sigmoid(mix) in fp32
    a, b = (rng.standard_normal((3, 5), np.float32) for _ in range(2))
    mix = np.float32([0.3])
    tm = T.AlphaBlender()
    tm.load_state_dict({"mix_factor": torch.from_numpy(mix)})
    want = J.AlphaBlender().apply({"params": {"mix_factor": mix}}, a, b)
    with torch.no_grad():
        close(tm(torch.from_numpy(a), torch.from_numpy(b)), want, 1e-6,
              "AlphaBlender")

    F_ = 4
    temb = rng.standard_normal((2 * F_, 128), np.float32)
    # SpatioTemporalResBlock: 32 -> 64 channels (a shortcut conv), and 64
    for cin, cout in ((32, 64), (64, 64)):
        tm = T.SpatioTemporalResBlock(cin, cout, 128, TP)
        params = block_pair(tm, sub_rules(TC._svd_res_rules), cout)
        x = rng.standard_normal((2 * F_, 6, 6, cin), np.float32)
        want = J.SpatioTemporalResBlock(cout, policy=JP).apply(
            params, jnp.asarray(x), jnp.asarray(temb), F_)
        with torch.no_grad():
            close(tm(torch.from_numpy(x), torch.from_numpy(temb), F_), want,
                  ATOL, f"SpatioTemporalResBlock {cin}->{cout}")
    # TransformerSpatioTemporal with image-embedding cross-attention
    tm = T.TransformerSpatioTemporal(32, 2, 16, 48, TP)
    params = block_pair(tm, sub_rules(TC._svd_attn_rules), 5)
    x = rng.standard_normal((2 * F_, 4, 5, 32), np.float32)
    ctx = rng.standard_normal((2 * F_, 1, 48), np.float32)
    want = J.TransformerSpatioTemporal(2, 16, 48, policy=JP).apply(
        params, jnp.asarray(x), jnp.asarray(ctx), F_)
    with torch.no_grad():
        close(tm(torch.from_numpy(x), torch.from_numpy(ctx), F_), want, ATOL,
              "TransformerSpatioTemporal")


def _check_models():
    from vdx.models import clip_vision as JV
    from vdx.models import svd_unet as J
    from vdx.models import vae as JVAE
    from vdx_torch.models import clip_vision as TV
    from vdx_torch.models import svd_unet as T
    from vdx_torch.models import vae as TVAE

    rng = np.random.default_rng(1)
    cfg = J.SVDUNetConfig.tiny()
    tm = T.UNetSpatioTemporal(T.SVDUNetConfig.tiny(), TP)
    params = whole_pair(tm, "unet", cfg, VC.svd_unet_rules(cfg), 2)
    x = rng.standard_normal((2, 4, 8, 8, 8), np.float32)
    t = np.float32([0.6, 0.6])
    emb = rng.standard_normal((2, 1, 64), np.float32)
    aids = np.float32([[6, 127, 0.1], [6, 127, 0.1]])
    want = _compile_o0(J.UNetSpatioTemporal(cfg, policy=JP).apply, params, x,
                       t, emb, aids)(params, x, t, emb, aids)
    with torch.no_grad():
        close(tm(*(torch.from_numpy(a) for a in (x, t, emb, aids))), want,
              ATOL, "UNetSpatioTemporal")
    # PAB and FreeU on two levels at 16x16, as UNet3D's case
    from vdx.nn.freeu import FreeUConfig as JFreeU
    from vdx_torch.nn.freeu import FreeUConfig as TFreeU

    two = dict(block_out_channels=(32, 64), down_block_has_attn=(True, False))
    pcfg = dataclasses.replace(cfg, **two)
    tm = T.UNetSpatioTemporal(
        dataclasses.replace(T.SVDUNetConfig.tiny(), **two), TP, freeu=TFreeU())
    rules = VC.svd_unet_rules(pcfg)
    params = whole_pair(tm, "unet", pcfg, rules, 3)
    inputs = [(rng.standard_normal((2, 4, 16, 16, 8), np.float32),
               np.float32([t0, t0]), emb, aids) for t0 in (0.6, 0.55)]
    check_pab_freeu(J.UNetSpatioTemporal(pcfg, policy=JP, pab=True,
                                         freeu=JFreeU()),
                    tm, params, rules, inputs, "UNetSpatioTemporal")

    vcfg = JV.CLIPVisionConfig.tiny()
    tm = TV.CLIPVisionModel(TV.CLIPVisionConfig.tiny(), TP)
    params = whole_pair(tm, "vision", vcfg, VC.clip_vision_rules(vcfg), 3)
    pix = rng.random((2, 32, 32, 3), np.float32)
    want = JV.CLIPVisionModel(vcfg, policy=JP).apply(params, pix)
    with torch.no_grad():
        close(tm(torch.from_numpy(pix)), want, ATOL, "CLIPVisionModel")

    dcfg = JVAE.VAEConfig.tiny()
    tm = TVAE.TemporalDecoder(TVAE.VAEConfig.tiny(), TP)
    params = whole_pair(tm, "tdec", dcfg, VC.temporal_decoder_rules(dcfg), 4)
    z = rng.standard_normal((4, 6, 5, 4), np.float32)
    want = _compile_o0(lambda p, zz: JVAE.TemporalDecoder(dcfg, policy=JP).apply(
        p, zz, 2), params, z)(params, z)
    with torch.no_grad():
        close(tm(torch.from_numpy(z), 2), want, ATOL, "TemporalDecoder")

    # decode_spatial_tiled: vdx's windows, ramps and canvas against the
    # port's over one per-tile decode (a nonlinear 8x upsample); tiles of
    # 4 at overlap 2 on a 9 x 7 plane, one tile spanning an axis, and an
    # overlap past the tile
    def jdec(zz):
        return jnp.repeat(jnp.repeat(jnp.tanh(zz[..., :3]), 8, 1), 8, 2)

    def tdec(zz):
        return torch.tanh(zz[..., :3]).repeat_interleave(8, 1).repeat_interleave(8, 2)

    lat = rng.standard_normal((2, 9, 7, 4), np.float32)
    for tile, overlap in ((4, 2), (7, 3), (5, 8)):
        want = JVAE.decode_spatial_tiled(jdec, jnp.asarray(lat), 8, tile=tile,
                                         overlap=overlap)
        got = TVAE.decode_spatial_tiled(tdec, torch.from_numpy(lat), 8,
                                        tile=tile, overlap=overlap)
        close(got, want, 1e-6, f"decode_spatial_tiled tile {tile}")


def _check_resizes():
    from PIL import Image

    from vdx.pipelines.svd import _resize_to_vision
    from vdx_torch.models.clip_vision import CLIPVisionConfig
    from vdx_torch.ops.resize import resize_bilinear_u8
    from vdx_torch.pipelines.svd import resize_to_vision

    rng = np.random.default_rng(2)
    for (h, w), cfg in (((576, 1024), CLIPVisionConfig.vit_h()),
                        ((64, 64), CLIPVisionConfig.tiny()),
                        ((24, 40), CLIPVisionConfig.tiny())):
        img = rng.random((1, h, w, 3), np.float32) * 2.2 - 1.1  # clipped too
        want = _resize_to_vision(jnp.asarray(img), cfg)
        close(resize_to_vision(torch.from_numpy(img), cfg), want, RESIZE_ATOL,
              f"vision resize {h}x{w}")
    # Img2VidService's resize: Pillow's BILINEAR (antialiased when it
    # downscales) bit for bit, down, up and mixed
    for (h, w), (H, W) in (((97, 131), (64, 48)), ((30, 20), (64, 72)),
                           ((576, 1024), (288, 512)), ((40, 90), (60, 45))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((W, H), Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear_u8(img, W, H), want)


@pytest.fixture(scope="module")
def svd_run():
    """One vdx SVDImg2VidPipeline program (EDM, 2 steps) on the weights
    the port's tiny pipeline carries."""
    from vdx.core.rng import as_key
    from vdx.models.clip_vision import CLIPVisionConfig as JCV
    from vdx.models.svd_unet import SVDUNetConfig as JUC
    from vdx.models.vae import VAEConfig as JVC
    from vdx.pipelines import SVDImg2VidPipeline as JPipe
    from vdx_torch.models.clip_vision import CLIPVisionConfig as TCV
    from vdx_torch.models.svd_unet import SVDUNetConfig as TUC
    from vdx_torch.models.vae import VAEConfig as TVC
    from vdx_torch.pipelines import SVDImg2VidPipeline as TPipe

    tp = TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
               vision_config=TCV.tiny(), policy=TP, device="cpu")
    rules = {"unet": VC.svd_unet_rules(JUC.tiny()),
             "vae": VC.vae_rules(JVC.tiny()),
             "tdec": VC.temporal_decoder_rules(JVC.tiny()),
             "vision": VC.clip_vision_rules(JCV.tiny())}
    cfgs = {"unet": JUC.tiny(), "vae": JVC.tiny(), "tdec": JVC.tiny(),
            "vision": JCV.tiny()}
    params = {}
    for i, (name, module) in enumerate(tp._components().items()):
        params[name] = whole_pair(module, name, cfgs[name], rules[name], 20 + i)
    tp._has_params = True
    jp = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
               vision_config=JCV.tiny(), policy=JP, params=params)
    assert jp.scheduler == tp.scheduler == "edm"
    image = np.random.default_rng(3).random((64, 64, 3), np.float32)
    F_ = 4
    cond = (jnp.asarray(image)[None] * 2.0 - 1.0, jnp.float32(6.0),
            jnp.float32(127.0), jnp.float32(0.1))
    g = np.linspace(1.0, 3.0, F_, dtype=np.float32).reshape(1, F_, 1, 1, 1)
    prog = jp._get_program(scheduler="edm", guidance=True,
                           latent_shape=(1, F_, 8, 8, 4), num_steps=2, chunk=2)
    args = (jp.params, as_key(SEED), cond, jnp.asarray(g),
            jp._get_tables("edm", 2))
    latents, frames = prog.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return dict(tp=tp, image=image, latents=np.array(latents),
                frames=np.array(frames)[0])


def _check_pipeline(run):
    tp = run["tp"]
    kw = dict(num_frames=4, height=64, width=64, num_inference_steps=2,
              min_guidance_scale=1.0, max_guidance_scale=3.0, fps=7,
              motion_bucket_id=127, noise_aug_strength=0.1, seed=SEED,
              decode_chunk=2)
    out = tp(run["image"], output_type="np", **kw)
    close(out.latents, run["latents"], PIPE_ATOL, "latents after 2 EDM steps")
    got, want = out.frames[0], run["frames"]
    assert got.shape == want.shape == (4, 64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= 1 and want.std() > 0
    # a spatial tile spanning the plane decodes as the untiled decoder
    lat = out.latents
    assert torch.equal(tp._decode(lat, 2, spatial_tile=8), tp._decode(lat, 2))
    # dpm_edm, the second EDM-grid sampler, runs through the same hooks
    dpm = tp(run["image"], output_type="latent", scheduler="dpm_edm", **kw)
    assert torch.isfinite(dpm.latents).all() and dpm.latents.shape == lat.shape


def test_blocks_and_models_match_vdx():
    _check_blocks()
    _check_models()


def test_resizes_match_jax_and_pillow():
    _check_resizes()


def test_pipeline_matches_vdx(svd_run):
    _check_pipeline(svd_run)
