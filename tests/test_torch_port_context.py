"""The port's context windows and FreeNoise against vdx's, on the CPU
(fp32, tiny configs).

* The window tables (``window_starts``, ``window_weights``) equal vdx's
  over a grid of clip lengths, window lengths, strides and profiles.
* The keyed draws FreeNoise takes: ``split`` and ``permutation`` equal
  ``jax.random``'s exactly, at several keys and lengths (one and two
  sort rounds), and so do the threefry bits of a keyed normal; the
  normals carry the ErfInv polynomial's rounding, within 4 fp32 ulps of
  each element (tests/test_torch_port_rng.py). The FreeNoise draw for
  B = 1 and 2 against vdx's ``make_freenoise_maker``: every later block
  is its base block under vdx's permutation, bit for bit, and the values
  are within those 4 ulps.
* vdx compiles one context program (at XLA optimisation level 0): 12
  frames at 64x64, windows of 8 at stride 4 (starts 0 and 4), pyramid
  weights, FreeNoise, 3 DDIM steps. The port runs the request from vdx's
  own FreeNoise draw; the bar is the pipeline bar of
  tests/test_torch_port_requests.py, 1e-3 on the latents per step, 3e-3
  after 3 steps. A clip of one window equals the context-free port bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_requests import compile_o0, load_from_vdx, tiny_port, vdx_params
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import VAEConfig as JVC
from vdx.pipelines import AnimateDiffPipeline as JPipe
from vdx.pipelines import context as JX
from vdx_torch.core import rng
from vdx_torch.pipelines import ContextConfig
from vdx_torch.pipelines import context as TX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SEEDS = (0, 42, 2 ** 31 + 5, 2 ** 32 + 7)
SHAPE = (1, 12, 8, 8, 4)
N = 3
STEP_ATOL = 1e-3
CTX = dict(frames=8, stride=4)
CALL = dict(height=64, width=64, num_inference_steps=N, seed=11,
            output_type="latent")


def _within_ulps(got, want, n=4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert (np.abs(got - want) <= n * np.spacing(np.abs(want))).all()


def test_window_tables_match_vdx():
    for total in range(2, 41):
        for frames in range(2, 17):
            for stride in range(1, frames):
                if total < frames:
                    for mod in (JX, TX):
                        with pytest.raises(ValueError):
                            mod.window_starts(total, frames, stride)
                    continue
                assert TX.window_starts(total, frames, stride) \
                    == JX.window_starts(total, frames, stride)
    for frames in range(1, 33):
        for mode in ("pyramid", "uniform"):
            want = JX.window_weights(frames, mode)
            got = TX.window_weights(frames, mode)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for bad in (dict(frames=1), dict(stride=0), dict(stride=16),
                dict(weights="gauss")):
        for cls in (JX.ContextConfig, ContextConfig):
            with pytest.raises(ValueError):
                cls(**bad)
    assert dataclass_fields(ContextConfig()) == dataclass_fields(JX.ContextConfig())


def dataclass_fields(cfg) -> dict:
    import dataclasses

    return dataclasses.asdict(cfg)


@jax.jit
def _jax_keyed(key):
    k1, k2 = jax.random.split(key)
    return (jax.random.split(key, 5), jax.random.bits(k2, (3, 7), jnp.uint32),
            jax.random.normal(k2, (3, 7), jnp.float32),
            [jax.random.permutation(k1, n) for n in (1, 2, 16, 17, 2000)])


def test_keyed_draws_and_freenoise_match_vdx():
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        tkey = rng.prng_key(seed)
        splits, bits, normal, perms = _jax_keyed(key)
        got = rng.split(tkey, 5)
        assert got == [tuple(int(w) for w in np.asarray(k)) for k in splits]
        k1, k2 = rng.split(tkey)
        np.testing.assert_array_equal(rng.key_bits(k2, (3, 7)).numpy(),
                                      np.asarray(bits).astype(np.int64))
        _within_ulps(rng.key_normal(k2, (3, 7)).numpy(), normal)
        for n, want in zip((1, 2, 16, 17, 2000), perms):
            np.testing.assert_array_equal(rng.permutation(k1, n).numpy(),
                                          np.asarray(want))
        # the seed-based draws are thin callers of the keyed ones
        assert torch.equal(rng.normal(seed, (5,)), rng.key_normal(tkey, (5,)))
    # FreeNoise: 20 frames in windows of 8 (three blocks, the last cut),
    # one video and two
    for shape, seeds in (((1, 20, 4, 4, 4), [3]), ((2, 20, 4, 4, 4), [3, 99])):
        keys = (jax.random.PRNGKey(seeds[0]) if len(seeds) == 1 else
                jnp.stack([jax.random.PRNGKey(s) for s in seeds]))
        want = np.asarray(jax.jit(JX.make_freenoise_maker(shape, 8))(keys))
        got = TX.make_freenoise_maker(shape, 8, "cpu")(
            [rng.prng_key(s) for s in seeds]).numpy()
        _within_ulps(got, want)
        for b, seed in enumerate(seeds):
            k_base, k_perm = rng.split(rng.prng_key(seed))
            base = rng.key_normal(k_base, (8,) + shape[2:]).numpy()
            np.testing.assert_array_equal(got[b, :8], base)
            for r in (1, 2):
                k_perm, k = rng.split(k_perm)
                perm = rng.permutation(k, 8).numpy()
                block = got[b, 8 * r:8 * (r + 1)]
                np.testing.assert_array_equal(block, base[perm][:len(block)])
                # vdx's block r is vdx's base under the same permutation
                np.testing.assert_array_equal(
                    want[b, 8 * r:8 * (r + 1)], want[b, :8][perm][:len(block)])
    # the pipeline's noise: FreeNoise past one window, the plain draw within
    tp = tiny_port(context=ContextConfig(**CTX))
    assert torch.equal(tp.initial_noise((2, 20, 4, 4, 4), [3, 99]),
                       torch.from_numpy(got))
    assert torch.equal(tp.initial_noise((1, 8, 4, 4, 4), 3),
                       rng.normal(3, (1, 8, 4, 4, 4)))


@pytest.fixture(scope="module")
def ctx_run():
    seed_pipe = tiny_port()
    seed_pipe.init_params(0)
    params = vdx_params(seed_pipe)
    jpipe = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                  text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                  params=params, context=JX.ContextConfig(**CTX))
    cond = jpipe.encode_prompt("a fox", "")
    prog = jpipe._get_program(scheduler="ddim", guidance=True,
                              latent_shape=SHAPE, num_steps=N, chunk=None)
    key = jpipe._seed_keys(CALL["seed"], 1)
    args = (jpipe.params, key, cond, jnp.float32(7.5), jpipe._get_tables("ddim", N))
    latents = np.asarray(compile_o0(prog, args)(*args))
    noise = np.asarray(jax.jit(JX.make_freenoise_maker(SHAPE, CTX["frames"]))(key))
    return dict(params=params, latents=latents, noise=noise)


def test_context_program_matches_vdx(ctx_run):
    tp = load_from_vdx(tiny_port(context=ContextConfig(**CTX)), ctx_run["params"])
    own = tp.initial_noise(SHAPE, CALL["seed"]).numpy()
    _within_ulps(own, ctx_run["noise"])
    tp.initial_noise = lambda shape, seed: torch.from_numpy(ctx_run["noise"].copy())
    got = tp("a fox", num_frames=12, **CALL).latents.numpy()
    want = ctx_run["latents"]
    np.testing.assert_allclose(got, want, atol=N * STEP_ATOL)
    # the blend is not the plain 12-frame call
    plain = load_from_vdx(tiny_port(), ctx_run["params"])
    plain.initial_noise = tp.initial_noise
    assert np.abs(plain("a fox", num_frames=12, **CALL).latents.numpy()
                  - want).max() > 10 * N * STEP_ATOL
    # one window covers the clip: the context-free path, bit for bit
    short = load_from_vdx(tiny_port(context=ContextConfig(**CTX)), ctx_run["params"])
    free = load_from_vdx(tiny_port(), ctx_run["params"])
    for frames in (4, 8):
        assert torch.equal(short("a fox", num_frames=frames, **CALL).latents,
                           free("a fox", num_frames=frames, **CALL).latents)
