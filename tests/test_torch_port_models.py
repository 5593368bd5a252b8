"""vdx_torch models against vdx's at the tiny configs, on the CPU in fp32:
UNetMotion, the AutoencoderKL decoder, the CLIP text tower and the
tokenizer.

vdx's params come from numpy with a seed and reach the port through
vdx_torch.core.convert.params_from_jax. Bar: 2e-5 absolute
(tests/test_block_parity.py:46). vdx's UNet and VAE run under
``jax.jit`` at XLA optimisation level 0: on one core the tiny UNet
compiles in about 10 s that way, against about 19 s at the default level
and about 38 s of op-by-op compiles un-jitted.
"""

import jax
import numpy as np
import pytest
import torch

from vdx.core import convert as VC
from vdx_torch.core.convert import params_from_jax
from vdx.core.dtypes import FP32_POLICY as JP
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


def _jax_params(module, rules, seed):
    """Seeded numpy weights laid out by the port module's state_dict, then
    carried into a vdx parameter tree by vdx's own rules (no vdx init
    trace needed): fan-in-scaled kernels, norm scales near 1, small
    biases."""
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
    flat = {path: tr(sd[hf]) for path, (hf, tr) in rules.items() if hf in sd}
    return VC.unflatten_params(flat)


def _load_through_port_converter(module, params, component, config):
    flat = {k: np.asarray(v) for k, v in VC.flatten_params(params).items()}
    module.load_state_dict(params_from_jax(flat, component, config), strict=True)
    return module.eval()


def _jit_o0(fn, *args):
    """jax.jit at XLA's backend optimisation level 0: half the compile
    time of the default on one core, same fp32 arithmetic."""
    return _compile_o0(fn, *args)(*args)


def _compile_o0(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def unet_pair():
    """(compiled vdx UNet apply, its params, the port UNet with the same
    weights, inputs): compiled once, run at several timesteps."""
    from vdx.models.unet_motion import UNetMotion as J
    from vdx.models.unet_motion import UNetMotionConfig as JC
    from vdx_torch.models.unet_motion import UNetMotion as T
    from vdx_torch.models.unet_motion import UNetMotionConfig as TC

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8, 4), np.float32)
    ctx = rng.standard_normal((2, 7, 64), np.float32)
    t0 = np.array([1, 1], np.int32)
    tm = T(TC.tiny(), TP)
    params = _jax_params(tm, VC.unet_motion_rules(JC.tiny()), 0)
    jm = J(JC.tiny(), policy=JP)
    compiled = _compile_o0(jm.apply, params, x, t0, ctx)
    _load_through_port_converter(tm, params, "unet", JC.tiny())
    return compiled, params, tm, x, ctx


# Tolerance: 2e-5 (the block bar) where the timestep embedding is well
# conditioned. At large t each sinusoid's fp32 argument t * freq carries
# t * 2^-24 relative error, so vdx and the port each sit up to ~5e-5 off
# the float64 embedding near t = 1000 (test_timestep_embedding_conditioning)
# and differ from each other by as much; the network carries that to its
# output, hence 2e-4 there.
def _check_unet_motion(unet_pair, t, atol):
    compiled, params, tm, x, ctx = unet_pair
    t = np.array(t, np.int32)
    want = np.asarray(compiled(params, x, t, ctx))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(np.array(a)) for a in (x, t, ctx))).numpy()
    assert got.shape == want.shape == (2, 4, 8, 8, 4)
    np.testing.assert_allclose(got, want, atol=atol)


def _check_timestep_embedding_conditioning():
    """Near t = 1000 both sides' fp32 embeddings are equally far from the
    float64 one (a property of fp32, not a fault of either side)."""
    import jax.numpy as jnp

    from vdx.nn.embeddings import get_timestep_embedding as J
    from vdx_torch.nn.embeddings import get_timestep_embedding as T

    t = np.array([981, 999], np.int32)
    half = 160
    args = t[:, None] * np.exp(-np.log(10000.0) * np.arange(half) / half)
    truth = np.concatenate([np.cos(args), np.sin(args)], axis=-1)
    err_j = np.abs(np.asarray(J(jnp.asarray(t), 320)) - truth).max()
    err_t = np.abs(T(torch.from_numpy(t), 320).numpy() - truth).max()
    bound = 2 * float(t.max()) * 2.0 ** -24  # ~2 ulp of the largest argument
    assert err_j < bound and err_t < bound, (err_j, err_t, bound)


def _check_vae_decode():
    from vdx.models.vae import AutoencoderKL as J
    from vdx.models.vae import VAEConfig as JC
    from vdx_torch.models.vae import AutoencoderKL as T
    from vdx_torch.models.vae import VAEConfig as TC

    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 8, 8, 4), np.float32) * 0.18215
    tm = T(TC.tiny(), TP)
    params = _jax_params(tm, VC.vae_rules(JC.tiny()), 1)
    jm = J(JC.tiny(), policy=JP)
    want = np.asarray(_jit_o0(lambda p, zz: jm.apply(p, zz, method=jm.decode),
                              params, z))
    _load_through_port_converter(tm, params, "vae", JC.tiny())
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _check_clip_text():
    from vdx.models.clip_text import CLIPTextConfig as JC
    from vdx.models.clip_text import CLIPTextModel as J
    from vdx_torch.models.clip_text import CLIPTextConfig as TC
    from vdx_torch.models.clip_text import CLIPTextModel as T

    rng = np.random.default_rng(2)
    ids = rng.integers(0, 49408, (2, 77)).astype(np.int32)
    tm = T(TC.tiny(), TP)
    params = _jax_params(tm, VC.clip_text_rules(JC.tiny()), 2)
    want = np.asarray(J(JC.tiny(), policy=JP).apply(params, ids))
    _load_through_port_converter(tm, params, "text", JC.tiny())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


PROMPTS = [
    "a corgi walking on the beach, sunset lighting, high quality",
    "  Bad QUALITY,   blurry &amp; distorted  ",
    "",
    "café 日本 \U0001F600 it's 2024!",
    "word " * 60,  # longer than the 77-token context: truncated
]


def _check_fallback_tokenizer_ids():
    from vdx.models.tokenizer import FallbackBPETokenizer as J
    from vdx_torch.models.tokenizer import FallbackBPETokenizer as T

    want = J()(PROMPTS)
    got = T()(PROMPTS)
    assert got.dtype == want.dtype and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)


@pytest.fixture()
def bpe_files(tmp_path):
    import json

    chars = list("abcdefghijklmnopqrstuvwxyz")
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges = [("c", "o"), ("co", "r"), ("g", "i</w>"), ("cor", "gi</w>"),
              ("t", "h"), ("th", "e</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def _check_bpe_tokenizer_ids(bpe_files):
    from vdx.models.tokenizer import load_tokenizer as J
    from vdx_torch.models.tokenizer import CLIPTokenizer
    from vdx_torch.models.tokenizer import load_tokenizer as T

    prompts = ["the corgi", "a corgi on the beach!", "THE  Corgi's"]
    tok = T(*bpe_files)
    assert isinstance(tok, CLIPTokenizer)
    np.testing.assert_array_equal(tok(prompts), J(*bpe_files)(prompts))


# A few tests per file, each looping over its cases: pytest-xdist's
# loadfile mode hands out files with many tests first, and this file's few
# tests keep it behind the suite's heavy files.
def test_unet_motion_matches_vdx(unet_pair):
    # (timesteps, tolerance): see the note above _check_unet_motion
    for t, atol in (((41, 1), ATOL), ((981, 501), 2e-4)):
        _check_unet_motion(unet_pair, t, atol)
    _check_timestep_embedding_conditioning()


def test_vae_decode_and_clip_text_match_vdx():
    _check_vae_decode()
    _check_clip_text()


def test_tokenizer_ids_identical(bpe_files):
    _check_fallback_tokenizer_ids()
    _check_bpe_tokenizer_ids(bpe_files)
