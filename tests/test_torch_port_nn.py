"""vdx_torch nn blocks against vdx's, on the CPU in fp32.

The cases are tests/test_block_parity.py's (ResnetBlock2D with time
embedding, SpatialTransformer, the motion module, the VAE decoder
up-block, the VAE mid attention), plus the embeddings, resampling and the
single-KV attention shortcut. vdx's params come from numpy with a seed and
reach the port through vdx_torch.core.convert (the same rule tables,
run backwards). Bar: 2e-5 absolute (tests/test_block_parity.py:46).
vdx's blocks run under ``jax.jit`` at XLA optimisation level 0: on one
core that costs 0.4-0.9 s a block against 2.4-3.5 s of op-by-op compiles
un-jitted.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdx.core.convert import flatten_params
from vdx.core.dtypes import FP32_POLICY as JP
from vdx_torch.core import convert as C
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


def _random_params(template, seed):
    """Seeded numpy leaves for a vdx eval_shape template: fan-in-scaled
    kernels, norm scales near 1, small biases (so the affine matters)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, template)


def _strip(rules, prefix):
    return {k[len(prefix) + 1:]: (hf.lstrip("."), tr) for k, (hf, tr) in rules.items()}


def _load(module, params, rules):
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    module.load_state_dict(C.state_from_rules(flat, rules), strict=True)
    return module.eval()


def _vdx(fn, *args):
    """vdx's forward, jitted at XLA's backend optimisation level 0."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return np.asarray(compiled(*args))


def _run(module, *args):
    with torch.no_grad():
        return module(*(torch.from_numpy(np.array(a)) for a in args)).numpy()


def _check_resnet_block():
    from vdx.nn.resnet import ResnetBlock2D as J
    from vdx_torch.nn.resnet import ResnetBlock2D as T

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 32), np.float32)
    temb = rng.standard_normal((2, 48), np.float32)
    jm = J(64, policy=JP)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, temb), 0)
    want = _vdx(jm.apply, params, x, temb)
    tm = _load(T(32, 64, 48, policy=TP), params, _strip(C._resnet_rules("x", ""), "x"))
    np.testing.assert_allclose(_run(tm, x, temb), want, atol=ATOL)


def _check_spatial_transformer():
    from vdx.nn.transformer import SpatialTransformer as J
    from vdx_torch.nn.transformer import SpatialTransformer as T

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 4, 32), np.float32)
    ctx = rng.standard_normal((2, 7, 24), np.float32)
    jm = J(heads=2, head_dim=16, context_dim=24, policy=JP)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, ctx), 1)
    want = _vdx(jm.apply, params, x, ctx)
    tm = _load(T(32, 2, 16, 24, policy=TP), params,
               _strip(C._spatial_transformer_rules("x", ""), "x"))
    np.testing.assert_allclose(_run(tm, x, ctx), want, atol=ATOL)


def _check_motion_module():
    from vdx.nn.temporal import TemporalTransformer3D as J
    from vdx_torch.nn.temporal import TemporalTransformer3D as T

    F = 4
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2 * F, 3, 5, 32), np.float32)
    jm = J(heads=2, policy=JP)
    template = jax.eval_shape(lambda k, xx: jm.init(k, xx, F),
                              jax.random.PRNGKey(0), x)
    params = _random_params(template, 2)
    want = _vdx(lambda p, xx: jm.apply(p, xx, F), params, x)
    tm = _load(T(32, heads=2, policy=TP), params, _strip(C._motion_rules("x", ""), "x"))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), F).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _check_vae_decoder_upblock():
    from vdx.nn.resnet import ResnetBlock2D as JR
    from vdx.nn.resnet import Upsample2D as JU
    from vdx_torch.models.vae import _UpBlock

    class JUpBlock(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            for li in range(3):
                x = JR(32, use_time_emb=False, eps=1e-6, policy=JP,
                       name=f"up_0_{li}")(x)
            return JU(32, policy=JP, name="up_0_upsample")(x)

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 4, 32), np.float32)
    jm = JUpBlock()
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 3)
    want = _vdx(jm.apply, params, x)
    rules = {}
    for li in range(3):
        rules.update(C._vae_resnet_rules(f"up_0_{li}", f"resnets.{li}"))
    rules.update(C._resample_rules("up_0_upsample", "upsamplers.0"))
    tm = _load(_UpBlock(32, 32, 3, True, TP), params, rules)
    np.testing.assert_allclose(_run(tm, x), want, atol=ATOL)


def _check_vae_mid_attention():
    from vdx.models.vae import VAEAttention as J
    from vdx_torch.models.vae import VAEAttention as T

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5, 32), np.float32)
    jm = J(policy=JP)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 4)
    want = _vdx(jm.apply, params, x)
    tm = _load(T(32, TP), params, _strip(C._vae_attn_rules("x", ""), "x"))
    np.testing.assert_allclose(_run(tm, x), want, atol=ATOL)


def _check_resampling(kind):
    from vdx.nn import resnet as JR
    from vdx_torch.nn import resnet as TR

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 6, 16), np.float32)
    jcls, tcls = {"down": (JR.Downsample2D, TR.Downsample2D),
                  "up": (JR.Upsample2D, TR.Upsample2D)}[kind]
    jm = jcls(24, policy=JP)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 5)
    want = _vdx(jm.apply, params, x)
    tm = _load(tcls(16, 24, TP), params, _strip(C._resample_rules("x", ""), "x"))
    np.testing.assert_allclose(_run(tm, x), want, atol=ATOL)


def _check_single_kv_attention_shortcut():
    """Context of length 1: the exact v-broadcast shortcut on both sides."""
    from vdx.nn.attention import Attention as J
    from vdx_torch.nn.attention import Attention as T

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, 32), np.float32)
    ctx = rng.standard_normal((2, 1, 24), np.float32)
    jm = J(32, heads=2, head_dim=16, context_dim=24, policy=JP)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, ctx), 6)
    want = _vdx(jm.apply, params, x, ctx)
    rules = {k: (v[0].replace("attn1.", ""), v[1])
             for k, v in _strip(C._transformer_block_rules("x", ""), "x").items()
             if k.startswith("attn1/")}
    rules = {k[len("attn1/"):]: v for k, v in rules.items()}
    tm = _load(T(32, 2, 16, context_dim=24, policy=TP), params, rules)
    np.testing.assert_allclose(_run(tm, x, ctx), want, atol=ATOL)


def _check_embeddings():
    from vdx.nn import embeddings as JE
    from vdx_torch.nn import embeddings as TE

    t = np.array([0.0, 1.0, 250.5, 999.0], np.float32)
    np.testing.assert_allclose(
        TE.get_timestep_embedding(torch.from_numpy(t), 32).numpy(),
        np.asarray(JE.get_timestep_embedding(jnp.asarray(t), 32)), atol=1e-5)
    np.testing.assert_allclose(
        TE.sinusoidal_positional_encoding(16, 40).numpy(),
        np.asarray(JE.sinusoidal_positional_encoding(16, 40)), atol=1e-5)

    jm = JE.TimestepEmbedding(64, policy=JP)
    emb = np.asarray(JE.get_timestep_embedding(jnp.asarray(t), 32))
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), emb), 7)
    want = _vdx(jm.apply, params, emb)
    rules = {f"{n}/kernel": (f"{n}.weight", C.t_dense) for n in ("linear_1", "linear_2")}
    rules |= {f"{n}/bias": (f"{n}.bias", C.t_id) for n in ("linear_1", "linear_2")}
    tm = _load(TE.TimestepEmbedding(32, 64, TP), params, rules)
    np.testing.assert_allclose(_run(tm, emb), want, atol=ATOL)


def _check_geglu_policy_erf_in_fp32_tanh_in_bf16():
    """GEGLU's gelu: exact erf under fp32 compute, tanh under bf16
    (vdx/nn/attention.py:150-174); both sides agree in each policy."""
    from vdx.core.dtypes import Policy as JPolicy
    from vdx.nn.attention import GEGLU as J
    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.nn.attention import GEGLU as T

    rng = np.random.default_rng(8)
    x = (3.0 * rng.standard_normal((4, 16))).astype(np.float32)
    jm32 = J(8, policy=JP)
    params = _random_params(jax.eval_shape(jm32.init, jax.random.PRNGKey(0), x), 8)
    rules = {"proj/kernel": ("proj.weight", C.t_dense),
             "proj/bias": ("proj.bias", C.t_id)}
    want32 = _vdx(jm32.apply, params, x)
    np.testing.assert_allclose(_run(_load(T(16, 8, TP), params, rules), x),
                               want32, atol=ATOL)
    jm16 = J(8, policy=JPolicy(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16))
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    want16 = _vdx(lambda p, xx: jm16.apply(p, xx).astype(jnp.float32), p16, x)
    t16 = _load(T(16, 8, BF16_POLICY), params, rules)
    with torch.no_grad():
        got16 = t16(torch.from_numpy(x)).float().numpy()
    # bf16 matmuls accumulate in another order: one bf16 ulp per product
    np.testing.assert_allclose(got16, want16,
                               atol=2.0 ** -6 * max(1.0, np.abs(want16).max()))
    assert not np.allclose(want16, want32, atol=1e-4)  # the policies differ


# A few tests per file, each looping over its cases: pytest-xdist's
# loadfile mode hands out files with many tests first, and this file's few
# tests keep it behind the suite's heavy files.
def test_unet_blocks_match_vdx():
    _check_resnet_block()
    _check_spatial_transformer()
    _check_motion_module()
    _check_single_kv_attention_shortcut()


def test_vae_blocks_and_resampling_match_vdx():
    _check_vae_decoder_upblock()
    _check_vae_mid_attention()
    for kind in ("down", "up"):
        _check_resampling(kind)


def test_embeddings_and_geglu_match_vdx():
    _check_embeddings()
    _check_geglu_policy_erf_in_fp32_tanh_in_bf16()
