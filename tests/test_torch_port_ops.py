"""vdx_torch ops and the kernels' plain versions against vdx, on the CPU.

* The plain K1 (staticmax flash attention) against vdx's Pallas
  ``flash_attention_dt(..., exp_impl="staticmax")`` in interpret mode.
* The plain K2/K3 (fused GroupNorm) against vdx's Pallas
  ``fused_group_norm`` / ``fused_group_norm_2phase`` in interpret mode,
  as tests/test_groupnorm_kernel.py runs them.
* ops.attention / ops.groupnorm against vdx's ops on the CPU.

Inputs come from numpy with a seed and go to both sides. fp32 tolerance:
2e-5 absolute for attention (the vdx kernel tests' bar), 1e-5 for
GroupNorm (vdx's GN kernel tests' bar) — the same arithmetic summed in a
different order. bf16 outputs: one bf16 ulp at the largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdx.kernels.flash_attention import flash_attention_dt as jax_flash_dt
from vdx.kernels.groupnorm import fused_group_norm as jax_k2
from vdx.kernels.groupnorm import fused_group_norm_2phase as jax_k3
from vdx.ops import attention as JA
from vdx.ops import groupnorm as JG
from vdx_torch.kernels import flash_attention as KA
from vdx_torch.kernels import groupnorm as KG
from vdx_torch.ops import attention as TA
from vdx_torch.ops import groupnorm as TG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp_tol(ref: np.ndarray) -> float:
    return 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))


def _check_k1_plain_against_pallas(B, Sq, Skv, H, D):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Skv, H, D), np.float32)
    v = rng.standard_normal((B, Skv, H, D), np.float32)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash_dt(q, k, v, scale=scale, block_q=4096,
                                       block_k=1024, exp_impl="staticmax"))
    got = KA.flash_attention_dt(_t(q), _t(k), _t(v), scale=scale)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # staticmax is exact softmax attention up to rounding in fp32
    exact = TA.dot_product_attention(_t(q), _t(k), _t(v), impl="xla")
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=2e-5)


def _check_gn_plain_against_pallas(kernel, eps, silu):
    rng = np.random.default_rng(1)
    B, S, C, G = 2, 96, 64, 8
    x = rng.standard_normal((B, S, C)).astype(np.float32) + 0.5
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    jfn, tfn = {"k2": (jax_k2, KG.fused_group_norm),
                "k3": (jax_k3, KG.fused_group_norm_2phase)}[kernel]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), num_groups=G, eps=eps,
                              with_silu=silu))
    got = tfn(_t(x), _t(scale), _t(bias), num_groups=G, eps=eps,
              with_silu=silu)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _check_group_norm_against_vdx(shape, eps, silu):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32) * 2.0 + 0.3
    C = shape[-1]
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    jfn = JG.group_norm_silu if silu else JG.group_norm
    tfn = TG.group_norm_silu if silu else TG.group_norm
    want = np.asarray(jfn(jnp.asarray(x), 32, jnp.asarray(scale),
                          jnp.asarray(bias), eps))
    got = tfn(_t(x), 32, _t(scale), _t(bias), eps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _check_group_norm_defers_the_parallel_options():
    x = torch.zeros(1, 4, 32)
    with pytest.raises(NotImplementedError):
        TG.group_norm(x, 32, None, None, stats_axis_name="frames")
    with pytest.raises(NotImplementedError):
        TG.group_norm(x, 32, None, None, frame_mask=torch.ones(4, dtype=bool))


def _check_attention_against_vdx(impl, dtype, Sq, Skv):
    rng = np.random.default_rng(3)
    B, H, D = 2, 2, 40
    arrs = [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for S in (Sq, Skv, Skv)]
    if dtype == "bf16":
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
        tq, tk, tv = (_t(a).to(torch.bfloat16) for a in arrs)
    else:
        jq, jk, jv = (jnp.asarray(a) for a in arrs)
        tq, tk, tv = (_t(a) for a in arrs)
    want = np.asarray(JA.dot_product_attention(jq, jk, jv, impl=impl)
                      .astype(jnp.float32))
    got = TA.dot_product_attention(tq, tk, tv, impl=impl).float().numpy()
    atol = 2e-5 if dtype == np.float32 else _bf16_ulp_tol(want)
    np.testing.assert_allclose(got, want, atol=atol)


def _check_masked_attention_against_vdx():
    """The causal-mask path CLIP uses (impl="xla")."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.tril(np.ones((9, 9), bool))[None, None]
    want = np.asarray(JA.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), impl="xla"))
    got = TA.dot_product_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                                   impl="xla")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _check_attention_raises_on_what_is_not_ported():
    q = torch.zeros(1, 512, 1, 128)
    with pytest.raises(NotImplementedError, match="K4"):
        TA.dot_product_attention(q, q, q, impl="flash")
    q = torch.zeros(1, 16, 1, 8)
    with pytest.raises(NotImplementedError):
        TA.dot_product_attention(q, q, q, impl="ring:frames")
    with pytest.raises(NotImplementedError):
        TA.dot_product_attention(q, q, q, impl="blockdiag")


def _check_gn_gate_covers_the_main_path_shapes():
    """Every GN shape of the SD-1.5 AnimateDiff main path (bf16) is taken
    by K2 or K3, and the level-0 resnet, motion and VAE shapes land on
    the kernel the dispatch documents."""
    bf16 = 2
    assert KG.k2_viable(4096, 320, 32, bf16)           # level-0 resnet GN
    assert not KG.k2_viable(65536, 320, 32, bf16)      # motion GN ...
    assert KG.k3_viable(65536, 320, 32, bf16)          # ... goes to K3
    assert not KG.k2_viable(262144, 128, 32, bf16)     # VAE GN at 512x512
    assert KG.k3_viable(262144, 128, 32, bf16)
    for S, C in [(4096, 960), (4096, 640), (1024, 1920), (256, 2560),
                 (64, 2560), (16 * 4096, 320), (16 * 1024, 640),
                 (16 * 256, 1280), (16 * 64, 1280), (4096, 512),
                 (16384, 512), (65536, 256), (262144, 256)]:
        assert KG.k2_viable(S, C, 32, bf16) or KG.k3_viable(S, C, 32, bf16), (S, C)


# Three tests per file, each looping over its cases: pytest-xdist's
# loadfile mode hands out files with many tests first, and this file's few
# tests keep it behind the suite's heavy files.
K1_CASES = [(2, 512, 512, 2, 16),
            (1, 512, 700, 2, 40)]  # ragged KV tail: masked keys
GN_KERNEL_CASES = [("k2", 1e-5, True), ("k2", 1e-6, False),
                   ("k3", 1e-6, True), ("k3", 1e-5, False)]
GN_OP_CASES = [((2, 4, 6, 64), 1e-5),     # resnet GN over [B, H, W, C]
               ((2, 3, 4, 5, 32), 1e-6)]  # motion GN: frames and space
ATTENTION_CASES = [
    ("xla", np.float32, 16, 16),   # temporal-like
    ("xla", np.float32, 24, 77),   # cross-attention-like
    ("auto", np.float32, 16, 16),  # -> xla on the CPU
    ("xla_bf16p", "bf16", 16, 16),
    ("auto", "bf16", 24, 77),      # -> xla_bf16p for maskless bf16
    ("auto", "bf16", 512, 512),    # flash-sized: still eager on the CPU
]


def test_kernel_plain_versions_match_pallas():
    for case in K1_CASES:
        _check_k1_plain_against_pallas(*case)
    for case in GN_KERNEL_CASES:
        _check_gn_plain_against_pallas(*case)


def test_ops_match_vdx():
    for shape, eps in GN_OP_CASES:
        for silu in (False, True):
            _check_group_norm_against_vdx(shape, eps, silu)
    for case in ATTENTION_CASES:
        _check_attention_against_vdx(*case)
    _check_masked_attention_against_vdx()


def test_ops_raise_on_what_is_not_ported_and_gate_main_path():
    _check_group_norm_defers_the_parallel_options()
    _check_attention_raises_on_what_is_not_ported()
    _check_gn_gate_covers_the_main_path_shapes()
