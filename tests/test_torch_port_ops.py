"""vdx_torch ops and the kernels' plain versions against vdx, on the CPU.

* The plain K1 (staticmax flash attention) against vdx's Pallas
  ``flash_attention_dt(..., exp_impl="staticmax")`` in interpret mode.
* The plain K4 (running-max flash attention) against vdx's Pallas
  ``flash_attention`` in interpret mode, as tests/test_kernels.py runs it,
  with 128-row blocks so the running max crosses KV blocks and the last
  block is ragged (masked), at D = 160, 20 and 256.
* The plain K2/K3 (fused GroupNorm) against vdx's Pallas
  ``fused_group_norm`` / ``fused_group_norm_2phase`` in interpret mode,
  as tests/test_groupnorm_kernel.py runs them.
* The plain K6, K7, K8 (block-diagonal temporal attention) and K9
  (``temporal_attention_cp``) against vdx's Pallas kernels in interpret
  mode, as tests/test_kernels.py runs them, with P * F not a multiple of
  the 128-token block, at D = 160, and K9 at F = 24; fp32 and bf16.
* ops.attention (``impl="blockdiag"`` and ``"xla_bf16p_packed"`` too) and
  ops.groupnorm against vdx's ops on the CPU.

Inputs come from numpy with a seed and go to both sides. fp32 tolerance:
2e-5 absolute for attention (the vdx kernel tests' bar), 1e-5 for
GroupNorm (vdx's GN kernel tests' bar) — the same arithmetic summed in a
different order. bf16 outputs: one bf16 ulp at the largest magnitude.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdx.kernels import flash_attention as JK
from vdx.kernels.flash_attention import flash_attention as jax_flash
from vdx.kernels.flash_attention import flash_attention_dt as jax_flash_dt
from vdx.kernels.temporal_attention_cp import temporal_attention_cp as jax_k9
from vdx.kernels.groupnorm import fused_group_norm as jax_k2
from vdx.kernels.groupnorm import fused_group_norm_2phase as jax_k3
from vdx.ops import attention as JA
from vdx.ops import groupnorm as JG
from vdx_torch.kernels import flash_attention as KA
from vdx_torch.kernels import groupnorm as KG
from vdx_torch.kernels import temporal_attention_cp as KT
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
    got = KA.flash_attention_dt(_t(q), _t(k), _t(v), scale=scale,
                                exp_impl="staticmax")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # staticmax is exact softmax attention up to rounding in fp32
    exact = TA.dot_product_attention(_t(q), _t(k), _t(v), impl="xla")
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=2e-5)


def _check_k4_plain_against_pallas(B, Sq, Skv, H, D):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Skv, H, D), np.float32)
    v = rng.standard_normal((B, Skv, H, D), np.float32)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(q, k, v, scale=scale, block_q=128,
                                    block_k=128))
    got = KA.flash_attention(_t(q), _t(k), _t(v), scale=scale)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _check_flash_dispatch_against_vdx(D):
    """impl="flash": D % 8 == 0 and D < 128 goes to K1, any other D to K4,
    on both sides (vdx's Pallas kernels in interpret mode)."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 96, 2, D)).astype(np.float32)
               for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JA.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="flash"))
    got = TA.dot_product_attention(_t(q), _t(k), _t(v), impl="flash")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    if D % 8 == 0 and D < 128:
        plain = KA.flash_attention_dt_plain(_t(q), _t(k), _t(v),
                                            scale=D ** -0.5,
                                            exp_impl="staticmax")
    else:
        plain = KA.flash_attention_plain(_t(q), _t(k), _t(v), scale=D ** -0.5)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def _check_temporal_plain_against_pallas(kernel, P, F, H, D, dtype):
    """K6-K9's plain versions (the CPU path of their wrappers) against
    vdx's Pallas kernels in interpret mode. fp32: 2e-5; bf16 operands
    (both sides round q' and p to bf16 at the same places): one bf16 ulp
    at the largest output magnitude."""
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((P, F, H, D)).astype(np.float32)
            for _ in range(3)]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    tq, tk, tv = (_t(a).to(tdt) for a in arrs)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        if kernel == "k6":
            want = JK.flash_attention_blockdiag(jq, jk, jv, scale=scale,
                                                block=128)
            got = KA.flash_attention_blockdiag(tq, tk, tv, scale=scale,
                                               block=128)
        elif kernel in ("k7", "k8"):
            jfn, tfn = {"k7": (JK.flash_attention_blockdiag_tc,
                               KA.flash_attention_blockdiag_tc),
                        "k8": (JK.flash_attention_blockdiag_tc2,
                               KA.flash_attention_blockdiag_tc2)}[kernel]
            want = jfn(jq, jk, jv, scale=scale, heads=H, block=128)
            got = tfn(tq, tk, tv, scale=scale, heads=H, block=128)
        else:
            want = jax_k9(jq, jk, jv, scale=scale, block_p=P, interpret=True)
            got = KT.temporal_attention_cp(tq, tk, tv, scale=scale, block_p=P)
    want = np.asarray(want.astype(jnp.float32))
    atol = 2e-5 if dtype == "fp32" else _bf16_ulp_tol(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               err_msg=f"{kernel} {P, F, H, D} {dtype}")


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


def _check_group_norm_sharded_forms():
    """The statistics over a mesh axis need that axis bound (held against
    vdx at 4 ranks in tests/test_torch_port_parallel.py): outside
    ``Mesh.bind()`` they raise, never run locally. A frame mask alone is
    vdx's masked local statistics."""
    x = torch.zeros(1, 4, 32)
    with pytest.raises(NameError, match="unbound axis name 'frames'"):
        TG.group_norm(x, 32, None, None, stats_axis_name="frames")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 3, 3, 16)).astype(np.float32) * 2 + 0.5
    scale, bias = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    mask = np.array([True, True, True, False])
    want = np.asarray(JG.group_norm_silu(
        jnp.asarray(x), 4, jnp.asarray(scale), jnp.asarray(bias), 1e-6,
        frame_mask=jnp.asarray(mask)))
    got = TG.group_norm_silu(_t(x), 4, _t(scale), _t(bias), 1e-6,
                             frame_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


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
    with pltpu.force_tpu_interpret_mode():  # blockdiag: vdx's Pallas K6
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


def _check_attention_ring_needs_a_bound_axis():
    """Ring attention runs over a bound mesh axis (held against vdx at 4
    ranks in tests/test_torch_port_parallel.py) and raises outside one;
    ``kv_valid`` is ring-only, as vdx's."""
    q = torch.zeros(1, 16, 1, 8)
    with pytest.raises(NameError, match="unbound axis name 'frames'"):
        TA.dot_product_attention(q, q, q, impl="ring:frames")
    with pytest.raises(ValueError, match="only supported by ring"):
        TA.dot_product_attention(q, q, q, kv_valid=torch.ones(16, dtype=bool))
    for impl in ("blockdiag", "xla_bf16p_packed"):
        assert TA.dot_product_attention(q, q, q, impl=impl).shape == q.shape


def _check_temporal_wrappers_keep_vdx_preconditions():
    """K6-K9 raise where vdx's kernels assert, on every device."""
    q = torch.zeros(4, 16, 2, 40)
    with pytest.raises(ValueError, match="D % 8"):
        KA.flash_attention_blockdiag(q[..., :20], q[..., :20], q[..., :20],
                                     scale=1.0)
    q24 = torch.zeros(4, 24, 2, 40)
    with pytest.raises(ValueError, match=r"F \| block"):  # 512 % 24 != 0
        TA.dot_product_attention(q24, q24, q24, impl="blockdiag")
    with pytest.raises(ValueError, match="block % 128"):
        KA.flash_attention_blockdiag(q, q, q, scale=1.0, block=96)
    with pytest.raises(ValueError, match=r"one \[P, F, H, D\] shape"):
        KA.flash_attention_blockdiag(q, q[:2], q, scale=1.0)
    for fn in (KA.flash_attention_blockdiag_tc, KA.flash_attention_blockdiag_tc2):
        with pytest.raises(ValueError, match="heads"):
            fn(q, q, q, scale=1.0, heads=8)
    with pytest.raises(ValueError, match="block_p"):
        KT.temporal_attention_cp(q, q, q, block_p=128)  # P = 4
    q3 = torch.zeros(4, 16, 3, 5)  # D = 5, H * D = 15
    with pytest.raises(ValueError, match=r"H \* D % 8"):
        KT.temporal_attention_cp(q3, q3, q3, block_p=4)
    assert KT.temporal_attention_cp(q24, q24, q24, block_p=4).shape == q24.shape


def _gn_sites(sizes):
    """{(height, width): {(B, S, C, G)}}: every GroupNorm that the port's
    full-width UNet (CFG batch 2 x 16 frames), VAE decoder and VAE encoder
    (8-frame chunks) run at each size, traced on the meta device (shapes
    only, no weights)."""
    from vdx_torch.models.unet_motion import UNetMotion, UNetMotionConfig
    from vdx_torch.models.vae import AutoencoderKL, VAEConfig
    from vdx_torch.nn.resnet import GroupNormModule

    sites = {}

    def record(mod, args):
        x = args[0]
        sites[size].add((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1],
                         mod.num_groups))

    with torch.device("meta"), torch.inference_mode():
        unet, vae = UNetMotion(UNetMotionConfig()), AutoencoderKL(VAEConfig())
        for net in (unet, vae):
            for m in net.modules():
                if isinstance(m, GroupNormModule):
                    m.register_forward_pre_hook(record)
        for size in sizes:
            sites[size] = set()
            h, w = size[0] // 8, size[1] // 8
            unet(torch.empty(2, 16, h, w, 4), torch.empty(2),
                 torch.empty(2, 77, 768))
            vae.decode(torch.empty(8, h, w, 4))
            vae.encode(torch.empty(8, size[0], size[1], 3))
    return sites


def _check_gn_gate_covers_the_main_path_shapes():
    """Every GN site of the SD-1.5 AnimateDiff UNet, VAE decoder and VAE
    encoder at 512x512, 768x768, 1024x576 and 1024x1024, in bf16 and
    fp32, is taken by K2 or K3 (the shapes traced from the port's own
    modules), and the level-0 resnet, motion, up-block-1 and VAE shapes
    land on the kernel the dispatch documents: K2 where a thread-block
    cluster holds a stripe of whole groups with two CTAs an SM, else
    K3."""
    bf16, fp32 = 2, 4
    assert KG.k2_viable(4096, 320, 32, bf16)           # level-0 resnet GN
    assert KG.k2_viable(9216, 320, 32, bf16)           # ... at 768: 16 CTAs
    assert not KG.k2_viable(9216, 960, 32, bf16)       # one CTA an SM: K3
    assert not KG.k2_viable(65536, 320, 32, bf16)      # motion GN ...
    assert KG.k3_viable(65536, 320, 32, bf16)          # ... goes to K3
    assert not KG.k2_viable(262144, 128, 32, bf16)     # VAE GN at 512x512
    assert KG.k3_viable(262144, 128, 32, bf16)
    # up-block-1 resnet GN: 2560 channels, a one-group stripe of 160 (bf16)
    # or 320 (fp32) bytes a row, held by a cluster at 768 and 1024x1024
    assert KG.k2_viable(576, 2560, 32, fp32)
    assert KG.k2_viable(1024, 2560, 32, bf16)
    assert KG.k3_viable(1024, 2560, 32, bf16)
    n_sites = 0
    sizes = ((512, 512), (768, 768), (576, 1024), (1024, 1024))
    for (height, width), sites in _gn_sites(sizes).items():
        assert (32, height * width // 1024, 2560, 32) in sites  # up block 1
        n_sites += len(sites)
        for B, S, C, G in sites:
            for itemsize in (bf16, fp32):
                assert (KG.k2_viable(S, C, G, itemsize)
                        or KG.k3_viable(S, C, G, itemsize)), \
                    (height, width, S, C, G, itemsize)
    assert n_sites > 60


# Three tests per file, each looping over its cases: pytest-xdist's
# loadfile mode hands out files with many tests first, and this file's few
# tests keep it behind the suite's heavy files.
K1_CASES = [(2, 512, 512, 2, 16),
            (1, 512, 700, 2, 40)]  # ragged KV tail: masked keys
K4_CASES = [(2, 200, 200, 2, 160),  # two KV blocks of 128, the last ragged
            (1, 150, 150, 2, 20),   # D % 8 != 0
            (1, 130, 130, 1, 256)]
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
    ("blockdiag", np.float32, 16, 16),  # K6, vdx's default block 512
    ("blockdiag", "bf16", 16, 16),
    ("xla_bf16p_packed", "bf16", 16, 16),  # 8 rows packed, batch padded
    ("xla_bf16p_packed", "bf16", 24, 24),  # 5 rows packed
    ("xla_bf16p_packed", "bf16", 16, 77),  # Skv != Sq: xla_bf16p
]
TEMPORAL_CASES = [  # (kernel, P, F, H, D, dtype): P * F % 128 != 0
    ("k6", 40, 16, 2, 40, "fp32"),
    ("k6", 12, 8, 3, 16, "bf16"),
    ("k7", 40, 16, 2, 40, "bf16"),
    ("k7", 12, 8, 3, 16, "fp32"),
    ("k8", 40, 16, 2, 40, "fp32"),
    ("k8", 8, 16, 2, 160, "bf16"),   # D = 160 (levels 2-3)
    ("k9", 40, 16, 2, 40, "bf16"),
    ("k9", 12, 24, 3, 16, "fp32"),   # F = 24: K9 only (F | block for K6-K8)
]


def test_kernel_plain_versions_match_pallas():
    for case in K1_CASES:
        _check_k1_plain_against_pallas(*case)
    for case in K4_CASES:
        _check_k4_plain_against_pallas(*case)
    for case in GN_KERNEL_CASES:
        _check_gn_plain_against_pallas(*case)
    for case in TEMPORAL_CASES:
        _check_temporal_plain_against_pallas(*case)


def test_ops_match_vdx():
    for shape, eps in GN_OP_CASES:
        for silu in (False, True):
            _check_group_norm_against_vdx(shape, eps, silu)
    for case in ATTENTION_CASES:
        _check_attention_against_vdx(*case)
    _check_masked_attention_against_vdx()
    for D in (40, 160):
        _check_flash_dispatch_against_vdx(D)


def test_ops_raise_on_what_is_not_ported_and_gate_main_path():
    _check_group_norm_sharded_forms()
    _check_attention_ring_needs_a_bound_axis()
    _check_temporal_wrappers_keep_vdx_preconditions()
    _check_gn_gate_covers_the_main_path_shapes()
