"""The routing rules of vdx_torch's attention kernels, and the plain
versions at the head dims and frame counts those rules now send to the
redesigned kernels, on the CPU.

* ``kernels.flash_attention.kernel_for`` / ``counter_for`` over every
  form x dtype x head dim x row alignment: bf16 at D % 8 == 0 up to 256 on
  16-byte aligned rows runs the wgmma + TMA pipeline (past D = 160 its
  one-consumer-warpgroup instance), everything else the mma.sync template
  (bf16) or the SIMT kernel (fp32). Pure Python.
* ``temporal_kernel_for`` and ``launch_temporal``'s range checks: bf16
  K6-K8 on the tensor cores, K9 and fp32 on the FMA pipes, 1..32 frames,
  head dims 1..160. Pure Python.
* The plain versions, which the kernels are held to on the card, against
  vdx's Pallas kernels in interpret mode at the new shapes: K1
  (staticmax ``flash_attention_dt``) and K4 at D = 256, and K6, K7, K9 at
  D = 160 with 16 frames (the motion modules' level-2 and level-3 head
  dim), in fp32 and bf16.

Inputs come from numpy with a seed and go to both sides. Tolerances: fp32
2e-5 absolute (the vdx kernel tests' bar: the same arithmetic summed in
another order); bf16 one bf16 ulp at the largest output magnitude (both
sides round at the same points from fp32 sums in another order).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdx.kernels import flash_attention as JK
from vdx.kernels.temporal_attention_cp import temporal_attention_cp as jax_k9
from vdx_torch.kernels import flash_attention as KA
from vdx_torch.kernels import temporal_attention_cp as KT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_flash_routing_sends_head_dims_to_256_to_the_pipeline():
    """Every form and K4 (None), bf16 and fp32, head dims 8..256 in steps
    of 8 plus ones that are not multiples of 8, rows aligned or not: the
    pipeline takes exactly bf16, D % 8 == 0, 8 <= D <= 256, aligned rows
    (K1, K4 and exp in its K1/K4 source, the rest in its forms source);
    the template keeps only unaligned rows and D % 8 != 0; fp32 always
    the SIMT kernel. Each route's counter is the pipeline's name on it
    and a " template" name (or "K1 static", "K4 template") off it."""
    csrc = pathlib.Path(KA.__file__).resolve().parent.parent / "csrc"
    assert KA.SM90_MAX_D == KA.MAX_D == 256
    dims = list(range(8, 257, 8)) + [20, 164, 250]
    counts = KA.launch_counts()
    for form in (*KA.EXP_IMPLS, None):
        k1k4 = form in (None, "staticmax", "exp")
        for dtype in (torch.bfloat16, torch.float32):
            for D in dims:
                for aligned in (True, False):
                    case = (form, dtype, D, aligned)
                    kernel = KA.kernel_for(*case)
                    counter = KA.counter_for(*case)
                    on_pipeline = (dtype == torch.bfloat16 and aligned
                                   and D % 8 == 0)
                    want = (KA.SIMT if dtype == torch.float32 else
                            KA.TEMPLATE if not on_pipeline else
                            KA.SM90 if k1k4 else KA.SM90_FORMS)
                    assert kernel == want, (case, kernel)
                    assert (csrc / f"{kernel}.cu").is_file(), kernel
                    assert counter in counts, (case, counter)
                    off = (KA.TEMPLATE_KERNEL[form] if form else "K4 template")
                    on = KA.FORM_KERNEL[form] if form else "K4"
                    assert counter == (on if on_pipeline else off), \
                        (case, counter)
    # the new instance: head dims 168..256 on the pipeline, named as below
    # 160; the same dims on unaligned rows stay on the template
    for D in (168, 200, 248, 256):
        assert KA.counter_for("staticmax", torch.bfloat16, D, True) == "K1"
        assert KA.counter_for(None, torch.bfloat16, D, True) == "K4"
        assert KA.counter_for("staticaug", torch.bfloat16, D, True) == "K5"
        assert KA.counter_for("fastexp2", torch.bfloat16, D, True) \
            == "K1' fastexp2"
        assert KA.counter_for("staticmax", torch.bfloat16, D, False) \
            == "K1 static"
    assert KA.counter_for(None, torch.bfloat16, 250, True) == "K4 template"


def test_temporal_routing_and_range_checks():
    """bf16 K6 (blockdiag) and K7/K8 (tc) on the tensor-core kernel, K9
    (cp) in both dtypes and fp32 K6-K8 on the SIMT kernel, both in
    csrc/temporal_attention.cu; launch_temporal raises past 32 frames or
    past head dim 160, and on CPU tensors, before any launch."""
    csrc = pathlib.Path(KA.__file__).resolve().parent.parent / "csrc"
    assert (csrc / "temporal_attention.cu").is_file()
    for mode in KA.TEMPORAL_MODES:
        for dtype in (torch.bfloat16, torch.float32):
            want = (KA.TEMPORAL_MMA if dtype == torch.bfloat16 and mode != "cp"
                    else KA.TEMPORAL_SIMT)
            assert KA.temporal_kernel_for(mode, dtype) == want, (mode, dtype)
    with pytest.raises(ValueError, match="mode"):
        KA.temporal_kernel_for("blockdiag_tc", torch.bfloat16)
    assert (KA.TEMPORAL_MAX_F, KA.TEMPORAL_MAX_D) == (32, 160)
    for shape, match in (((4, 33, 2, 40), "frames"),
                         ((4, 16, 2, 168), "head dims"),
                         ((4, 0, 2, 40), "frames"),
                         ((4, 32, 2, 160), "cuda or cpu")):
        t = torch.zeros(shape, dtype=torch.bfloat16)
        for mode in KA.TEMPORAL_MODES:
            with pytest.raises(ValueError, match=match):
                KA.launch_temporal(mode, f"temporal {mode}", t, t, t, 1.0)
    t = torch.zeros(4, 16, 2, 40, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        KA.launch_temporal("tc", "K7", t, t, t, 1.0)


def _inputs(seed, shapes, dtype):
    """numpy fp32 standard normals -> (jax arrays, torch tensors) in dtype."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got: torch.Tensor, want, dtype: str, what: str) -> None:
    want = np.asarray(want.astype(jnp.float32))
    atol = 2e-5 if dtype == "fp32" else 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0,
                               err_msg=what)


def test_plain_versions_at_the_new_shapes_match_pallas():
    """K1 and K4 at [1, 128, 1, 256] (the pipeline's new instance) and K6,
    K7, K9 at [8, 16, 2, 160] (the temporal kernel's redesigned modes at
    the motion modules' D = 160), fp32 and bf16, against vdx's Pallas
    kernels in interpret mode."""
    for dtype in ("fp32", "bf16"):
        (jq, jk, jv), (tq, tk, tv) = _inputs(21, [(1, 128, 1, 256)] * 3, dtype)
        scale = 256 ** -0.5
        with pltpu.force_tpu_interpret_mode():
            k1 = JK.flash_attention_dt(jq, jk, jv, scale=scale, block_q=128,
                                       block_k=128, exp_impl="staticmax")
            k4 = JK.flash_attention(jq, jk, jv, scale=scale, block_q=128,
                                    block_k=128)
        got = KA.flash_attention_dt(tq, tk, tv, scale=scale, block_q=128,
                                    block_k=128, exp_impl="staticmax")
        _close(got, k1, dtype, f"K1 D=256 {dtype}")
        _close(KA.flash_attention(tq, tk, tv, scale=scale), k4, dtype,
               f"K4 D=256 {dtype}")

        P, F, H, D = 8, 16, 2, 160  # P * F = 128: one of vdx's token blocks
        (jq, jk, jv), (tq, tk, tv) = _inputs(22, [(P, F, H, D)] * 3, dtype)
        scale = D ** -0.5
        with pltpu.force_tpu_interpret_mode():
            k6 = JK.flash_attention_blockdiag(jq, jk, jv, scale=scale,
                                              block=128)
            k7 = JK.flash_attention_blockdiag_tc(jq, jk, jv, scale=scale,
                                                 heads=H, block=128)
            k9 = jax_k9(jq, jk, jv, scale=scale, block_p=P, interpret=True)
        _close(KA.flash_attention_blockdiag(tq, tk, tv, scale=scale,
                                            block=128), k6, dtype,
               f"K6 D=160 {dtype}")
        _close(KA.flash_attention_blockdiag_tc(tq, tk, tv, scale=scale,
                                               heads=H, block=128), k7, dtype,
               f"K7 D=160 {dtype}")
        _close(KT.temporal_attention_cp(tq, tk, tv, scale=scale, block_p=P),
               k9, dtype, f"K9 D=160 {dtype}")
