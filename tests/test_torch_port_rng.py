"""vdx_torch.core.rng against jax.random, the fp32 policy's TF32 scope,
and the dtype and layout rule that routes flash attention to its CUDA
kernels, on the CPU.

The port draws vdx's initial noise, ``jax.random.normal(PRNGKey(seed),
shape, float32)``, itself (threefry2x32 with partitionable counters). The
bits must equal ``jax.random.bits`` exactly. The normals go through XLA's
fp32 erfinv polynomial on both sides, but log1p and the polynomial's
multiply-adds round differently (XLA fuses them into FMAs): measured on
these seeds and shapes, at most 3 fp32 ulps of the element apart (7.2e-7
absolute), 95% bit-equal. The bar is 4 ulps of each element. (torch's own
``special.erfinv`` lands up to 91 ulps, 2.2e-5, away: not used.)
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdx_torch.core import rng
from vdx_torch.core.dtypes import BF16_POLICY, FP32_POLICY, exact_fp32

SEEDS = (0, 42, 2 ** 31 + 5, 2 ** 32 + 7)  # the last wraps to 32 bits, as vdx
# an odd element count, and the 512x512 latents
SHAPES = ((3, 5, 11), (1, 16, 64, 64, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@jax.jit
def _jax_draws(key):
    """jax.random.bits and jax.random.normal at every shape, one program
    (one XLA compile for all seeds)."""
    return [(jax.random.bits(key, shape, jnp.uint32),
             jax.random.normal(key, shape, jnp.float32)) for shape in SHAPES]


def test_noise_matches_jax_random():
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        assert rng.prng_key(seed) == tuple(
            int(w) for w in np.asarray(jax.random.key_data(key)))
        for shape, (want_bits, want) in zip(SHAPES, _jax_draws(key)):
            got_bits = rng.random_bits(seed, shape).numpy()
            np.testing.assert_array_equal(
                got_bits, np.asarray(want_bits).astype(np.int64))
            want = np.asarray(want)
            got = rng.normal(seed, shape).numpy()
            assert got.dtype == np.float32 and got.shape == shape
            ulps = np.abs(got - want) / np.spacing(np.abs(want))
            assert ulps.max() <= 4, (seed, shape, ulps.max())


def test_fp32_policy_turns_tf32_off_only_in_its_scope():
    """exact_fp32 flips and restores the two flags on a CUDA device (the
    flags are process-wide and need no card to read); bf16 policies and
    CPU devices leave them alone. The card-side forward check is in
    test_torch_port_kernels_cuda.py."""
    flags = (lambda: (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32))
    saved = flags()
    try:
        for before in ((True, True), (True, False), (False, True)):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = before
            with exact_fp32(FP32_POLICY, "cuda"):
                assert flags() == (False, False)
            assert flags() == before
            with exact_fp32(BF16_POLICY, "cuda"), exact_fp32(FP32_POLICY, "cpu"):
                assert flags() == before
            with pytest.raises(KeyError), exact_fp32(FP32_POLICY, "cuda:0"):
                raise KeyError  # restored on the way out of an error too
            assert flags() == before
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_flash_attention_routing_rule():
    """kernels.flash_attention.kernel_for and counter_for, which both
    wrappers call, for every case they see: each exp_impl form and K4
    (None), bf16 and fp32, head dims 8..256, rows 16-byte aligned or not.
    Every bf16 form and K4 at D % 8 == 0, D <= 256 on aligned rows go to
    the wgmma + TMA pipeline (K1, K4 and exp to its K1/K4 source, the other
    K1' forms and K5 to its forms source); every other bf16 case to the
    mma.sync template; fp32 always to the SIMT kernel. Every route names a
    CUDA source, never the plain version (which runs for CPU tensors
    only)."""
    from vdx_torch.kernels import flash_attention as KA

    csrc = pathlib.Path(KA.__file__).resolve().parent.parent / "csrc"
    seen = {}
    for form in (*KA.EXP_IMPLS, None):
        for dtype in (torch.bfloat16, torch.float32):
            for D in (8, 40, 80, 128, 160, 168, 256):
                for aligned in (True, False):
                    seen[form, dtype, D, aligned] = KA.kernel_for(
                        form, dtype, D, aligned)
    on_sm90 = {(form, torch.bfloat16, D, True) for form in (*KA.EXP_IMPLS, None)
               for D in (8, 40, 80, 128, 160, 168, 256)}
    for case, name in seen.items():
        want = (KA.SIMT if case[1] == torch.float32 else
                KA.TEMPLATE if case not in on_sm90 else
                KA.SM90 if case[0] in ("staticmax", "exp", None) else
                KA.SM90_FORMS)
        assert name == want, (case, name)
        assert (csrc / f"{name}.cu").is_file() and "plain" not in name, name
    assert seen["staticmax", torch.bfloat16, 40, True] == KA.SM90
    assert seen["staticaug", torch.bfloat16, 160, True] == KA.SM90_FORMS
    assert {KA.SM90, KA.SM90_FORMS}.isdisjoint(
        {n for c, n in seen.items() if c[1] == torch.float32})
    assert KA.kernel_for(None, torch.bfloat16, 20, True) == KA.TEMPLATE
    # each route's counter (counter_for): the form's own name on the
    # wgmma + TMA pipeline (K1, K4, K1' ..., K5), " template" names off
    # it ("K1 static" and "K4 template" for K1 and K4); every name one of
    # launch_counts' counters, no name on two kernels
    counts = KA.launch_counts()
    on_kernel = {}
    for case, name in seen.items():
        counter = KA.counter_for(*case)
        assert counter in counts, (case, counter)
        on_sm90_route = name in (KA.SM90, KA.SM90_FORMS)
        off_names = ("K1 static", "K4 template")
        assert on_sm90_route == (not counter.endswith(" template")
                                 and counter not in off_names), (case, counter)
        on_kernel.setdefault(counter, set()).add(on_sm90_route)
    assert all(len(v) == 1 for v in on_kernel.values()), on_kernel
    assert set(on_kernel) == set(counts), set(counts) ^ set(on_kernel)
    for D, aligned in ((256, False), (40, False), (160, False)):
        assert KA.counter_for("staticmax", torch.bfloat16, D, aligned) \
            == "K1 static"
        assert KA.counter_for("staticaug", torch.bfloat16, D, aligned) \
            == "K5 template"
        assert KA.counter_for("exp2", torch.bfloat16, D, aligned) \
            == "K1' exp2 template"
    assert KA.counter_for("staticaug", torch.bfloat16, 40, True) == "K5"
    assert KA.counter_for("exp", torch.bfloat16, 80, True) == "K1' exp"
    assert KA.counter_for("noexp", torch.float32, 40, True) \
        == "K1' noexp template"
    assert KA.counter_for(None, torch.bfloat16, 256, True) == "K4"
    assert KA.counter_for(None, torch.bfloat16, 256, False) == "K4 template"
