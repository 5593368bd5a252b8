"""vdx_torch.core.rng against jax.random, and the fp32 policy's TF32
scope, on the CPU.

The port draws vdx's initial noise, ``jax.random.normal(PRNGKey(seed),
shape, float32)``, itself (threefry2x32 with partitionable counters). The
bits must equal ``jax.random.bits`` exactly. The normals go through XLA's
fp32 erfinv polynomial on both sides, but log1p and the polynomial's
multiply-adds round differently (XLA fuses them into FMAs): measured on
these seeds and shapes, at most 3 fp32 ulps of the element apart (7.2e-7
absolute), 95% bit-equal. The bar is 4 ulps of each element. (torch's own
``special.erfinv`` lands up to 91 ulps, 2.2e-5, away: not used.)
"""

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
