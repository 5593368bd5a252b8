"""Seeded noise that equals vdx's (port of vdx/core/rng.py's ``as_key`` and
``noise_for_shape``: ``jax.random.normal(jax.random.PRNGKey(seed), shape,
float32)``), on any torch device, and the keyed draws FreeNoise takes
(``jax.random.split``, ``normal`` from a key, ``permutation``).

vdx draws its initial latents from JAX's threefry2x32 generator, so the
port computes the same function instead of ``torch.randn``: a seed gives
vdx's video, and the CPU and the card give the same noise.

* Key (``jax.random.PRNGKey`` as vdx runs it, ``jax_enable_x64`` off):
  the seed is taken as a 32-bit integer, so the key is
  [0, seed mod 2^32]. (With x64 on, JAX would put seed >> 32 in the
  first word; vdx never enables it.)
* Split (the same flag): key i of ``split(key, n)`` is the pair
  threefry2x32(key, (0, i)).
* Permutation of n: rounds of (split, 32 bits an element from the second
  key, a stable sort of the elements by their bits).
* Bits (``jax_threefry_partitionable`` True, JAX's default): element i of
  the flattened shape gets the counter pair (i >> 32, i mod 2^32);
  threefry2x32(key, counter) gives (b1, b2) and the element's 32 bits are
  b1 ^ b2.
* Uniform on [nextafter(-1, 0), 1): the top 23 bits as the mantissa of a
  float in [1, 2), minus 1, times (1 - lo) (2.0 in fp32), plus lo, clamped
  at lo.
* Normal: sqrt(2) * erfinv(u), with XLA's fp32 ``ErfInv`` polynomial
  (M. Giles, "Approximating the erfinv function"), ported below, so the
  normals follow the same fp32 operations as vdx's.

The integer arithmetic runs on int64 tensors masked to 32 bits (torch's
uint32 support is thin): every intermediate stays below 2^63.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
# threefry2x32's rotation schedule and key-schedule parity constant
# (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", 2011)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's ErfInv32 coefficients: w < 5 and w >= 5 branches, highest first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


class PRNGKey(tuple):
    """A key's two 32-bit words (a tuple), marked as a key so that an API
    taking seeds can tell it from a pair of seeds."""


def prng_key(seed: int) -> PRNGKey:
    """``jax.random.PRNGKey(seed)``'s two words, as vdx builds it."""
    return PRNGKey((0, int(seed) & _M32))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: tuple, x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 (20 rounds) of the counter pairs (x0, x1) under
    ``key``; int64 tensors holding uint32 values -> (b1, b2)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def split(key: tuple, num: int = 2) -> list:
    """``jax.random.split(key, num)`` (partitionable threefry): key i is
    threefry2x32(key, (0, i)), computed on the host -> ``num`` keys."""
    idx = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(key, torch.zeros_like(idx), idx)
    return [PRNGKey((int(a), int(b))) for a, b in zip(b1.tolist(), b2.tolist())]


def key_bits(key: tuple, shape: Sequence[int],
             device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(tuple(shape))


def random_bits(seed: int, shape: Sequence[int],
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.bits(PRNGKey(seed), shape, uint32)`` as int64 values in
    [0, 2^32)."""
    return key_bits(prng_key(seed), shape, device)


def permutation(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` on the host (int64 [n]): per
    round (ceil(3 ln n / ln(2^32 - 1)) of them, one for n < 1626) the key
    splits, the second key draws 32 bits an element, and the elements
    are stably sorted by those bits."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(key_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 ErfInv: a degree-8 polynomial in w = -log1p(-x^2),
    shifted by 2.5 (w < 5) or in sqrt(w) - 3 (w >= 5), times x;
    +-inf at |x| = 1."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(small, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def key_normal(key: tuple, shape: Sequence[int],
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device``."""
    bits = key_bits(key, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    lo = torch.tensor(_LO, dtype=torch.float32, device=device)
    span = torch.tensor(1.0, dtype=torch.float32, device=device) - lo  # 2.0
    u = torch.clamp_min(f * span + lo, _LO)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=device) \
        * _erfinv_f32(u)


def normal(seed: int, shape: Sequence[int],
           device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)`` on
    ``device``."""
    return key_normal(prng_key(seed), shape, device)


def normal_batch(seeds: Sequence[int], shape: Sequence[int],
                 device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """vdx's initial noise for a batch of videos (``_noise_maker`` with
    B > 1): [len(seeds), *shape], video b ``jax.random.normal(
    PRNGKey(seeds[b]), shape)``, so it equals the single draw of seed b."""
    return torch.stack([normal(s, shape, device) for s in seeds])
