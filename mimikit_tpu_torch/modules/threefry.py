"""The JAX package's seeded uniform draws, on the host.

``jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=, maxval=)``
under JAX's default generator: threefry2x32 (20 rounds) over the flat
index of each element as a 64-bit counter, the two output words XORed (the
"partitionable" bits), the top 23 bits as the mantissa of a float in
[1, 2).  ``ScaledOutputsL1`` draws its scales here, so a seed gives the
JAX package's values, not only its distribution.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["threefry2x32", "uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the words (x0, x1) under the key (k0, k1)."""
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform(seed: int, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 draws in [minval, maxval), equal to
    ``jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=minval,
    maxval=maxval)``."""
    seed = int(seed) % 2**64
    counter = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    b0, b1 = threefry2x32(seed >> 32, seed & 0xFFFFFFFF,
                          (counter >> np.uint64(32)).astype(np.uint32),
                          counter.astype(np.uint32))
    mantissa = ((b0 ^ b1) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = mantissa.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).reshape(tuple(shape))
