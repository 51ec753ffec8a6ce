"""The port's one source of sampling noise: a counter hash into Gumbel noise.

A TPU kernel drew its random bits from the chip's own generator, which no
other device reproduces.  The port's kernels and their plain twins instead
hash a counter: ``mix32`` chained over the seed and the draw's keys, 24 bits
kept, ``u = bits / 2^24 + 1e-12``, ``g = -log(-log(u))``.  The CUDA kernels,
the decode kernels and the categorical sampler (``csrc/categorical.cu``)
alike, include the same hash from ``csrc/noise.cuh``, so a kernel and its
plain twin see the same noise, and a decode's noise does not depend on how
its steps are split into launches.

Keys: the decode kernels hash (seed, absolute step, stream, class)
(:func:`gumbel_noise`); the categorical sampler hashes (seed, row, class)
(:func:`gumbel_rows`).
"""
from __future__ import annotations

import torch

__all__ = ["mix32", "mix32_int", "gumbel_noise", "gumbel_rows"]

_MIX1, _MIX2 = 0x7FEB352D, 0x846CA68B
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 values held in int64, without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit finaliser of ``csrc/noise.cuh``, on uint32 values held in
    int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def mix32_int(x: int) -> int:
    """``mix32`` of one Python integer (a kernel's seed key, hashed on the
    host without a tensor op)."""
    x &= _M32
    x ^= x >> 16
    x = (x * _MIX1) & _M32
    x ^= x >> 15
    x = (x * _MIX2) & _M32
    return x ^ (x >> 16)


def _gumbel(bits: torch.Tensor) -> torch.Tensor:
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
    return -torch.log(-torch.log(u))


def _row_keys(seed: int, B: int, device, *prefix: int) -> torch.Tensor:
    s = mix32(torch.tensor(seed & _M32, dtype=torch.int64, device=device))
    for key in prefix:
        s = mix32(s ^ (key & _M32))
    return mix32(s ^ torch.arange(B, dtype=torch.int64, device=device))[:, None]


def gumbel_noise(seed: int, t: int, B: int, Q: int, device) -> torch.Tensor:
    """(B, Q) f32 Gumbel noise of decode step ``t``: the hash of (seed, t,
    stream, class)."""
    q = torch.arange(Q, dtype=torch.int64, device=device)[None, :]
    return _gumbel(mix32(_row_keys(seed, B, device, t) ^ q))


def gumbel_rows(seed: int, B: int, Q: int, device) -> torch.Tensor:
    """(B, Q) f32 Gumbel noise of a categorical draw over B rows: the hash of
    (seed, row, class)."""
    q = torch.arange(Q, dtype=torch.int64, device=device)[None, :]
    return _gumbel(mix32(_row_keys(seed, B, device) ^ q))
