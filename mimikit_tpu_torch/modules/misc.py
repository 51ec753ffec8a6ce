"""Shape helpers (counterpart of ``mimikit_tpu/modules/misc.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["causal_pad", "unfold"]


def causal_pad(x: torch.Tensor, pad: Tuple[int, ...], value: float = 0.0) -> torch.Tensor:
    """Pad the last ``len(pad)`` axes, in order: a positive entry pads on the
    left (the past), a negative one on the right.

    This is the JAX package's convention (``pad[i]`` maps to axis
    ``-len(pad) + i``), not ``torch.nn.functional.pad``'s, which lists the
    last axis first; so ``causal_pad(x, (p, 0))`` on a (B, T, D) tensor pads
    the time axis."""
    widths = []
    for p in reversed(pad):
        widths += [p, 0] if p >= 0 else [0, -p]
    return F.pad(x, widths, value=value)


def unfold(x: torch.Tensor, dim: int, size: int, step: int) -> torch.Tensor:
    """Sliding windows of ``size`` every ``step`` along ``dim``, the window
    axis appended last (``mimikit_tpu/modules/misc.py:36``, which follows
    ``torch.Tensor.unfold``)."""
    return x.unfold(dim, size, step)
