"""The dense layer as flax's ``Dense`` computes it, in any dtype.

``dense`` is ``x @ W^T + b``.  In f32 it is ``F.linear``.  Below f32 the
product is rounded to the input's dtype before the bias is added, and the
sum rounds again, as flax's ``Dense`` does with bf16 parameters (a
``dot_general`` in bf16, then the bias added in bf16); the bias's gradient
is summed in bf16 in XLA's order on the CPU (``rounding.bias_add``).  The port's bf16
window re-feed runs on a bf16 copy of the net (``precision.cast_floats``),
and the bf16 training policy runs the forward on bf16 parameters, so their
dense layers take this path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import rounding
from .rounding import bias_add

__all__ = ["dense", "Dense"]


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ weight.T + bias``, rounded as flax's Dense rounds it (see the
    module note)."""
    if x.dtype == torch.float32 or bias is None:
        return F.linear(x, weight, bias)
    y = rounding.linear(x, weight) if x.device.type == "cpu" else F.linear(x, weight)
    return bias_add(y, bias)


class Dense(nn.Linear):
    """``nn.Linear`` (the same parameters and state_dict names) whose forward
    is :func:`dense`."""

    def forward(self, x):
        return dense(x, self.weight, self.bias)
