"""Activation factory (counterpart of ``mimikit_tpu/modules/activations.py``).

``ActivationConfig.get()`` returns an ``nn.Module``.  The port carries the
stateless activations; the learned variants (scaled, phase) are not ported
yet and raise.
"""
from __future__ import annotations

import dataclasses as dtc
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, private_runtime_field
from . import rounding

__all__ = ["ActivationConfig", "Mish", "Lambda", "mish"]


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x * tanh(softplus(x))`` — the MLP head's hidden activation.  Below
    f32 each step of JAX's softplus (``max(x, 0) + log1p(exp(-|x|))``) and
    of the product rounds to the input's dtype, as JAX's ops do (and on the
    CPU their backward too: ``rounding.mish``)."""
    if x.dtype == torch.float32:
        return x * torch.tanh(F.softplus(x))
    return rounding.mish(x)


def _below_f32(f32, other):
    """``f32`` on f32 tensors, ``other`` (``rounding``'s op) below f32."""
    return lambda x: f32(x) if x.dtype == torch.float32 else other(x)


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class Lambda(nn.Module):
    """Stateless activation wrapper so plain functions compose as modules."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _glu(x):
    a, b = torch.chunk(x, 2, dim=-1)
    return a * torch.sigmoid(b)


_PLAIN = {
    "Tanh": _below_f32(torch.tanh, rounding.tanh),
    "Sigmoid": _below_f32(torch.sigmoid, rounding.sigmoid),
    "Mish": mish,
    "ReLU": torch.relu,
    "Softplus": F.softplus,
    "Identity": lambda x: x,
    "Abs": torch.abs,
    "Sin": torch.sin,
    "Cos": torch.cos,
    "GLU": _glu,
    "Softmax": lambda x: torch.softmax(x, dim=-1),
}


@dtc.dataclass
class ActivationConfig(Config, type_field=False):
    act: str = "Identity"
    scaled: bool = False
    static: bool = False
    with_rate: bool = False
    params: Dict = dtc.field(default_factory=lambda: {})
    dim: int = private_runtime_field(None)

    def get(self) -> nn.Module:
        act = str(self.act)
        if self.scaled or act not in _PLAIN:
            raise NotImplementedError(
                f"activation {act!r} (scaled={self.scaled}) is not ported"
            )
        return Mish() if act == "Mish" else Lambda(_PLAIN[act])
