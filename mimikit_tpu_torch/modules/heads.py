"""MLP head with learned temperature (counterpart of
``mimikit_tpu/modules/heads.py:18-57``).

The last logit parameterizes a per-position temperature (sigmoid, floored at
``min_temperature``) dividing the remaining logits.  The dense layers live in
``self.fc`` interleaved with the activations, so the state_dict names are
PyTorch mimikit's (``fc.0.weight``, ``fc.2.weight``, ...; under
``weight_norm`` ``fc.0.weight_g`` and ``fc.0.weight_v``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import rounding
from .activations import Mish
from .weight_norm import make_dense

__all__ = ["MLP", "learned_temperature", "sigmoid"]


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``.  Below f32 it is ``1 / (1 + exp(-x))`` with each
    op rounded to x's dtype, as XLA expands the logistic there (one rounding
    at the end, ``torch.sigmoid``'s, parts from it in about a third of bf16
    values), and on the CPU its gradient JAX's (``rounding.sigmoid``)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return rounding.sigmoid(x)


def learned_temperature(logits: torch.Tensor, min_temperature: float) -> torch.Tensor:
    """``logits[..., :-1] / max(sigmoid(logits[..., -1:]), min_temperature)``
    (below f32, on the CPU, with JAX's gradient: ``rounding.learned_temperature``)."""
    if logits.dtype != torch.float32:
        return rounding.learned_temperature(logits, min_temperature)
    temp = sigmoid(logits[..., -1:])
    return logits[..., :-1] / torch.clamp_min(temp, min_temperature)


class MLP(nn.Module):
    def __init__(
        self,
        in_dim: int,
        hidden_dim: int,
        out_dim: int,
        n_hidden_layers: int = 0,
        activation: Optional[nn.Module] = None,
        use_bias: bool = True,
        dropout: float = 0.0,
        min_temperature: Optional[float] = 1e-4,
        weight_norm: bool = False,
    ):
        super().__init__()
        act = activation if activation is not None else Mish()
        self.min_temperature = min_temperature
        self.dropout = dropout

        def dense(i, o):
            return make_dense(i, o, bias=use_bias, weight_norm=weight_norm)

        layers = [dense(in_dim, hidden_dim), act]
        for _ in range(n_hidden_layers):
            layers += [dense(hidden_dim, hidden_dim), act]
        out = out_dim + int(min_temperature is not None)
        layers.append(dense(hidden_dim, out))
        self.fc = nn.Sequential(*layers)

    def forward(self, x):
        h = x
        for i, layer in enumerate(self.fc):
            h = layer(h)
            if i % 2 == 1 and self.dropout > 0:
                h = F.dropout(h, self.dropout, self.training)
        if self.min_temperature is not None:
            return learned_temperature(h, self.min_temperature)
        return h
