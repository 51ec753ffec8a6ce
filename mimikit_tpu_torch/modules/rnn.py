"""Recurrent stacks with explicit carried state (counterpart of
``mimikit_tpu/modules/rnn.py``).

``LSTM`` is ``torch.nn.LSTM`` (so the state_dict names are PyTorch mimikit's
``weight_ih_l0`` ...) with a :meth:`LSTM.step` that advances one timestep
with flax ``OptimizedLSTMCell`` semantics: gate order i|f|g|o,
``c' = f*c + i*g``, ``h' = o*tanh(c')``.  The flax cell has one bias, on the
hidden projection; ``weights.samplernn_state_dict_from_jax`` stores it in
``bias_hh`` and zeros in ``bias_ih``.

Carry layout, as in the JAX package: a tuple over layers of ``(c, h)``
pairs of (B, H) tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LSTM", "lstm_step", "init_rnn_carry"]


def lstm_step(x, c, h, w_ih, w_hh, b_ih=None, b_hh=None):
    """One LSTM cell step; returns ``(c', h')``."""
    gates = F.linear(x, w_ih, b_ih) + F.linear(h, w_hh, b_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return c2, h2


def init_rnn_carry(
    n_layers: int,
    batch_size: int,
    hidden_dim: int,
    init: str = "zeros",
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Tuple:
    """Initial carry: 'zeros' | 'ones' | 'randn' (the reference's ``h0_init``)."""

    def one():
        shape = (batch_size, hidden_dim)
        if init == "zeros":
            return torch.zeros(shape, device=device)
        if init == "ones":
            return torch.ones(shape, device=device)
        if init == "randn":
            return torch.randn(shape, generator=generator).to(device)
        raise ValueError(init)

    return tuple((one(), one()) for _ in range(n_layers))


class LSTM(nn.LSTM):
    def __init__(self, hidden_dim: int, n_layers: int = 1, dropout: float = 0.0):
        super().__init__(
            hidden_dim, hidden_dim, num_layers=n_layers, batch_first=True,
            dropout=dropout,
        )

    def step(self, x, carry):
        """x: (B, H) one timestep -> (y, new_carry)."""
        new_carry = []
        y = x
        for layer, (c, h) in enumerate(carry):
            c, y = lstm_step(
                y, c, h,
                getattr(self, f"weight_ih_l{layer}"),
                getattr(self, f"weight_hh_l{layer}"),
                getattr(self, f"bias_ih_l{layer}"),
                getattr(self, f"bias_hh_l{layer}"),
            )
            new_carry.append((c, y))
        return y, tuple(new_carry)

    def forward_seq(self, x, carry=None):
        """x: (B, T, H) -> (y (B, T, H), new_carry)."""
        if carry is None:
            y, (h_n, c_n) = super().forward(x)
        else:
            h0 = torch.stack([h for _, h in carry])
            c0 = torch.stack([c for c, _ in carry])
            y, (h_n, c_n) = super().forward(x, (h0, c0))
        return y, tuple((c_n[i], h_n[i]) for i in range(self.num_layers))
