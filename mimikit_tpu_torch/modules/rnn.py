"""Recurrent stacks with explicit carried state (counterpart of
``mimikit_tpu/modules/rnn.py``).

``LSTM`` keeps PyTorch mimikit's state_dict names (``weight_ih_l0``,
``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``) with flax
``OptimizedLSTMCell`` semantics: gate order i|f|g|o, ``c' = f*c + i*g``,
``h' = o*tanh(c')``, and ONE bias, on the hidden projection.  That bias is
the parameter ``bias_hh_l{k}``; ``bias_ih_l{k}`` keeps its state_dict name
but is a buffer held at zero, so no optimizer moves it.  A non-zero
``bias_ih`` in a loaded state_dict (a PyTorch mimikit checkpoint) is folded
into ``bias_hh``, as ``mimikit_tpu/migrate.py`` sums the two.

The sequence path (:meth:`LSTM.forward_seq`, the train forward) asks
:func:`~mimikit_tpu_torch.ops.fused_lstm.lstm_route` for each layer, as the
JAX package's ``RNNStack._use_fused_lstm`` decides between its Pallas kernel
and its ``lax.scan``: on the "cluster" and "wide" routes the layer runs
through :func:`~mimikit_tpu_torch.ops.fused_lstm.fused_lstm_layer` (on the
card the hand-written forward and backward kernels, on the CPU their plain
versions); on the "scan" route, outside JAX's kernel gate, a step loop of
:func:`lstm_step` under autograd.  The CPU takes the same route as the card,
and past the kernels' limits, where the card raises, the plain versions.
:meth:`LSTM.step` advances one timestep (the decode path).

Under ``weight_norm`` (flax's ``nn.WeightNorm`` around each
``OptimizedLSTMCell``, ``mimikit_tpu/modules/rnn.py:89-90``) the eight gate
kernels of a layer are normalised per unit, which in torch's packed i|f|g|o
matrices is per row: the parameters are ``weight_ih_l{k}_g`` (4H,) and
``weight_ih_l{k}_v`` (4H, D), and the same for ``weight_hh`` (4H, H)
(:func:`~.weight_norm.weight_norm`).  :meth:`LSTM.forward_seq` computes the
effective weights once a call, under autograd, and they go through
``lstm_route`` as a plain layer's do (JAX sends weight-normed stacks to its
scan, a limit of flax's wrapper: the kernel computes the same function on
the effective weights).

Carry layout, as in the JAX package: a tuple over layers of ``(c, h)``
pairs of (B, H) tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_lstm import fused_lstm_layer, lstm_route
from .weight_norm import weight_norm as _weight_norm

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
    dtype: torch.dtype = torch.float32,
) -> Tuple:
    """Initial carry: 'zeros' | 'ones' | 'randn' (the reference's ``h0_init``),
    in ``dtype``."""

    def one():
        shape = (batch_size, hidden_dim)
        if init == "zeros":
            return torch.zeros(shape, device=device, dtype=dtype)
        if init == "ones":
            return torch.ones(shape, device=device, dtype=dtype)
        if init == "randn":
            return torch.randn(shape, generator=generator).to(device, dtype)
        raise ValueError(init)

    return tuple((one(), one()) for _ in range(n_layers))


class LSTM(nn.Module):
    """Stacked LSTM over (B, T, D) with an explicit carry.  ``input_dim`` is
    the first layer's input width (default ``hidden_dim``: every other layer
    reads H); ``x @ W_ih`` is the product outside the recurrence, as the JAX
    package computes it outside its ``pallas_call``
    (``mimikit_tpu/ops/pallas_lstm.py:244-251``).  ``bidirectional`` adds a
    second set of weights a layer, torch's ``*_reverse`` (one layer only: the
    seq2seq net's ``_BiLSTMSum`` runs it on the flipped sequence)."""

    def __init__(self, hidden_dim: int, n_layers: int = 1, dropout: float = 0.0,
                 weight_norm: bool = False, input_dim: Optional[int] = None,
                 bidirectional: bool = False):
        super().__init__()
        if bidirectional and n_layers != 1:
            raise ValueError("a bidirectional LSTM here has one layer")
        self.hidden_size = hidden_dim
        self.input_size = hidden_dim if input_dim is None else input_dim
        self.num_layers = n_layers
        self.dropout = dropout
        self.weight_norm = weight_norm
        self.suffixes = ("", "_reverse") if bidirectional else ("",)
        H = hidden_dim
        for k in range(n_layers):
            for sfx in self.suffixes:
                for w, cols in ((f"weight_ih_l{k}{sfx}", self.input_size if k == 0 else H),
                                (f"weight_hh_l{k}{sfx}", H)):
                    if weight_norm:
                        setattr(self, f"{w}_g", nn.Parameter(torch.ones(4 * H)))
                        setattr(self, f"{w}_v", nn.Parameter(torch.empty(4 * H, cols)))
                    else:
                        setattr(self, w, nn.Parameter(torch.empty(4 * H, cols)))
                self.register_buffer(f"bias_ih_l{k}{sfx}", torch.zeros(4 * H))
                setattr(self, f"bias_hh_l{k}{sfx}", nn.Parameter(torch.empty(4 * H)))
        self._register_load_state_dict_pre_hook(self._fold_input_bias)

    def _fold_input_bias(self, state_dict, prefix, *args):
        for k in range(self.num_layers):
            for sfx in self.suffixes:
                b_ih, b_hh = f"{prefix}bias_ih_l{k}{sfx}", f"{prefix}bias_hh_l{k}{sfx}"
                if b_ih in state_dict and b_hh in state_dict:
                    state_dict[b_hh] = state_dict[b_hh] + state_dict[b_ih]
                    state_dict[b_ih] = torch.zeros_like(state_dict[b_ih])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's LSTM initialisation, U(-1/sqrt(H), 1/sqrt(H)), drawn from
        ``generator`` for the weights (under weight norm their ``_v``; ``_g``
        is ones, flax's ``scale_init``) and the single bias; ``bias_ih``
        stays 0."""
        bound = 1.0 / np.sqrt(self.hidden_size)
        sfx = "_v" if self.weight_norm else ""
        for k in range(self.num_layers):
            for d in self.suffixes:
                for name in (f"weight_ih_l{k}{d}{sfx}", f"weight_hh_l{k}{d}{sfx}",
                             f"bias_hh_l{k}{d}"):
                    p = getattr(self, name)
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
                if self.weight_norm:
                    getattr(self, f"weight_ih_l{k}{d}_g").fill_(1.0)
                    getattr(self, f"weight_hh_l{k}{d}_g").fill_(1.0)
                getattr(self, f"bias_ih_l{k}{d}").zero_()

    def _weight(self, name: str) -> torch.Tensor:
        if self.weight_norm:
            return _weight_norm(getattr(self, f"{name}_v"), getattr(self, f"{name}_g"))
        return getattr(self, name)

    def layer_weights(self, k: int, reverse: bool = False):
        """Layer ``k``'s ``(W_ih, W_hh, b_ih, b_hh)`` in torch's layout (4H, D)
        and (4H, H), under weight norm the effective weights; ``reverse``:
        the ``*_reverse`` set."""
        sfx = "_reverse" if reverse else ""
        return (self._weight(f"weight_ih_l{k}{sfx}"), self._weight(f"weight_hh_l{k}{sfx}"),
                getattr(self, f"bias_ih_l{k}{sfx}"), getattr(self, f"bias_hh_l{k}{sfx}"))

    def step(self, x, carry):
        """x: (B, D) one timestep -> (y, new_carry)."""
        new_carry = []
        y = x
        for layer, (c, h) in enumerate(carry):
            c, y = lstm_step(y, c, h, *self.layer_weights(layer))
            new_carry.append((c, y))
        return y, tuple(new_carry)

    def forward_seq(self, x, carry=None):
        """x: (B, T, D) -> (y (B, T, H), new_carry), each layer on its
        :func:`lstm_route` (:meth:`run_layer`).  The default carry is made
        in x's dtype, and each layer's outputs and carry come back in it
        (``mimikit_tpu/modules/rnn.py:172-177``): under a bf16 policy the rest
        of the net stays bf16."""
        if self.dropout > 0 and self.training:
            raise NotImplementedError("rnn_dropout is not ported")
        B = x.shape[0]
        if carry is None:
            carry = init_rnn_carry(self.num_layers, B, self.hidden_size, device=x.device,
                                   dtype=x.dtype)
        ys = x.transpose(0, 1)
        new_carry = []
        for k, (c0, h0) in enumerate(carry):
            ys, h_T, c_T = self.run_layer(k, ys, h0, c0)
            new_carry.append((c_T, h_T))
        return ys.transpose(0, 1), tuple(new_carry)

    def run_layer(self, k: int, xs, h0, c0, reverse: bool = False):
        """Layer ``k`` (its ``*_reverse`` weights where ``reverse``) over xs
        (T, B, D) time-major from the carry (h0, c0): ``(h_all (T, B, H), h_T,
        c_T)`` in xs's dtype, differentiable in xs, the weights and the
        carry.  The layer takes its :func:`lstm_route`: the fused LSTM layer
        (kernels on CUDA, plain versions on the CPU), or outside JAX's kernel
        gate a step loop (``mimikit_tpu/modules/rnn.py:181-187``)."""
        T, B, dt = xs.shape[0], xs.shape[1], xs.dtype
        weights = self.layer_weights(k, reverse)  # under weight norm computed once a call
        w_ih, w_hh, b_ih, b_hh = weights
        route = lstm_route(B, T, self.hidden_size, dt, cpu=xs.device.type == "cpu")
        if route == "scan":
            ys, h_T, c_T = self._scan(xs, h0, c0, weights)
        else:
            ys, h_T, c_T = fused_lstm_layer(xs, w_ih.t(), w_hh.t(), b_ih + b_hh, h0, c0,
                                            route=route)
        return ys.to(dt), h_T.to(dt), c_T.to(dt)

    @staticmethod
    def _scan(xs, h, c, weights):
        """A layer of ``weights`` over xs (T, B, D) as a step loop of
        :func:`lstm_step`: ``(h_all (T, B, H), h_T, c_T)``."""
        hs = []
        for x_t in xs:
            c, h = lstm_step(x_t, c, h, *weights)
            hs.append(h)
        return torch.stack(hs), h, c
