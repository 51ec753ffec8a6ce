"""Weight normalisation as flax's ``nn.WeightNorm`` computes it.

Counterpart of the ``nn.WeightNorm`` wrappers of the JAX package
(``mimikit_tpu/modules/io.py:125-126``, ``heads.py:40-42``,
``resamplers.py:26-27``, ``rnn.py:89-90``).  With flax's defaults
(``feature_axes=-1``, ``variable_filter={'kernel'}``, ``epsilon=1e-12``,
``scale_init=ones``) each output unit's kernel column is scaled to the
learned norm ``g``: in torch's (out, in) layout that is each row,

    W = v * rsqrt(sum(v * v over the row) + 1e-12) * g.

Biases are not normalised.  The parameters are ``<name>_g`` (out,) and
``<name>_v`` in torch's layout, the names ``mimikit_tpu/migrate.py``
(``_resolve_weight_norm``) reads; ``g`` starts at ones.  The effective
weight is computed under autograd from ``g`` and ``v`` whenever it is
read, so the optimiser moves ``g`` and ``v`` as JAX's moves its scale and
kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from .dense import Dense, dense

__all__ = ["weight_norm", "WeightNormDense", "make_dense"]

EPSILON = 1e-12


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The effective weight of ``v`` (out, ...) and ``g`` (out,): each row of
    ``v`` over its norm, times ``g`` (flax's ``_l2_normalize``, then the
    scale)."""
    dims = tuple(range(1, v.ndim))
    unit = v * torch.rsqrt((v * v).sum(dims, keepdim=True) + EPSILON)
    return unit * g.reshape(-1, *([1] * (v.ndim - 1)))


class WeightNormDense(nn.Module):
    """``Dense`` under weight norm: parameters ``weight_g`` (out,),
    ``weight_v`` (out, in) and ``bias`` (out,); :attr:`weight` is the
    effective weight, and the forward is :func:`~.dense.dense` on it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight_g = nn.Parameter(torch.ones(out_features))
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
        else:
            self.register_parameter("bias", None)

    @property
    def weight(self) -> torch.Tensor:
        return weight_norm(self.weight_v, self.weight_g)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``v`` and the bias U(-1/sqrt(in), 1/sqrt(in)) from ``generator``
        (PyTorch's Linear bound), ``g`` ones (flax's ``scale_init``)."""
        bound = 1.0 / self.in_features ** 0.5
        for p in (self.weight_v, self.bias):
            if p is not None:
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
        self.weight_g.fill_(1.0)

    def forward(self, x):
        return dense(x, self.weight, self.bias)


def make_dense(in_features: int, out_features: int, bias: bool = True,
               weight_norm: bool = False) -> nn.Module:
    """A :class:`~.dense.Dense`, or with ``weight_norm`` a
    :class:`WeightNormDense` (flax's ``nn.WeightNorm(nn.Dense(...))``)."""
    cls = WeightNormDense if weight_norm else Dense
    return cls(in_features, out_features, bias=bias)
