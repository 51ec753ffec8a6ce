"""Time/feature resampling modules (counterpart of
``mimikit_tpu/modules/resamplers.py``).

``LinearResampler`` is the SampleRNN tier upsampler: one linear layer whose
output is reshaped to trade feature dim for time steps.  ``Conv1dResampler``
collapses windows of ``1/t_factor`` steps with a strided convolution — the
SampleRNN bottom tier's input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .rounding import bias_add
from .weight_norm import make_dense

__all__ = ["LinearResampler", "Conv1dResampler"]


class LinearResampler(nn.Module):
    """One dense layer (``fc``, under weight norm where ``weight_norm`` is
    set) whose outputs are reshaped from features into ``t_factor`` steps."""

    def __init__(self, in_dim: int, t_factor: float, d_factor: float = 1,
                 weight_norm: bool = False):
        super().__init__()
        self.t_factor, self.d_factor = t_factor, d_factor
        self.fc = make_dense(in_dim, int(in_dim * t_factor * d_factor), weight_norm=weight_norm)

    def forward(self, x):
        B, T, D = x.shape
        y = self.fc(x)
        return y.reshape(B, int(T * self.t_factor), int(D * self.d_factor))


class Conv1dResampler(nn.Module):
    """``t_factor <= 1``: a valid conv of kernel and stride ``1/t_factor``
    over (B, T, D), giving (B, T * t_factor, D * d_factor)."""

    def __init__(self, in_dim: int, t_factor: float, d_factor: float, use_bias: bool = True):
        super().__init__()
        if t_factor > 1:
            raise NotImplementedError("transposed-conv upsampling is not ported")
        k = int(round(1 / t_factor))
        self.cv = nn.Conv1d(in_dim, int(in_dim * d_factor), k, stride=k, bias=use_bias)

    def forward(self, x):
        x = x.transpose(1, 2)
        if x.dtype == torch.float32 or self.cv.bias is None:
            return self.cv(x).transpose(1, 2)
        # below f32, rounded as flax's Dense on the window (see modules/dense.py)
        y = bias_add(F.conv1d(x, self.cv.weight, None, self.cv.stride), self.cv.bias, 1)
        return y.transpose(1, 2)
