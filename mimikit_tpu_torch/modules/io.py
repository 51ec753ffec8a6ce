"""IO-module factories: serializable configs that build torch modules.

Counterpart of ``mimikit_tpu/modules/io.py``.  An :class:`IOModule` is a
``Config`` dataclass holding user-facing fields plus runtime wiring slots
(``in_dim``/``out_dim``/``frame_size``/``class_size``/``sampler``...) set once
via :meth:`IOModule.set` by the IOSpec binding step; :meth:`IOModule.module`
then builds the module.  Modules are ``nn.Sequential`` chains
``before* -> core -> after*`` so their state_dict names are PyTorch
mimikit's: a framed-linear input's dense is ``2.weight``, the bottom tier's
conv is ``2.2.cv.weight`` and an MLP head's layers are
``estimator.0.fc.{k}.weight``.
"""
from __future__ import annotations

import abc
import dataclasses as dtc
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import Config, private_runtime_field
from ..precision import compute_dtype
from . import rounding
from .activations import ActivationConfig
from .heads import MLP
from .resamplers import Conv1dResampler
from .targets import OutputWrapper
from .weight_norm import make_dense

__all__ = [
    "LinearIO",
    "ChunkedLinearIO",
    "EmbeddingIO",
    "FramedLinearIO",
    "FramedConv1dIO",
    "MLPIO",
    "IOModule",
    "ZipReduceVariables",
    "Linearizer",
    "Unfold",
]


class Linearizer(nn.Module):
    """class index -> [-1, 1] float, in the mixed-precision policy's compute
    dtype (``precision.compute_dtype``: f32 outside any policy)."""

    def __init__(self, class_size: int):
        super().__init__()
        self.class_size = class_size

    def forward(self, x):
        return ((x.to(compute_dtype()) / self.class_size) - 0.5) * 2


class Unfold(nn.Module):
    """Sliding windows of ``size`` every ``step`` over the last axis; the
    window axis is appended last (``torch.Tensor.unfold``)."""

    def __init__(self, size: int, step: int):
        super().__init__()
        self.size, self.step = size, step

    def forward(self, x):
        return x.unfold(-1, self.size, self.step)


class _Flatten(nn.Module):
    def forward(self, x):
        return x.reshape(*x.shape[:-2], -1)


class _Unsqueeze(nn.Module):
    def forward(self, x):
        return x.unsqueeze(-1)


class ChunkSum(nn.Module):
    """The sum of ``n_chunks`` equal slices of the last axis
    (``mimikit_tpu/modules/io.py:148``)."""

    def __init__(self, n_chunks: int):
        super().__init__()
        self.n_chunks = n_chunks

    def forward(self, x):
        return sum(torch.chunk(x, self.n_chunks, dim=-1))


@dtc.dataclass
class IOModule(Config, abc.ABC):
    activation: Optional[ActivationConfig] = None
    dropout: float = 0.0
    dropout1d: float = 0.0

    in_dim: Optional[int] = private_runtime_field(None)
    out_dim: Optional[int] = private_runtime_field(None)
    hop_length: Optional[int] = private_runtime_field(None)
    frame_size: Optional[int] = private_runtime_field(None)
    class_size: Optional[int] = private_runtime_field(None)
    sampler: Optional[nn.Module] = private_runtime_field(None)
    weight_norm: bool = private_runtime_field(False)
    with_linearizer: bool = private_runtime_field(False)
    with_unfold: bool = private_runtime_field(False)
    with_n_chunks: Optional[int] = private_runtime_field(None)

    def set(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"attribute '{k}' not found in IOModule")
            if getattr(self, k) is not None and not (
                isinstance(getattr(self, k), bool) and getattr(self, k) is False
            ):
                raise RuntimeError(
                    f"can not set attribute '{k}'. It has already been set to"
                    f" '{getattr(self, k)}'"
                )
            setattr(self, k, v)
        return self

    def not_none(self, *args):
        msg = ""
        for k in args:
            if getattr(self, k) is None:
                msg += (
                    f"- '{k}' can not be None with module_type"
                    f" '{type(self).__qualname__}'\n"
                )
        if msg:
            raise ValueError(msg)

    @abc.abstractmethod
    def module(self) -> nn.Module:
        ...

    def wrap(self, core: nn.Module, core_owns_after: bool = False) -> nn.Module:
        if self.dropout1d > 0:
            raise NotImplementedError("dropout1d is not ported")
        before = []
        if self.with_linearizer:
            before.append(Linearizer(self.class_size))
        if self.with_unfold:
            self.not_none("frame_size", "hop_length")
            before.append(Unfold(self.frame_size, self.hop_length))
        after = []
        if self.with_n_chunks is not None:
            after.append(ChunkSum(self.with_n_chunks))
        if self.activation is not None and str(self.activation.act) != "Identity":
            after.append(self.activation.get())
        if self.dropout > 0 and not core_owns_after:
            after.append(nn.Dropout(self.dropout))
        mod = nn.Sequential(*before, core, *after)
        if self.sampler is not None:
            return OutputWrapper(estimator=mod, sampler=self.sampler)
        return mod


@dtc.dataclass
class LinearIO(IOModule):
    """A dense layer (``mimikit_tpu/modules/io.py:234``): the spectral
    nets' input and output heads.  Its dense is ``0.weight``."""

    bias: bool = True

    def module(self) -> nn.Module:
        self.not_none("in_dim", "out_dim")
        return self.wrap(make_dense(self.in_dim, self.out_dim, bias=self.bias,
                                    weight_norm=self.weight_norm))


@dtc.dataclass
class ChunkedLinearIO(IOModule):
    """A dense layer to ``n_chunks * out_dim`` features whose ``n_chunks``
    slices are summed (``mimikit_tpu/modules/io.py:254``), then the
    activation: ``IOSpec.magspec_io``'s heads."""

    bias: bool = True
    n_chunks: int = 1

    def module(self) -> nn.Module:
        self.not_none("in_dim", "out_dim")
        self.with_n_chunks = self.n_chunks
        return self.wrap(make_dense(self.in_dim, self.out_dim * self.n_chunks, bias=self.bias,
                                    weight_norm=self.weight_norm))


@dtc.dataclass
class FramedLinearIO(IOModule):
    """linearize + unfold(frame) + dense — the SampleRNN frame input; its
    dense under weight norm where ``weight_norm`` is set."""

    def module(self) -> nn.Module:
        self.not_none("frame_size", "hop_length", "out_dim", "class_size")
        self.with_linearizer = True
        self.with_unfold = True
        return self.wrap(make_dense(self.frame_size, self.out_dim, weight_norm=self.weight_norm))


class _Embedding(nn.Embedding):
    """``nn.Embedding`` that takes class indices of any integer dtype; below
    f32, on the CPU, its table's gradient accumulates as JAX's does
    (``rounding.embedding``)."""

    def forward(self, x):
        if self.weight.dtype != torch.float32:
            return rounding.embedding(x.long(), self.weight)
        return super().forward(x.long())


@dtc.dataclass
class EmbeddingIO(IOModule):
    """class index -> learned vector — WaveNet's mu-law input.  Its table is
    ``0.weight`` (PyTorch mimikit's name)."""

    def module(self) -> nn.Module:
        self.not_none("class_size", "out_dim")
        return self.wrap(_Embedding(self.class_size, self.out_dim))


@dtc.dataclass
class FramedConv1dIO(IOModule):
    """linearize + unfold + strided conv — the SampleRNN bottom-tier input."""

    def module(self) -> nn.Module:
        self.not_none("frame_size", "out_dim")
        self.with_linearizer = self.class_size is not None
        self.with_unfold = True
        if self.hop_length is None:
            self.hop_length = 1
        conv = Conv1dResampler(
            in_dim=1, t_factor=1 / self.frame_size, d_factor=self.out_dim
        )
        return self.wrap(nn.Sequential(_Flatten(), _Unsqueeze(), conv))


@dtc.dataclass
class MLPIO(IOModule):
    hidden_dim: int = 128
    n_hidden_layers: int = 1
    activation: ActivationConfig = dtc.field(
        default_factory=lambda: ActivationConfig("Mish")
    )
    bias: bool = True
    dropout: float = 0.0
    dropout1d: float = 0.0
    min_temperature: Optional[float] = 1e-4

    def module(self) -> nn.Module:
        self.not_none("in_dim", "out_dim")
        act = self.activation.get() if self.activation is not None else None
        mod = MLP(
            in_dim=self.in_dim,
            out_dim=self.out_dim,
            hidden_dim=self.hidden_dim,
            n_hidden_layers=self.n_hidden_layers,
            activation=act,
            use_bias=self.bias,
            dropout=self.dropout,
            min_temperature=self.min_temperature,
            weight_norm=self.weight_norm,
        )
        self.activation = None
        return self.wrap(mod, core_owns_after=True)


class ZipReduceVariables(nn.Module):
    """Reduce per-variable head outputs: sum / mean / learned softmax mix."""

    def __init__(self, mode: str, heads: Tuple[nn.Module, ...]):
        super().__init__()
        self.mode = str(mode)
        self.heads = nn.ModuleList(heads)
        if self.mode == "static_mix":
            self.weights = nn.Parameter(-0.5 * torch.ones(len(heads)))

    def forward(self, inputs: Tuple):
        m = len(self.heads)
        if self.mode == "static_mix":
            w = torch.softmax(self.weights, dim=0)
        else:
            w = [1.0 / m if self.mode == "mean" else 1.0] * m
        y = None
        for i, (head, x) in enumerate(zip(self.heads, inputs)):
            out = head(x) * w[i]
            y = out if y is None else y + out
        return y
