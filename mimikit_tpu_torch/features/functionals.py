"""Signal-processing functionals: configurable, invertible, dual-backend.

Counterpart of ``mimikit_tpu/features/functionals.py``, reduced to what the
mu-law SampleRNN serving path needs: ``Discrete``/``Continuous`` element
types, ``FileToSignal`` (through ``audio_io.load_audio``, resampled to ``sr``),
``Normalize``, ``RemoveDC``, ``Compose`` and the centered mu-law pair.  Each
``Functional`` has a numpy path (``np_func``, the host/extraction path) and a
torch path (``torch_func``, device tensors) where the JAX package had a
``jax_func``; ``__call__`` dispatches on the input type.
"""
from __future__ import annotations

import abc
import dataclasses as dtc
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from .audio_io import load_audio
from .item_spec import Sample, Unit

__all__ = [
    "Continuous",
    "Discrete",
    "Functional",
    "Identity",
    "Compose",
    "FileToSignal",
    "RemoveDC",
    "Normalize",
    "MuLawCompress",
    "MuLawExpand",
]

SR = 22050
Q_LEVELS = 256


@dtc.dataclass
class Continuous:
    min_value: Union[float, int]
    max_value: Union[float, int]
    size: int


@dtc.dataclass
class Discrete:
    size: int


EventType = Union[Continuous, Discrete]


@dtc.dataclass
class Functional(Config, abc.ABC):
    @property
    def unit(self) -> Optional[Unit]:
        """output's time unit"""
        return None

    @property
    def elem_type(self) -> Optional[EventType]:
        return None

    @abc.abstractmethod
    def np_func(self, inputs):
        raise NotImplementedError

    def torch_func(self, inputs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__qualname__} has no torch path"
        )

    def __call__(self, inputs):
        if isinstance(inputs, torch.Tensor):
            return self.torch_func(inputs)
        return self.np_func(inputs)

    @property
    @abc.abstractmethod
    def inv(self) -> "Functional":
        ...


@dtc.dataclass
class Identity(Functional):
    def np_func(self, inputs):
        return inputs

    def torch_func(self, inputs):
        return inputs

    @property
    def inv(self) -> "Functional":
        return Identity()


@dtc.dataclass
class FileToSignal(Functional):
    """Read an audio file as a float32 mono signal at ``sr``
    (``features/audio_io.load_audio``: WAV and ``.npy`` natively, other
    formats through soundfile or ffmpeg where installed; a file at another
    rate is resampled)."""

    sr: int = SR
    offset: float = 0.0
    duration: Optional[float] = None

    @property
    def unit(self) -> Optional[Unit]:
        return Sample(self.sr)

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(-float("inf"), float("inf"), 1)

    def np_func(self, path):
        return load_audio(path, sr=self.sr, offset=self.offset, duration=self.duration)

    def __call__(self, path):
        return self.np_func(path)

    @property
    def inv(self):
        return Identity()


@dtc.dataclass
class Compose(Functional):
    functionals: Tuple[Functional, ...]

    def __init__(self, *funcs: Functional, functionals=()):
        self.functionals = tuple(funcs) or tuple(functionals)

    @property
    def unit(self) -> Optional[Unit]:
        u = tuple(f.unit for f in self.functionals if f.unit is not None)
        return u[-1] if any(u) else None

    @property
    def elem_type(self) -> Optional[EventType]:
        ev = tuple(f.elem_type for f in self.functionals if f.elem_type is not None)
        return ev[-1] if any(ev) else None

    def np_func(self, inputs):
        raise NotImplementedError

    def __call__(self, inputs):
        x = inputs
        for f in self.functionals:
            x = f(x)
        return x

    @property
    def inv(self):
        return Compose(*(f.inv for f in reversed(self.functionals)))


@dtc.dataclass
class RemoveDC(Functional):
    """First-order DC-blocking IIR, ``y[n] = x[n] - x[n-1] + .99 y[n-1]``."""

    def np_func(self, inputs):
        from scipy.signal import lfilter

        return lfilter([1.0, -1.0], [1.0, -0.99], inputs, axis=-1).astype(
            inputs.dtype
        )

    def torch_func(self, inputs):
        # a sequential IIR: run it on the host, where extraction happens
        y = self.np_func(inputs.detach().cpu().numpy())
        return torch.from_numpy(y).to(inputs.device)

    @property
    def inv(self) -> "Functional":
        return Identity()


@dtc.dataclass
class Normalize(Functional):
    """p-norm normalization along ``dim`` (default inf-norm -> peak = 1)."""

    p: float = float("inf")
    dim: int = -1

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(-1.0, 1.0, 1)

    def np_func(self, inputs):
        if self.p == float("inf"):
            n = np.max(np.abs(inputs), axis=self.dim, keepdims=True)
        else:
            n = np.sum(np.abs(inputs) ** self.p, axis=self.dim, keepdims=True) ** (
                1.0 / self.p
            )
        n = np.where(n > np.finfo(np.float32).tiny, n, np.ones_like(n))
        return (inputs / n).astype(inputs.dtype)

    def torch_func(self, inputs):
        n = torch.linalg.vector_norm(inputs, ord=self.p, dim=self.dim, keepdim=True)
        return inputs / torch.where(
            n > np.finfo(np.float32).tiny, n, torch.ones_like(n)
        )

    @property
    def inv(self):
        return Identity()


def mu_compress_np(x, q_levels: int, compression: float):
    """Centered mu-law companding + quantization to int class indices
    (``mimikit_tpu/features/dsp.py:mu_compress`` with numpy)."""
    mu = q_levels - 1.0
    x_mu = (
        np.sign(x)
        * np.log1p(mu * np.abs(x) * compression)
        / np.log1p(mu * compression)
    )
    return ((x_mu + 1) / 2 * mu + 0.5).astype(np.int64)


def mu_expand_np(x, q_levels: int, compression: float):
    mu = q_levels - 1.0
    y = (x / mu) * 2 - 1.0
    return (
        np.sign(y)
        * (np.exp(np.abs(y) * np.log1p(mu * compression)) - 1.0)
        / (mu * compression)
    )


@dtc.dataclass
class MuLawCompress(Functional):
    """Centered mu-law quantizer — the SampleRNN/WaveNet front-end."""

    q_levels: int = Q_LEVELS
    compression: float = 1.0

    @property
    def elem_type(self) -> Optional[EventType]:
        return Discrete(self.q_levels)

    def np_func(self, inputs):
        x = np.asarray(inputs)
        if not np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float32)
        return mu_compress_np(x, self.q_levels, self.compression)

    def torch_func(self, inputs):
        x = inputs.to(torch.float32)
        mu = self.q_levels - 1.0
        x_mu = (
            torch.sign(x)
            * torch.log1p(mu * torch.abs(x) * self.compression)
            / float(np.log1p(mu * self.compression))
        )
        return ((x_mu + 1) / 2 * mu + 0.5).to(torch.int32)

    @property
    def inv(self):
        return MuLawExpand(self.q_levels, self.compression)


@dtc.dataclass
class MuLawExpand(Functional):
    q_levels: int = Q_LEVELS
    compression: float = 1.0

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(-1.0, 1.0, 1)

    def np_func(self, inputs):
        x = np.asarray(inputs).astype(np.float64)
        return mu_expand_np(x, self.q_levels, self.compression).astype(np.float32)

    def torch_func(self, inputs):
        x = inputs.to(torch.float32)
        mu = self.q_levels - 1.0
        y = (x / mu) * 2 - 1.0
        return (
            torch.sign(y)
            * (torch.exp(torch.abs(y) * float(np.log1p(mu * self.compression))) - 1.0)
            / (mu * self.compression)
        )

    @property
    def inv(self):
        return MuLawCompress(self.q_levels, self.compression)
