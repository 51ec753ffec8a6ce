"""Signal-processing functionals: configurable, invertible, dual-backend.

Counterpart of ``mimikit_tpu/features/functionals.py``, reduced to what the
mu-law and spectral paths need: ``Discrete``/``Continuous`` element types,
``FileToSignal`` (through ``audio_io.load_audio``, resampled to ``sr``),
``Normalize``, ``RemoveDC``, ``Compose``, ``Resample``, the centered mu-law
pair, ``STFT``, ``ISTFT``, ``MagSpec`` and its inverse ``GLA``
(``dsp.py``), and the projections of a magnitude spectrogram ``MelSpec``,
``MFCC`` and ``Chroma``.  Each ``Functional`` has a numpy path (``np_func``,
the host/extraction path) and a torch path (``torch_func``, device tensors)
where the JAX package had a ``jax_func``; ``__call__`` dispatches on the
input type.  A numpy output may carry metadata on its dtype (``Resample``'s
``sr``, ``get_metadata``), as in the JAX package.
"""
from __future__ import annotations

import abc
import dataclasses as dtc
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from . import dsp
from .audio_io import load_audio
from .item_spec import Frame, Sample, Unit, convert

__all__ = [
    "Continuous",
    "Discrete",
    "Functional",
    "Identity",
    "Compose",
    "FileToSignal",
    "RemoveDC",
    "Normalize",
    "Resample",
    "MuLawCompress",
    "MuLawExpand",
    "STFT",
    "ISTFT",
    "MagSpec",
    "GLA",
    "MelSpec",
    "MFCC",
    "Chroma",
    "get_metadata",
]

N_FFT = 2048
HOP_LENGTH = 512
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


def _to_dict(value):
    return {} if value is None else dict(value)


def _add_metadata(x, **metadata):
    """Metadata (e.g. ``sr``) carried on a numpy array's dtype; a tensor
    passes unchanged."""
    if isinstance(x, np.ndarray):
        prev = _to_dict(x.dtype.metadata)
        prev.update(metadata)
        return x.view(np.dtype(x.dtype, metadata=prev))
    return x


def get_metadata(x, key: str, default=None):
    """``key`` of the metadata a numpy array carries on its dtype."""
    if isinstance(x, np.ndarray) and x.dtype.metadata is not None:
        return x.dtype.metadata.get(key, default)
    return default


# host-built projections (filterbanks, DCT bases, lifters) as tensors, once a device
_DEVICE_CONSTS: dict = {}


def _device_const(key, device, build):
    k = (key, str(device))
    t = _DEVICE_CONSTS.get(k)
    if t is None:
        t = _DEVICE_CONSTS[k] = torch.as_tensor(build(), device=device)
    return t


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

    def apply_to_outputs(self, outputs: np.ndarray, device) -> np.ndarray:
        """This transform of a network's outputs (numpy, off ``device``, the
        network's): on the host, unless the transform runs where the network
        does (``GLA``)."""
        return np.asarray(self(outputs))

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


@dtc.dataclass
class Resample(Functional):
    """Polyphase resampling from ``orig_sr`` to ``target_sr``.  The numpy path
    is scipy's ``resample_poly`` (``dsp.resample_np``); the tensor path
    applies the same FIR (``dsp.resample_poly_filter``) with the same output
    alignment where the tensor lies, as one strided convolution of the
    zero-stuffed signal (``mimikit_tpu/features/functionals.py:388-432``:
    ``lhs_dilation=up``, ``window_strides=down``)."""

    orig_sr: int = 22050
    target_sr: int = 16000

    @property
    def unit(self) -> Optional[Unit]:
        return Sample(self.target_sr)

    def np_func(self, inputs):
        y = dsp.resample_np(inputs, self.orig_sr, self.target_sr)
        return _add_metadata(y, sr=self.target_sr)

    def torch_func(self, inputs):
        up, down, h = dsp.resample_poly_filter(self.orig_sr, self.target_sr)
        x = inputs.to(torch.float32)
        if up == down:
            return x
        shape, n_in = x.shape, x.shape[-1]
        n_out = (n_in * up) // down + bool((n_in * up) % down)
        half_len = (len(h) - 1) // 2
        n_pre_pad = down - half_len % down
        n_pre_remove = (half_len + n_pre_pad) // down
        h_p = np.concatenate([np.zeros(n_pre_pad, np.float32), h])
        L = len(h_p)
        # correlation with the reversed padded filter is the convolution; a
        # left pad of L - 1 puts output i at sample i * down of the full one
        w = _device_const(("resample", self.orig_sr, self.target_sr), x.device,
                          lambda: np.ascontiguousarray(h_p[::-1])[None, None, :])
        n_up = (n_in - 1) * up + 1
        need = (n_pre_remove + n_out - 1) * down + L - n_up - (L - 1) + 1
        pad_r = max(L - 1, need)
        stuffed = x.new_zeros(x.numel() // n_in, 1, L - 1 + n_up + pad_r)
        stuffed[:, 0, L - 1 : L - 1 + n_up : up] = x.reshape(-1, n_in)
        y = torch.nn.functional.conv1d(stuffed, w, stride=down)
        return y[:, 0, n_pre_remove : n_pre_remove + n_out].reshape(*shape[:-1], n_out)

    @property
    def inv(self):
        return Resample(self.target_sr, self.orig_sr)


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


def _coord(S, coordinate: str):
    """A complex spectrogram in ``coordinate``: "pol" (magnitude, angle),
    "car" (real, imaginary), "mag", "angle", or complex."""
    xp = torch if isinstance(S, torch.Tensor) else np
    if coordinate == "pol":
        return xp.stack((xp.abs(S), xp.angle(S)), -1)
    if coordinate == "car":
        return xp.stack((S.real, S.imag), -1)
    if coordinate == "mag":
        return xp.abs(S)
    if coordinate == "angle":
        return xp.angle(S)
    return S


@dtc.dataclass
class STFT(Functional):
    """Short-time Fourier transform, (time, freq) layout.  ``alignment``
    trims the signal to the length a whole number of frames covers, keeping
    its end ("end") or its start ("start")."""

    n_fft: int = N_FFT
    hop_length: int = HOP_LENGTH
    coordinate: str = "pol"
    center: bool = True
    window: Optional[str] = "hann"
    pad_mode: str = "constant"
    alignment: Optional[str] = "end"

    @property
    def unit(self) -> Optional[Unit]:
        return Frame(self.n_fft, self.hop_length, padding=self.center)

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(0.0, float("inf"), 1 + self.n_fft // 2)

    def _fix_length(self, inputs):
        if self.alignment is None:
            return inputs
        n = inputs.shape[-1]
        target_length = convert(
            convert(n, Sample(1), self.unit, as_length=True) + int(self.center),
            self.unit, Sample(1), as_length=True,
        )
        if self.alignment == "end":
            return inputs[..., -target_length:]
        if self.alignment == "start":
            return inputs[..., :target_length]
        return inputs

    def np_func(self, inputs):
        S = dsp.stft_np(self._fix_length(np.asarray(inputs)), self.n_fft, self.hop_length,
                        self.center, self.window, self.pad_mode)
        return _coord(S, self.coordinate)

    def torch_func(self, inputs):
        S = dsp.stft_torch(self._fix_length(inputs), self.n_fft, self.hop_length, self.center,
                           self.window, self.pad_mode)
        return _coord(S, self.coordinate)

    @property
    def inv(self):
        return ISTFT(self.n_fft, self.hop_length, self.coordinate, self.center, self.window)


@dtc.dataclass
class ISTFT(Functional):
    n_fft: int = N_FFT
    hop_length: int = HOP_LENGTH
    coordinate: str = "pol"
    center: bool = True
    window: Optional[str] = None
    pad_mode: str = "constant"

    @property
    def unit(self) -> Optional[Unit]:
        return Sample(None)

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(-1.0, 1.0, 1)

    def _to_complex(self, inputs):
        xp = torch if isinstance(inputs, torch.Tensor) else np
        if self.coordinate == "pol":
            return inputs[..., 0] * xp.exp(1j * inputs[..., 1])
        if self.coordinate == "car":
            return inputs[..., 0] + 1j * inputs[..., 1]
        return inputs

    def np_func(self, inputs):
        S = self._to_complex(np.asarray(inputs))
        return dsp.istft_np(S, self.n_fft, self.hop_length, self.center, self.window)

    def torch_func(self, inputs):
        return dsp.istft_torch(self._to_complex(inputs), self.n_fft, self.hop_length,
                               self.center, self.window)

    @property
    def inv(self):
        return STFT(self.n_fft, self.hop_length, self.coordinate, self.center, self.window,
                    self.pad_mode)


@dtc.dataclass
class MagSpec(Functional):
    """Magnitude spectrogram (an ``STFT`` in "mag" coordinates); ``inv`` is
    Griffin-Lim."""

    n_fft: int = N_FFT
    hop_length: int = HOP_LENGTH
    center: bool = True
    window: Optional[str] = "hann"
    pad_mode: str = "constant"
    alignment: Optional[str] = "end"

    @property
    def stft(self):
        return STFT(self.n_fft, self.hop_length, "mag", self.center, self.window,
                    self.pad_mode, alignment=self.alignment)

    @property
    def unit(self) -> Optional[Unit]:
        return Frame(self.n_fft, self.hop_length, padding=self.center)

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(0.0, float("inf"), 1 + self.n_fft // 2)

    def np_func(self, inputs):
        return self.stft.np_func(inputs)

    def torch_func(self, inputs):
        return self.stft.torch_func(inputs)

    @property
    def inv(self):
        return GLA(self.n_fft, self.hop_length, self.center, self.window, self.pad_mode)


@dtc.dataclass
class GLA(Functional):
    """Griffin-Lim phase reconstruction, ``n_iter`` iterations at momentum
    0.99 (a hann window where ``window`` is None).  The torch path runs where
    its tensor lies (``apply_to_outputs`` hands it a network's frames on the
    network's device); its first phase comes from ``generator`` (seeded 0
    where None), so it agrees with the JAX package's in distribution
    (``dsp.griffinlim_torch``)."""

    n_fft: int = N_FFT
    hop_length: int = HOP_LENGTH
    center: bool = True
    window: Optional[str] = None
    pad_mode: str = "constant"
    n_iter: int = 32

    @property
    def unit(self) -> Optional[Unit]:
        return Sample(None)

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(-1.0, 1.0, 1)

    def np_func(self, inputs):
        return dsp.griffinlim_np(np.asarray(inputs), self.n_fft, self.hop_length, self.center,
                                 self.window if self.window is not None else "hann",
                                 self.n_iter)

    def torch_func(self, inputs, generator: Optional[torch.Generator] = None):
        return dsp.griffinlim_torch(inputs, self.n_fft, self.hop_length, self.center,
                                    self.window if self.window is not None else "hann",
                                    self.n_iter, generator=generator)

    def apply_to_outputs(self, outputs, device):
        return self.torch_func(torch.as_tensor(outputs, device=device)).cpu().numpy()

    @property
    def inv(self):
        return MagSpec(self.n_fft, self.hop_length, self.center, self.window, self.pad_mode)


@dtc.dataclass
class MelSpec(Functional):
    """Mel projection of a magnitude spectrogram, (time, freq) -> (time,
    n_mels): the power ``|S|^2`` times the filterbank's transpose
    (``dsp.mel_filterbank``, built once and kept on each device)."""

    n_mels: int = 128
    fmin: float = 0.0
    fmax: Optional[float] = None
    htk: bool = False
    sr: int = SR
    n_fft: int = N_FFT

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(0.0, float("inf"), self.n_mels)

    def _fb(self):
        return dsp.mel_filterbank(self.sr, self.n_fft, self.n_mels, self.fmin, self.fmax,
                                  self.htk)

    def np_func(self, inputs):
        return (np.asarray(inputs) ** 2) @ self._fb().T

    def torch_func(self, inputs):
        fbT = _device_const(("mel", self.sr, self.n_fft, self.n_mels, self.fmin, self.fmax,
                             self.htk), inputs.device,
                            lambda: np.ascontiguousarray(self._fb().T))
        return (inputs * inputs) @ fbT

    @property
    def inv(self) -> "Functional":
        return Identity()


def _lifter(n_mfcc: int, lifter: int) -> np.ndarray:
    n = np.arange(n_mfcc)
    return (1 + (lifter / 2) * np.sin(np.pi * (n + 1) / lifter)).astype(np.float32)


@dtc.dataclass
class MFCC(Functional):
    """DCT-II (``dsp.dct_matrix``) of the log of a mel input along its
    feature axis, the log floored at 1e-10, then the sinusoidal lifter where
    ``lifter`` > 0."""

    n_mfcc: int = 20
    dct_type: int = 2
    norm: Optional[str] = "ortho"
    lifter: int = 0

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(0.0, float("inf"), self.n_mfcc)

    def np_func(self, inputs):
        S = np.asarray(inputs)
        m = np.log(np.maximum(S, 1e-10)) @ dsp.dct_matrix(self.n_mfcc, S.shape[-1], self.norm).T
        if self.lifter > 0:
            m = m * _lifter(self.n_mfcc, self.lifter)
        return m

    def torch_func(self, inputs):
        n_in = int(inputs.shape[-1])
        basisT = _device_const(("dct", self.n_mfcc, n_in, self.norm), inputs.device,
                               lambda: np.ascontiguousarray(
                                   dsp.dct_matrix(self.n_mfcc, n_in, self.norm).T))
        m = torch.log(torch.clamp_min(inputs, 1e-10)) @ basisT
        if self.lifter > 0:
            m = m * _device_const(("lifter", self.n_mfcc, self.lifter), inputs.device,
                                  lambda: _lifter(self.n_mfcc, self.lifter))
        return m

    @property
    def inv(self) -> "Functional":
        return Identity()


@dtc.dataclass
class Chroma(Functional):
    """Chroma projection of a magnitude spectrogram: a Gaussian bump a
    chroma bin over the FFT bins' pitch classes, each bin's weights summing
    to one."""

    n_chroma: int = 12
    sr: int = SR
    n_fft: int = N_FFT

    @property
    def elem_type(self) -> Optional[EventType]:
        return Continuous(0.0, float("inf"), self.n_chroma)

    def _fb(self) -> np.ndarray:
        n_bins = 1 + self.n_fft // 2
        freqs = np.linspace(0, self.sr / 2, n_bins)[1:]
        pitches = 12 * np.log2(freqs / 440.0) + 69.0  # midi
        chroma_of_bin = pitches % 12
        fb = np.zeros((self.n_chroma, n_bins), dtype=np.float32)
        c = np.arange(self.n_chroma)[:, None]
        dist = np.abs(chroma_of_bin[None, :] * self.n_chroma / 12 - c) % self.n_chroma
        d = np.minimum(dist, self.n_chroma - dist)
        fb[:, 1:] = np.exp(-0.5 * d ** 2).astype(np.float32)
        fb /= np.maximum(fb.sum(axis=0, keepdims=True), 1e-8)
        return fb

    def np_func(self, inputs):
        return np.asarray(inputs) @ self._fb().T

    def torch_func(self, inputs):
        fbT = _device_const(("chroma", self.sr, self.n_fft, self.n_chroma), inputs.device,
                            lambda: np.ascontiguousarray(self._fb().T))
        return inputs @ fbT

    @property
    def inv(self) -> "Functional":
        return Identity()
