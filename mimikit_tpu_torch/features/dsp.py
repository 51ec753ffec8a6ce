"""DSP primitives: resampling, STFT, ISTFT and Griffin-Lim, numpy and torch.

Counterpart of ``mimikit_tpu/features/dsp.py``.  The framing and windowing
conventions are the JAX package's (librosa's):

* window: periodic ("fftbins") hann of length ``n_fft``;
* ``center=True`` pads ``n_fft // 2`` on both sides with ``pad_mode``;
* ``n_frames = 1 + (n_padded - n_fft) // hop``;
* istft overlap-adds ``window * irfft(frame)`` and divides by the summed
  squared window, then trims ``n_fft // 2`` per side when centered.

Spectrograms are **(time, freq)**.  Each transform runs on torch where its
tensor lies (training batches are framed on the card, Griffin-Lim runs
there); the numpy entry points (extraction, the functionals' ``np_func``)
run the same code on the host's tensors.  The FFTs are
``torch.fft.rfft``/``irfft``, as the JAX package's are ``jnp.fft``'s; the
torch path frames with ``Tensor.unfold`` and overlap-adds as the JAX path
does, ``k = ceil(n_fft / hop)`` shifted hop-sized segments summed in order.

Griffin-Lim draws its first phase from U(-pi, pi): ``griffinlim_torch``
takes a ``torch.Generator`` (seeded 0 where none is given) and cannot draw
``jax.random.uniform``'s phase, so a seeded call matches the JAX package's
in distribution, not in value; both run the same iteration from the same
``init_phase`` (``_griffinlim_torch``).

``resample_poly_filter`` builds scipy ``resample_poly``'s Kaiser FIR once a
rate pair, the filter of ``Resample``'s tensor path; ``mel_filterbank``
(Slaney or HTK mels) and ``dct_matrix`` (DCT-II) are the host-built
projections of ``MelSpec`` and ``MFCC``, the JAX package's
(``mimikit_tpu/features/dsp.py:322-382,514``).
"""
from __future__ import annotations

from functools import lru_cache
from math import gcd
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "resample_np",
    "resample_poly_filter",
    "mel_filterbank",
    "dct_matrix",
    "hann_window",
    "get_window",
    "frame_count",
    "expected_signal_length",
    "stft_np",
    "istft_np",
    "griffinlim_np",
    "stft_torch",
    "istft_torch",
    "griffinlim_torch",
]


def resample_np(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy's ``resample_poly``, its Kaiser window)
    along the last axis, in float32."""
    from scipy.signal import resample_poly

    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    if up == down:
        return np.asarray(y)
    return resample_poly(np.asarray(y, dtype=np.float32), up, down, axis=-1).astype(np.float32)


@lru_cache(maxsize=None)
def resample_poly_filter(orig_sr: int, target_sr: int):
    """(up, down, h): the FIR scipy's ``resample_poly`` builds for this rate
    pair (a Kaiser window of beta 5.0, cutoff 1 / max(up, down), scaled by
    up), so the tensor path and the numpy path filter alike; built once a
    pair (``h`` is shared: not to be written)."""
    from scipy.signal import firwin

    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    if up == down:
        return up, down, np.ones(1, np.float32)
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return up, down, (h * up).astype(np.float32)


# -- mel and DCT projections -----------------------------------------------------------

def _hz_to_mel(f, htk=False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz(m, htk=False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr, n_fft, n_mels=128, fmin=0.0, fmax=None, htk=False) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    # equal energy a channel
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def dct_matrix(n_out: int, n_in: int, norm: Optional[str] = "ortho") -> np.ndarray:
    """DCT-II basis, (n_out, n_in): mfcc = basis @ log_mel."""
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    basis = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    if norm == "ortho":
        basis[0] *= np.sqrt(1.0 / (4 * n_in))
        basis[1:] *= np.sqrt(1.0 / (2 * n_in))
    return basis.astype(np.float32)


# -- windows and shapes ------------------------------------------------------------------

def hann_window(n_fft: int, dtype=np.float32) -> np.ndarray:
    """Periodic hann window (what librosa and torch use for the STFT)."""
    n = np.arange(n_fft)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(dtype)


def get_window(window: Optional[str], n_fft: int, dtype=np.float32) -> np.ndarray:
    if window is None or window == 1.0:
        return np.ones(n_fft, dtype=dtype)
    if window == "hann":
        return hann_window(n_fft, dtype)
    if window == "hamming":
        n = np.arange(n_fft)
        return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / n_fft)).astype(dtype)
    if window == "blackman":
        n = np.arange(n_fft)
        w = 0.42 - 0.5 * np.cos(2.0 * np.pi * n / n_fft) + 0.08 * np.cos(4.0 * np.pi * n / n_fft)
        return w.astype(dtype)
    raise ValueError(f"unknown window '{window}'")


def frame_count(n_samples: int, n_fft: int, hop: int, center: bool) -> int:
    n = n_samples + 2 * (n_fft // 2) * int(center)
    if n < n_fft:
        return 0
    return 1 + (n - n_fft) // hop


def expected_signal_length(n_frames: int, n_fft: int, hop: int, center: bool) -> int:
    n = n_fft + hop * (n_frames - 1)
    if center:
        n -= 2 * (n_fft // 2)
    return n


def _ola_window_sum(window, n_fft: int, hop: int, n_frames: int, dtype) -> np.ndarray:
    """The squared window overlap-added over ``n_frames`` frames."""
    idx = (np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]).reshape(-1)
    w = get_window(window, n_fft).astype(dtype)
    wss = np.zeros(n_fft + hop * (n_frames - 1), dtype=dtype)
    np.add.at(wss, idx, np.tile(w * w, n_frames))
    return wss


# -- torch path ----------------------------------------------------------------------------

_PAD_MODES = {"constant": "constant", "reflect": "reflect", "edge": "replicate",
              "wrap": "circular"}


def _pad_centered(y: torch.Tensor, n_fft: int, pad_mode: str) -> torch.Tensor:
    p = n_fft // 2
    if pad_mode == "constant":
        return F.pad(y, (p, p))
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode '{pad_mode}' has no torch counterpart")
    flat = y.reshape(-1, 1, y.shape[-1])
    return F.pad(flat, (p, p), mode=_PAD_MODES[pad_mode]).reshape(*y.shape[:-1], -1)


def _stft_torch(y, n_fft, hop, center, window, pad_mode):
    w = torch.as_tensor(get_window(window, n_fft), device=y.device).to(y.dtype)
    if center:
        y = _pad_centered(y, n_fft, pad_mode)
    return torch.fft.rfft(y.unfold(-1, n_fft, hop) * w, dim=-1)


def _istft_torch(S, n_fft, hop, center, window, length=None):
    """The overlap-add of ``_istft_impl``'s device path: k = ceil(n_fft / hop)
    hop-sized segments of every frame, segment s of frame j on row j + s,
    the k shifted row grids summed in order."""
    real = torch.float64 if S.dtype == torch.complex128 else torch.float32
    w = torch.as_tensor(get_window(window, n_fft), device=S.device).to(real)
    frames = torch.fft.irfft(S, n=n_fft, dim=-1).to(real) * w  # (..., T, n_fft)
    n_frames = S.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    k = -(-n_fft // hop)
    if k * hop > n_fft:
        frames = F.pad(frames, (0, k * hop - n_fft))
    segs = frames.reshape(*frames.shape[:-1], k, hop)  # (..., T, k, hop)
    rows = sum(F.pad(segs[..., s, :], (0, 0, s, k - 1 - s)) for s in range(k))
    out = rows.reshape(*frames.shape[:-2], (n_frames + k - 1) * hop)[..., :out_len]
    np_real = np.float64 if real == torch.float64 else np.float32
    wss = _ola_window_sum(window, n_fft, hop, n_frames, np_real)
    wss = torch.as_tensor(np.where(wss > np.finfo(np_real).tiny, wss, 1.0).astype(np_real),
                          device=S.device)
    out = out / wss
    if center:
        p = n_fft // 2
        out = out[..., p : out_len - p]
    if length is not None:
        out = out[..., :length]
    return out


def _griffinlim_torch(mag, n_fft, hop, center, window, n_iter, momentum, init_phase):
    """mag (..., T, F) -> (..., n_samples): Griffin-Lim with momentum
    (Perraudin et al.), the JAX package's update rule, from ``init_phase``."""
    angles = torch.exp(1j * init_phase)
    t_prev = None
    eps = 1e-16
    for _ in range(n_iter):
        inv = _istft_torch(mag * angles, n_fft, hop, center, window)
        rebuilt = _stft_torch(inv, n_fft, hop, center, window, "constant")
        if t_prev is not None:
            rebuilt = rebuilt - (momentum / (1 + momentum)) * t_prev
        t_prev = mag * angles
        angles = rebuilt / (rebuilt.abs() + eps)
    return _istft_torch(mag * angles, n_fft, hop, center, window)


def stft_torch(y: torch.Tensor, n_fft=2048, hop=512, center=True, window="hann",
               pad_mode="constant") -> torch.Tensor:
    """(..., n) float -> (..., T, F) complex, where ``y`` lies."""
    return _stft_torch(y, n_fft, hop, center, window, pad_mode)


def istft_torch(S: torch.Tensor, n_fft=2048, hop=512, center=True, window="hann",
                length=None) -> torch.Tensor:
    return _istft_torch(S, n_fft, hop, center, window, length)


def griffinlim_torch(mag: torch.Tensor, n_fft=2048, hop=512, center=True, window="hann",
                     n_iter=32, momentum=0.99,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Griffin-Lim where ``mag`` lies, its first phase drawn from U(-pi, pi)
    with ``generator`` (a generator of mag's device; seeded 0 where None)."""
    if generator is None:
        generator = torch.Generator(device=mag.device).manual_seed(0)
    mag = mag.float()
    phase = torch.rand(mag.shape, generator=generator, device=mag.device) * (2 * np.pi) - np.pi
    return _griffinlim_torch(mag, n_fft, hop, center, window, n_iter, momentum, phase)


# -- numpy entry points: the torch path on the host ------------------------------------

def stft_np(y, n_fft=2048, hop=512, center=True, window="hann", pad_mode="constant"):
    """(..., n) float -> (..., T, F) complex; float64 in gives complex128.
    Pads with ``np.pad`` (any of its modes), then frames on the torch path."""
    y = np.asarray(y, dtype=np.result_type(y, np.float32))
    if center:
        p = n_fft // 2
        y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(p, p)], mode=pad_mode)
    return _stft_torch(torch.tensor(y), n_fft, hop, False, window, pad_mode).numpy()


def istft_np(S, n_fft=2048, hop=512, center=True, window="hann", length=None):
    """S (..., T, 1 + n_fft // 2) -> (..., n_samples), in the real dtype of
    S (float64 for complex128)."""
    return _istft_torch(torch.tensor(np.asarray(S)), n_fft, hop, center, window,
                        length).numpy()


def griffinlim_np(mag, n_fft=2048, hop=512, center=True, window="hann", n_iter=32,
                  momentum=0.99, seed=0):
    """Griffin-Lim on the host, its first phase drawn with numpy's
    ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    phase = (rng.rand(*np.shape(mag)) * 2 * np.pi - np.pi).astype(np.float32)
    return _griffinlim_torch(torch.tensor(np.asarray(mag)), n_fft, hop, center, window, n_iter,
                             momentum, torch.from_numpy(phase)).numpy().astype(np.float32)
