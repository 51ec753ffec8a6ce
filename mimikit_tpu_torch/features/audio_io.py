"""Reading and writing audio files (counterpart of
``mimikit_tpu/features/audio_io.py``).

WAV is decoded with scipy and ``.npy`` arrays are read as they are; other
formats go through ``soundfile`` or an ``ffmpeg`` subprocess where either is
installed.  A file at another rate than the one asked for is resampled
(:func:`.dsp.resample_np`).  Output is WAV, peak-normalised where the signal
leaves [-1, 1]; another extension is encoded with ffmpeg where it is
installed, else the file is written as WAV under the ``.wav`` extension.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from .dsp import resample_np

__all__ = ["load_audio", "write_wav", "write_audio"]


def _read_wav(path: str) -> Tuple[int, np.ndarray]:
    from scipy.io import wavfile

    sr, y = wavfile.read(path)
    if y.dtype == np.int16:
        y = y.astype(np.float32) / 32768.0
    elif y.dtype == np.int32:
        y = y.astype(np.float32) / 2147483648.0
    elif y.dtype == np.uint8:
        y = (y.astype(np.float32) - 128.0) / 128.0
    else:
        y = y.astype(np.float32)
    return sr, y


def _read_via_ffmpeg(path: str, sr: int) -> Tuple[int, np.ndarray]:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode '{path}': not a wav/npy file and neither soundfile"
            " nor ffmpeg is available"
        )
    cmd = [ffmpeg, "-v", "quiet", "-i", path, "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1",
           "-ar", str(sr), "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    return sr, np.frombuffer(raw, dtype=np.float32).copy()


def load_audio(path: str, sr: int = 22050, offset: float = 0.0,
               duration: Optional[float] = None, mono: bool = True) -> np.ndarray:
    """The file as float32 (mono by default) at ``sr``; ``offset`` and
    ``duration`` in seconds of the file."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        y = np.load(path).astype(np.float32)
        file_sr = sr
    elif ext in (".wav", ".wave"):
        file_sr, y = _read_wav(path)
    else:
        try:
            import soundfile as sf

            y, file_sr = sf.read(path, dtype="float32")
        except ImportError:
            file_sr, y = _read_via_ffmpeg(path, sr)
    if mono and y.ndim > 1:
        y = y.mean(axis=-1)
    y = y.astype(np.float32)
    if offset > 0.0:
        y = y[int(offset * file_sr):]
    if duration is not None:
        y = y[: int(duration * file_sr)]
    if file_sr != sr:
        y = resample_np(y, file_sr, sr)
    return np.ascontiguousarray(y, dtype=np.float32)


def write_wav(path: str, y: np.ndarray, sr: int) -> str:
    """16-bit PCM at ``sr``, divided by the peak where it passes 1."""
    from scipy.io import wavfile

    y = np.asarray(y, dtype=np.float32)
    peak = np.max(np.abs(y)) if y.size else 0.0
    if peak > 1.0:
        y = y / peak
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sr, (y * 32767.0).astype(np.int16))
    return path


def write_audio(path: str, y: np.ndarray, sr: int) -> str:
    """Write ``y`` to ``path`` and return the path written: WAV for a
    ``.wav`` or no extension; another extension through ffmpeg where it is
    installed, else WAV with the extension swapped."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".wav", ".wave", ""):
        return write_wav(path if ext else path + ".wav", y, sr)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return write_wav(os.path.splitext(path)[0] + ".wav", y, sr)
    tmp = os.path.splitext(path)[0] + ".tmp.wav"
    write_wav(tmp, y, sr)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    subprocess.run([ffmpeg, "-v", "quiet", "-y", "-i", tmp, path], check=True)
    os.remove(tmp)
    return path
