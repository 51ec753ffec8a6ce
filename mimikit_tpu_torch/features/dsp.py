"""Resampling (counterpart of ``resample_np`` in
``mimikit_tpu/features/dsp.py``).  The rest of that module (STFT, ISTFT,
Griffin-Lim, the filterbanks) comes with the spectral networks."""
from __future__ import annotations

from math import gcd

import numpy as np

__all__ = ["resample_np"]


def resample_np(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy's ``resample_poly``, its Kaiser window)
    along the last axis, in float32."""
    from scipy.signal import resample_poly

    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    if up == down:
        return np.asarray(y)
    return resample_poly(np.asarray(y, dtype=np.float32), up, down, axis=-1).astype(np.float32)
