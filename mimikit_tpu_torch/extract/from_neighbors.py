"""Neighbor-based output scoring (counterpart of
``mimikit_tpu/extract/from_neighbors.py``): the nearest neighbor of each
frame by angular distance, the framed repeat rate, and the cumulative
entropy that ``demos/checkpoint_k_bests.py`` ranks outputs by."""
from __future__ import annotations

import numpy as np
import torch

from ..modules.loss_functions import AngularDistance

__all__ = ["nearest_neighbor", "cum_entropy", "repeat_rate", "frame"]


def nearest_neighbor(X, Y):
    """The nearest row of Y for each row of X by angular distance; returns
    (distances, indices) as numpy arrays.  Tensors are taken where they lie;
    arrays on the CPU."""
    X, Y = torch.as_tensor(X), torch.as_tensor(Y)
    # JAX's promotion: an integer array meets the other's float type
    dtype = torch.promote_types(X.dtype, Y.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float32
    D_xy = AngularDistance(reduction="none")(X.to(dtype), Y.to(X.device, dtype))
    # argmin takes the first of tied minima, as jnp.argmin
    return D_xy.amin(-1).cpu().numpy(), D_xy.argmin(-1).cpu().numpy()


def frame(x: np.ndarray, frame_size: int, hop_length: int) -> np.ndarray:
    """The last axis as overlapping frames."""
    x = np.asarray(x)
    n = 1 + (x.shape[-1] - frame_size) // hop_length
    idx = np.arange(frame_size)[None, :] + hop_length * np.arange(n)[:, None]
    return x[..., idx]


def repeat_rate(x, frame_size, hop_length):
    """1 - (distinct values - 1) / (frame_size - 1), a frame."""
    framed = frame(np.asarray(x), frame_size, hop_length)
    flat = framed.reshape(-1, framed.shape[-1])
    uniques = np.asarray([len(np.unique(row)) for row in flat])
    return (1 - (uniques - 1) / (frame_size - 1)).reshape(framed.shape[:-1])


def cum_entropy(neighbors, reduce="sum", neg_diff=True):
    """Cumulative entropy of a (time,) sequence of neighbor indices: at each
    step the entropy of the indices seen so far, signed by its change where
    ``neg_diff``; summed where ``reduce`` is "sum"."""
    neighbors = np.asarray(neighbors)
    items, idx = np.unique(neighbors, return_inverse=True)
    T = neighbors.shape[0]
    cum_probs = np.zeros((items.shape[0], T))
    cum_probs[idx, np.arange(T)] = 1
    cum_probs = np.cumsum(cum_probs, axis=1)
    cum_probs = cum_probs / cum_probs.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_p = np.where(cum_probs > 0, np.log(cum_probs), 0.0)
    e_wrt_t = (-cum_probs * log_p).sum(axis=0)
    if neg_diff:
        diff = np.diff(e_wrt_t, append=0.0)
        e_wrt_t = np.sign(diff) * e_wrt_t
    return e_wrt_t.sum() if reduce == "sum" else e_wrt_t
