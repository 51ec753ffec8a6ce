"""Batch item declarations: windowed reads over stored arrays.

The port's copy of ``mimikit_tpu/data/batch.py`` (numpy only; the port
imports nothing of the JAX package).  An :class:`Input` names a stored
array, a windowing :class:`Getter`, and an optional transform applied per
item (on the host, numpy path).
"""
from __future__ import annotations

import dataclasses as dtc
from typing import Callable, Optional

import numpy as np

__all__ = ["Getter", "AsSlice", "AsFramedSlice", "Input", "process_batch"]


@dtc.dataclass
class Getter:
    """Base: reads item ``i`` as-is; ``n`` items = array length."""

    n: Optional[int] = None

    def __call__(self, arr, i):
        return arr[i]

    def n_items(self, total: int) -> int:
        return self.n if self.n is not None else total


@dtc.dataclass
class AsSlice(Getter):
    """Read ``arr[i + shift : i + shift + length*downsampling : downsampling]``
    along ``dim`` (only dim=0 is used by the framework)."""

    dim: int = 0
    shift: int = 0
    length: int = 1
    downsampling: int = 1

    def __call__(self, arr, i):
        start = i + self.shift
        stop = start + self.length * self.downsampling
        if self.dim == 0:
            return np.asarray(arr[start : stop : self.downsampling])
        sl = [slice(None)] * arr.ndim
        sl[self.dim] = slice(start, stop, self.downsampling)
        return np.asarray(arr[tuple(sl)])

    def n_items(self, total: int) -> int:
        span = self.shift + self.length * self.downsampling
        return max(0, total - span + 1)


@dtc.dataclass
class AsFramedSlice(AsSlice):
    frame_size: int = 1
    as_strided: bool = True

    def __call__(self, arr, i):
        x = super().__call__(arr, i)
        if self.as_strided:
            n = x.shape[0] - self.frame_size + 1
            idx = np.arange(self.frame_size)[None, :] + np.arange(n)[:, None]
            return x[idx]
        return x.reshape(-1, self.frame_size)


class Input:
    """A named, windowed, transformed read from the database."""

    def __init__(
        self,
        data: Optional[str] = None,
        getter: Optional[Getter] = None,
        transform: Optional[Callable] = None,
    ):
        self.data = data
        self.getter = getter if getter is not None else Getter()
        self.transform = transform

    def n_items(self, db) -> int:
        total = db.get_array(self.data).shape[0] if self.data is not None else 0
        return self.getter.n_items(total)

    def load(self, db, i: int):
        arr = db.get_array(self.data) if self.data is not None else None
        x = self.getter(arr, i) if arr is not None else self(i)
        if self.transform is not None:
            x = self.transform(x)
        return x

    def __call__(self, item, file=None, **kwargs):
        raise NotImplementedError


def process_batch(batch, predicate, fn):
    """Tree-map ``fn`` over leaves of nested tuples/lists/dicts matching
    ``predicate`` (h5mapper ``process_batch`` equivalent)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(process_batch(b, predicate, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: process_batch(v, predicate, fn) for k, v in batch.items()}
    if predicate(batch):
        return fn(batch)
    return batch
