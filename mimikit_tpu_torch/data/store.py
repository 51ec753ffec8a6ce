"""HDF5-backed array store + batch server.

The port's copy of ``mimikit_tpu/data/store.py``: a :class:`Database` maps
named extractor outputs to h5 arrays (with per-source regions and attrs) in
the JAX package's file layout, so either package opens the other's files,
and a :class:`DataLoader` materializes nested batch-item trees as stacked
numpy arrays on the host (files through :mod:`.h5`).  Training on the card
bypasses it with the on-device gather of
``mimikit_tpu_torch.loops.device_loader``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from . import h5
from .batch import Input, process_batch

__all__ = ["ArrayProxy", "Database", "DataLoader"]


class ArrayProxy:
    """One named feature array: ``db.signal``-style access."""

    def __init__(self, db: "Database", name: str):
        self._db = db
        self.name = name

    @property
    def _ds(self):
        return self._db.h5f[f"{self.name}/data"]

    @property
    def shape(self):
        return self._ds.shape

    @property
    def dtype(self):
        return self._ds.dtype

    def __len__(self):
        return self._ds.shape[0]

    def __getitem__(self, item):
        cached = self._db._cache.get(self.name)
        if cached is not None:
            return cached[item]
        return self._ds[item]

    def __setitem__(self, item, value):
        self._ds[item] = value
        if self.name in self._db._cache:
            self._db._cache.pop(self.name)

    @property
    def attrs(self):
        return self._db.h5f[self.name].attrs

    @property
    def refs(self) -> Tuple[slice, ...]:
        """Per-source regions of the concatenated array."""
        bounds = self._db.h5f[self.name].attrs.get("refs", None)
        if bounds is None:
            return (slice(0, self.shape[0]),)
        b = list(bounds)
        return tuple(slice(int(s), int(e)) for s, e in zip(b[:-1], b[1:]))

    def load_in_memory(self):
        self._db._cache[self.name] = self._ds[:]


class Database:
    """A typed feature file: named arrays + attrs + batch serving."""

    def __init__(self, filename: str, mode: str = "r", keep_open: bool = True):
        self.filename = filename
        self.mode = mode
        self._h5f = h5.File(filename, mode)
        self._cache: Dict[str, np.ndarray] = {}
        self.config = None  # set by DatasetConfig.get/create

    @property
    def h5f(self):
        """Auto-reopens after close(): training loops close their handle on
        teardown, but the Database object commonly outlives them (e.g.
        train then generate from the same db)."""
        f = self._h5f
        if not f:  # h5py file truthiness == is-open
            # a write-mode file already exists afterwards: reopen r+
            mode = {"w": "r+", "w-": "r+", "x": "r+", "a": "r+"}.get(
                self.mode, self.mode
            )
            f = self._h5f = h5.File(self.filename, mode)
        return f

    @h5f.setter
    def h5f(self, value):
        self._h5f = value

    # -- array management ---------------------------------------------------
    def add_array(
        self,
        name: str,
        data: np.ndarray,
        refs: Optional[Sequence[Tuple[int, int]]] = None,
        attrs: Optional[dict] = None,
    ):
        if name in self.h5f:
            del self.h5f[name]
        g = self.h5f.create_group(name) if name not in self.h5f else self.h5f[name]
        g.create_dataset("data", data=np.asarray(data))
        if refs is not None:
            bounds = [0]
            for _, e in refs:
                bounds.append(e)
            g.attrs["refs"] = np.asarray(bounds, dtype=np.int64)
        if attrs:
            for k, v in attrs.items():
                g.attrs[k] = v
        self._cache.pop(name, None)
        return ArrayProxy(self, name)

    def get_array(self, name: str):
        if name in self._cache:
            return self._cache[name]
        return self.h5f[f"{name}/data"]

    def __getattr__(self, name: str):
        # only called when normal lookup fails -> feature-array access
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            h5f = object.__getattribute__(self, "h5f")
        except AttributeError:
            raise AttributeError(name)
        if h5f and name in h5f:
            return ArrayProxy(self, name)
        raise AttributeError(name)

    @property
    def attrs(self):
        return self.h5f.attrs

    @property
    def index(self) -> Dict[str, slice]:
        """source path -> region in the first feature array."""
        sources = self.h5f.attrs.get("sources", [])
        names = [n for n in self.h5f.keys()]
        if not names:
            return {}
        refs = ArrayProxy(self, names[0]).refs
        return {s: r for s, r in zip(sources, refs)}

    def load_in_memory(self):
        for name in self.h5f.keys():
            ArrayProxy(self, name).load_in_memory()

    def flush(self):
        self.h5f.flush()

    def close(self):
        self._h5f.close()

    # -- serving ------------------------------------------------------------
    def serve(
        self,
        batch,
        batch_size: int = 1,
        shuffle: bool = False,
        sampler: Optional[Iterable[int]] = None,
        batch_sampler: Optional[Iterable[Tuple[int, ...]]] = None,
        sampling_jitter: int = 0,
        seed: Optional[int] = None,
        **_ignored,
    ) -> "DataLoader":
        """Build a loader over a nested tree of :class:`Input` leaves.

        Mirrors ``h5m.TypedFile.serve`` + torch ``DataLoader`` semantics used
        by the reference loops (``train_loops.py:114-123``,
        ``generate.py:129-139``); multiprocessing kwargs are accepted and
        ignored (windows are cheap numpy slices here).
        """
        return DataLoader(
            self, batch, batch_size=batch_size, shuffle=shuffle,
            sampler=sampler, batch_sampler=batch_sampler,
            sampling_jitter=sampling_jitter, seed=seed,
        )


class DataLoader:
    def __init__(
        self,
        db: Database,
        batch,
        batch_size: int = 1,
        shuffle: bool = False,
        sampler=None,
        batch_sampler=None,
        sampling_jitter: int = 0,
        seed: Optional[int] = None,
    ):
        self.db = db
        self.batch = batch
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.batch_sampler = batch_sampler
        self.sampling_jitter = sampling_jitter
        self._rng = np.random.RandomState(seed)
        self.leaves: list = []
        process_batch(
            batch, lambda x: isinstance(x, Input), lambda x: self.leaves.append(x) or x
        )
        ns = [l.n_items(db) for l in self.leaves if l.data is not None or l.getter.n]
        self.n_items = max(0, min(ns)) if ns else 0

    def _load_item(self, i: int):
        return process_batch(
            self.batch, lambda x: isinstance(x, Input), lambda x: x.load(self.db, i)
        )

    def _stack(self, items):
        flat_sets = []

        def collect(item):
            leaves = []
            process_batch(
                item,
                lambda x: isinstance(x, np.ndarray) or np.isscalar(x),
                lambda x: leaves.append(x) or x,
            )
            return leaves

        flat_sets = [collect(it) for it in items]
        stacked = [np.stack([fs[j] for fs in flat_sets]) for j in range(len(flat_sets[0]))]
        it = iter(stacked)
        return process_batch(
            items[0],
            lambda x: isinstance(x, np.ndarray) or np.isscalar(x),
            lambda x: next(it),
        )

    def _index_batches(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        if self.sampler is not None:
            buf = []
            for i in self.sampler:
                buf.append(int(i))
                if len(buf) == self.batch_size:
                    yield tuple(buf)
                    buf = []
            if buf:
                yield tuple(buf)
            return
        order = np.arange(self.n_items)
        if self.shuffle:
            self._rng.shuffle(order)
        for k in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield tuple(int(i) for i in order[k : k + self.batch_size])

    def __iter__(self):
        for idx in self._index_batches():
            if self.sampling_jitter:
                # jitter window starts (reference serve(sampling_jitter=...))
                j = self._rng.randint(
                    -self.sampling_jitter, self.sampling_jitter + 1, len(idx)
                )
                idx = tuple(
                    int(np.clip(i + dj, 0, max(0, self.n_items - 1)))
                    for i, dj in zip(idx, j)
                )
            items = [self._load_item(i) for i in idx]
            yield self._stack(items)

    def __len__(self):
        if self.batch_sampler is not None and hasattr(self.batch_sampler, "__len__"):
            return len(self.batch_sampler)
        if self.sampler is not None and hasattr(self.sampler, "__len__"):
            return max(1, len(self.sampler) // self.batch_size)
        return self.n_items // self.batch_size
