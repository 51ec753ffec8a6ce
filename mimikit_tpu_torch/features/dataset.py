"""Dataset creation/loading: sources x extractors -> typed feature file.

Counterpart of ``mimikit_tpu/features/dataset.py``, writing the same h5
layout through :class:`~mimikit_tpu_torch.data.store.Database`: per
extractor, the concatenation of all per-source outputs with region refs,
the sources list and the file's own YAML config in the file attrs.  Either
package opens the other's files.  Extraction is serial (the JAX package's
process pool and writer thread are not ported).
"""
from __future__ import annotations

import dataclasses as dtc
import os
from typing import Tuple

import numpy as np

from ..config import Config
from ..data.store import Database
from .extractor import Extractor

__all__ = ["DatasetConfig"]


@dtc.dataclass
class DatasetConfig(Config, type_field=False):
    sources: Tuple[str, ...] = tuple()
    filename: str = "dataset.h5"
    extractors: Tuple[Extractor, ...] = tuple()

    def __post_init__(self):
        if not self.filename.startswith("/"):
            self.filename = os.path.abspath(self.filename)

    @property
    def schema(self):
        return {e.name: e for e in self.extractors}

    def create(self, mode: str = "w") -> Database:
        """Extract every (extractor, source) pair and write the dataset."""
        self.__post_init__()
        # sources that moved: look for their basename under the cwd
        # (``mimikit_tpu/features/dataset.py:66-80``)
        fixed = []
        for src in self.sources:
            if not os.path.isfile(src):
                base = os.path.split(src)[-1]
                for root, _, files in os.walk(os.getcwd()):
                    if base in files:
                        src = os.path.join(root, base)
                        break
            fixed.append(src)
        self.sources = tuple(fixed)

        db = Database(self.filename, mode=mode)
        db.attrs["sources"] = list(map(str, self.sources))
        per_source: dict = {}
        # non-derived extractors first
        for extractor in sorted(self.extractors, key=lambda e: e.derived_from is not None):
            outs, refs, pos = [], [], 0
            for src in self.sources:
                inp = per_source[(extractor.derived_from, src)] if extractor.derived_from else src
                out = np.asarray(extractor.load(inp))
                per_source[(extractor.name, src)] = out
                outs.append(out)
                refs.append((pos, pos + out.shape[0]))
                pos += out.shape[0]
            data = np.concatenate(outs, axis=0) if outs else np.zeros((0,))
            db.add_array(extractor.name, data, refs=refs)
            extractor.after_create(db, extractor.name)
            extractor.attrs = dict(db.h5f[extractor.name].attrs)
        db.attrs["config"] = self.serialize()
        db.flush()
        db.config = self
        return db

    def get(self, mode: str = "r") -> Database:
        self.__post_init__()
        db = Database(self.filename, mode=mode)
        if "config" in db.attrs:
            db.config = Config.deserialize(db.attrs["config"], DatasetConfig)
        else:
            db.config = self
        for e in self.extractors:
            if e.name in db.h5f:
                e.attrs = dict(db.h5f[e.name].attrs)
        return db
