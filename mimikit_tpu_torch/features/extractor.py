"""Named feature extraction at dataset-creation time.

Counterpart of ``mimikit_tpu/features/extractor.py``: an :class:`Extractor`
names a feature and the functional that computes it (what ``IOSpec`` binds
to), applies it to every source file (or to another extractor's output when
``derived_from`` is set) and post-processes discrete labels (class_size
stamping, cross-file label merging, consolidation) in the h5 store.
"""
from __future__ import annotations

import dataclasses as dtc
from typing import Optional

import numpy as np

from ..config import Config
from .functionals import Compose, Discrete, FileToSignal, Functional, Normalize, RemoveDC

__all__ = ["Extractor"]


@dtc.dataclass
class Extractor(Config, type_field=False):
    name: str
    functional: Functional
    merge_files_labels: bool = False
    consolidate_labels: bool = False
    derived_from: Optional[str] = None

    def load(self, inputs):
        return self.functional(inputs)

    # -- discrete-label post-processing (one mode applies per extractor) ----
    @staticmethod
    def _merge_file_labels(labels) -> int:
        """offset each file's labels so they don't collide (e.g. clustering)"""
        refs = labels.refs
        for prev, cur in zip(refs[:-1], refs[1:]):
            labels[cur] = labels[cur] + int(labels[prev].max()) + 1
        return int(labels[refs[-1]].max()) + 1

    @staticmethod
    def _consolidate(labels) -> int:
        """re-index to a dense 0..K-1 range (e.g. after ArgMax)"""
        flat = np.asarray(labels[:])
        unq, inv = np.unique(flat, return_inverse=True)
        labels[:] = inv.reshape(flat.shape)
        return len(unq)

    def after_create(self, db, attr: str):
        if not isinstance(self.functional.elem_type, Discrete):
            return
        labels = getattr(db, attr)
        if self.merge_files_labels:
            k = self._merge_file_labels(labels)
        elif self.consolidate_labels:
            k = self._consolidate(labels)
        else:
            k = int(labels[:].max()) + 1
        labels.attrs["class_size"] = k

    @property
    def class_size(self):
        """available once the dataset has been extracted"""
        return self.attrs["class_size"]

    @staticmethod
    def signal(sr: int = 16000) -> "Extractor":
        return Extractor(
            name="signal",
            functional=Compose(FileToSignal(sr=sr), Normalize(), RemoveDC()),
        )
