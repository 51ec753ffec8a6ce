"""Named feature extraction, as a config object.

Counterpart of ``mimikit_tpu/features/extractor.py`` without the h5 store
(the data layer is not ported yet): an :class:`Extractor` names a feature and
the functional that computes it, which is what ``IOSpec`` binds to.
"""
from __future__ import annotations

import dataclasses as dtc
from typing import Optional

from ..config import Config
from .functionals import Compose, FileToSignal, Functional, Normalize, RemoveDC

__all__ = ["Extractor"]


@dtc.dataclass
class Extractor(Config, type_field=False):
    name: str
    functional: Functional
    merge_files_labels: bool = False
    consolidate_labels: bool = False
    derived_from: Optional[str] = None

    @staticmethod
    def signal(sr: int = 16000) -> "Extractor":
        return Extractor(
            name="signal",
            functional=Compose(FileToSignal(sr=sr), Normalize(), RemoveDC()),
        )
