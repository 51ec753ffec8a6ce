"""Small shared utilities (counterpart of ``mimikit_tpu/utils.py``)."""
import os
import re
from enum import Enum
from typing import Optional, Union

import torch

__all__ = [
    "AutoStrEnum",
    "SOUND_FILE_REGEX",
    "DATASET_REGEX",
    "CHECKPOINT_REGEX",
    "FileWalker",
    "default_device",
    "resolve_device",
]

SOUND_FILE_REGEX = re.compile(r".*\.(wav|aif|aiff|mp3|m4a|mp4|flac|ogg|npy)$")
DATASET_REGEX = re.compile(r".*\.h5$")
CHECKPOINT_REGEX = re.compile(r".*\.ckpt$")


class AutoStrEnum(str, Enum):
    """String-valued enum: members' values equal their names, so configs can
    compare against plain strings and YAML stores them as strings."""

    def _generate_next_value_(name, start, count, last_values):  # noqa: N805
        return name

    def __str__(self):
        return self.value


def FileWalker(pattern, root="./"):
    """Yield the files under ``root`` (a path or a list of paths) whose name
    or path matches the regex ``pattern``, each directory's files in sorted
    order (h5mapper's ``FileWalker``, as ``mimikit_tpu/utils.py:31-45``)."""
    rex = re.compile(pattern) if isinstance(pattern, str) else pattern
    roots = [root] if isinstance(root, (str, bytes)) else list(root)
    for r in roots:
        if os.path.isfile(r):
            if rex.match(r):
                yield r
            continue
        for dirpath, _, files in os.walk(r):
            for f in sorted(files):
                if rex.match(f) or rex.match(os.path.join(dirpath, f)):
                    yield os.path.join(dirpath, f)


def default_device() -> torch.device:
    """The port's entry points run on the card: return ``cuda``.

    Raises when no CUDA device is present — a caller who wants the CPU
    passes ``device="cpu"`` explicitly (the CPU tests do); nothing falls
    back to the CPU silently."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mimikit_tpu_torch runs on a CUDA device and none is available;"
            " pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` -> :func:`default_device`; a CUDA request without a card
    raises instead of running on the CPU."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device '{device}' requested but CUDA is not available")
    return device
