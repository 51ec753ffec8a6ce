"""The launch floor: one launch of an empty kernel (``tools/launch_floor.cu``).

:func:`empty_launch` launches it on PyTorch's current stream; the kernel is
built with the port's nvcc flags into ``build/kernels/`` at the first call
(:func:`build_kernel`).  ``chip_smoke.py`` and ``tools/ab_categorical.py``
time it beside the categorical sampler (K9).
"""
import ctypes
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from mimikit_tpu_torch.ops.nvcc import build_library  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "launch_floor.cu"


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_kernel() -> Path:
    path, log = build_library(SOURCE, "mmk_launch_floor")
    if log:
        _Kernel.build_log = log
    return path


def empty_launch() -> None:
    """One launch of the empty kernel on the current stream; raises if the
    launch fails."""
    if _Kernel.lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        lib.mmk_empty_launch.argtypes = [ctypes.c_void_p]
        lib.mmk_empty_launch.restype = ctypes.c_int
        _Kernel.lib = lib
    err = _Kernel.lib.mmk_empty_launch(torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel launch failed: cudaError_t {err}")
