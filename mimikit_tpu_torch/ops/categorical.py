"""Fused categorical sampling: ``argmax(logits / t + Gumbel)`` per row.

A CUDA kernel (``csrc/categorical.cu``) replaces the TPU kernel
``_categorical_call`` (K9, ``mimikit_tpu/ops/pallas_kernels.py:159``,
reached through ``categorical`` ``:196``), which
``CategoricalSampler(impl="pallas")`` calls.

The work is one pass over each (Q,) row of logits: scale by 1/t, add Gumbel
noise, take the row's argmax (ties to the lowest index).  A row's logits are
spread over its threads at about four a thread, read four at once in the
logits' own dtype (float32, bfloat16 or float16) and row stride, so a call
neither casts nor copies.
Bound on the card: bytes, and at the decode path's widths the launch itself.

Noise: the port's counter hash keyed (seed, row, class) from
``csrc/noise.cuh``, which every decode kernel includes; the plain twin
:func:`categorical_plain` draws the same noise through :mod:`.noise`.  The
TPU kernel's bits came from the chip's own generator and are not reproduced:
draws match JAX's in distribution only.

The wrapper's rule: a CPU tensor takes the plain twin; a CUDA tensor
launches the kernel or raises.  The kernel is built with nvcc on the first
launch (``ops/nvcc.py``), never when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .noise import gumbel_rows
from .nvcc import CSRC, build_library

__all__ = ["categorical", "categorical_plain", "build_kernel"]

SOURCE = CSRC / "categorical.cu"
# the logits' dtypes the kernel reads, by its code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def categorical_plain(logits: torch.Tensor, temperature: float, seed: int) -> torch.Tensor:
    """The plain PyTorch twin: (..., Q) logits -> (...,) int32 indices."""
    lead, Q = logits.shape[:-1], logits.shape[-1]
    flat = logits.reshape(-1, Q).to(torch.float32)
    scores = flat / temperature + gumbel_rows(seed, flat.shape[0], Q, flat.device)
    return torch.argmax(scores, dim=-1).to(torch.int32).reshape(lead)


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_kernel() -> Path:
    """Compile ``csrc/categorical.cu`` for sm_90a into ``build/kernels/``
    and return the library's path."""
    path, log = build_library(SOURCE, "mmk_categorical")
    if log:
        _Kernel.build_log = log
    return path


def _library():
    if _Kernel.lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mmk_categorical.argtypes = [p, p, i, i, ctypes.c_longlong, i, ctypes.c_float,
                                        ctypes.c_uint, i, p]
        lib.mmk_categorical.restype = i
        lib.mmk_categorical_error_string.argtypes = [i]
        lib.mmk_categorical_error_string.restype = ctypes.c_char_p
        _Kernel.lib = lib
    return _Kernel.lib


def _raise_on(err: int, what: str):
    if err != 0:
        msg = _library().mmk_categorical_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg}")


def _stream(x: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``x``'s device, read as
    Triton's launcher reads it (``torch.cuda.current_stream`` builds a
    Stream object a call, several microseconds of a sampler call's host
    time)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _rows(logits: torch.Tensor) -> torch.Tensor:
    """(rows, Q) of ``logits`` with unit stride along Q: a view where the
    leading dims collapse into one stride, else a copy."""
    Q = logits.shape[-1]
    if logits.dtype not in _DTYPES:
        logits = logits.to(torch.float32)
    if logits.stride(-1) == 1 or Q == 1:
        try:
            return logits.view(-1, Q)
        except RuntimeError:
            pass
    return logits.reshape(-1, Q).contiguous()


def categorical(logits: torch.Tensor, temperature: float, seed: int) -> torch.Tensor:
    """Sample class indices from (..., Q) logits with temperature by the
    Gumbel-argmax trick.  Returns (...,) int32.  CPU tensors take
    :func:`categorical_plain`; CUDA tensors launch the kernel."""
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if logits.device.type == "cpu":
        return categorical_plain(logits, temperature, seed)
    if logits.device.type != "cuda":
        raise ValueError(f"the categorical kernel runs on CUDA tensors, got {logits.device}")
    lead, Q = logits.shape[:-1], logits.shape[-1]
    if Q < 1:
        raise ValueError("the categorical kernel needs at least one class")
    flat = _rows(logits)
    B = flat.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=flat.device)
    if B:
        stride = flat.stride(0) if B > 1 else Q
        # the kernel reads four logits at once where every row starts aligned to them
        vec = int(flat.data_ptr() % (4 * flat.element_size()) == 0 and stride % 4 == 0)
        err = _library().mmk_categorical(
            flat.data_ptr(), out.data_ptr(), B, Q, stride, _DTYPES[flat.dtype],
            float(temperature), seed & 0xFFFFFFFF, vec, _stream(flat),
        )
        _raise_on(err, "categorical kernel launch")
        categorical.launches += 1
    return out.reshape(lead)


categorical.launches = 0
