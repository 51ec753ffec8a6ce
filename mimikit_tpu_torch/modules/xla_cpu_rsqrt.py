"""f32 ``rsqrt`` as XLA's CPU backend computes it, for CPU tensors.

XLA lowers an f32 ``rsqrt`` on x86 to the CPU's approximation instruction
(``vrsqrtps`` on 8 floats at XLA's default 256-bit vector width, AVX-512
hosts included; ``rsqrtss`` on a loop's tail) and two Newton steps
``y' = fma(-y / 2, fma(x y, y, -1), y)``, the bare approximation where x is
not a positive normal number: 36 % of the values in [1e-4, 10] differ from
``torch.rsqrt``'s.  The bf16 layer norm of the port's CPU path
(``rounding.layer_norm``) takes it so that its steps follow JAX's.
PyTorch does not expose the instruction, so ``csrc/xla_cpu_rsqrt.c`` is
compiled with the host's ``gcc`` at first use into ``build/host/`` (named by
the source's hash) and loaded with ``ctypes``.  Nothing is compiled when the
module is imported, and a helper that cannot be built raises: there is no
fallback to ``torch.rsqrt``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["xla_rsqrt"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "xla_cpu_rsqrt.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CFLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if platform.machine().lower() not in ("x86_64", "amd64"):
        raise RuntimeError(f"XLA's CPU rsqrt is the x86 approximation; this host is "
                           f"{platform.machine()}")
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libxla_cpu_rsqrt_{digest}.so"
    if not path.exists():
        gcc = shutil.which("gcc") or shutil.which("cc")
        if gcc is None:
            raise RuntimeError("no C compiler: the CPU rsqrt helper cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        res = subprocess.run([gcc, *CFLAGS, "-o", tmp, str(SOURCE), "-lm"],
                             capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.mmk_xla_cpu_rsqrt.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.mmk_xla_cpu_rsqrt.restype = None
    _lib = lib
    return lib


def xla_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``rsqrt`` of a CPU f32 tensor, bit for bit as XLA's CPU backend
    computes it (no gradient: the layer norm's backward reads the value)."""
    if x.device.type != "cpu" or x.dtype != torch.float32:
        raise ValueError(f"xla_rsqrt takes CPU f32 tensors, not {x.device} {x.dtype}")
    lib = _library()
    src = x.detach().contiguous()
    out = torch.empty_like(src)
    lib.mmk_xla_cpu_rsqrt(src.data_ptr(), out.data_ptr(), src.numel())
    return out
