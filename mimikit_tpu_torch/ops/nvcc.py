"""Build a kernel source of ``csrc/`` with ``nvcc`` at first use.

Each ``.cu`` file has a plain C interface and compiles on its own, for
sm_90a, into a shared library under ``build/kernels/`` named by the hash of
the source and of the ``csrc/`` headers it includes (an edited source or
header is never served stale); the caller loads it with ``ctypes``.  Nothing
is compiled when a module is imported.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

__all__ = ["CSRC", "build_library", "source_digest"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_digest(source: Path) -> str:
    """sha256 of ``source`` and, recursively, of every header it includes
    with quotes (looked up beside it)."""
    h, seen, todo = hashlib.sha256(), set(), [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        data = path.read_bytes()
        h.update(path.name.encode() + b"\0" + data)
        todo += [path.parent / m.decode() for m in _LOCAL_INCLUDE.findall(data)]
    return h.hexdigest()


def build_library(source: Path, stem: str) -> Tuple[Path, str]:
    """Compile ``source`` into ``build/kernels/lib<stem>_<hash>.so``.
    Returns the library's path and the compiler's output ("" when the
    library was already built)."""
    path = BUILD_DIR / f"lib{stem}_{source_digest(source)[:16]}.so"
    if path.exists():
        return path, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)], capture_output=True, text=True
    )
    log = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
    os.replace(tmp, path)
    return path, log
