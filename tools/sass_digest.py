"""Digest the machine code of a CUDA source's kernels in one or more checkouts.

Usage, on a machine with the CUDA toolkit:
``python3 tools/sass_digest.py <source under mimikit_tpu_torch/csrc> <root> [<root> ...]``,
e.g. ``python3 tools/sass_digest.py jukebox_decode.cu . build/parent``.  For
each checkout it builds ``<root>/mimikit_tpu_torch/csrc/<source>`` for sm_90a
with the package's flags (``ops/nvcc.py``) into ``build/sass_digest/`` and
prints one JSON line: per kernel (its mangled name), the sha256 prefix of its
SASS (``cuobjdump -sass``, addresses and encodings dropped) and its
registers and stack bytes a thread (``cuobjdump -res-usage``).  Equal digests
are equal machine code: a change to comments only must leave them equal.
"""
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mimikit_tpu_torch.ops.nvcc import NVCC_FLAGS  # noqa: E402


def digests(lib: Path) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    usage = {}
    for line in subprocess.run([tool, "-res-usage", str(lib)], capture_output=True, text=True,
                               check=True).stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if m:
            usage[name] = f"REG {m.group(1)} STACK {m.group(2)}"
    out, name, lines = {}, None, []
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout.splitlines() + ["Function : <end>"]
    for line in sass:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name is not None:
                out[name] = (hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16] + ", "
                             + usage.get(name, "?"))
            name, lines = m.group(1), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if m:
            lines.append(m.group(1))
    return out


def main() -> int:
    source, roots = sys.argv[1], sys.argv[2:]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    work = ROOT / "build" / "sass_digest"
    work.mkdir(parents=True, exist_ok=True)
    result = {}
    for i, root in enumerate(roots):
        lib = work / f"lib{i}_{Path(source).stem}.so"
        src = Path(root).resolve() / "mimikit_tpu_torch" / "csrc" / source
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                       capture_output=True)
        result[root] = digests(lib)
    print(json.dumps({"source": source, "digests": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
