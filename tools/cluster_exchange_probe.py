"""Time one activation exchange inside a thread-block cluster on the card.

Usage, on a machine with one card: ``python3 tools/cluster_exchange_probe.py``.
It builds ``tools/cluster_exchange_probe.cu`` for sm_90a and prints, for
clusters of 8 and 16 blocks of 512 threads exchanging R = 6 rows of d = 128
floats (a jukebox3 stage's widest rows), the microseconds of one exchange in
each mode of the source (the barrier alone; a push of every block's slice to
every peer, then the cluster barrier; the push, then per-consumer remote
mbarrier arrives; the barrier, then a word-by-word pull), as the median of 5
CUDA-event timings of one launch of 20,000 exchanges, and the card's name
and power limit.  The last line is one JSON object of the same numbers.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mimikit_tpu_torch.ops.nvcc import build_library  # noqa: E402

MODES = {0: "barrier alone", 1: "push + cluster barrier", 2: "push + remote mbarrier arrives",
         3: "barrier + word-by-word pull"}
ITERS, R, D = 20_000, 6, 128


def measure(lib_dir: Path = ROOT) -> dict:
    """{"CL<cl> mode<m>": microseconds an exchange} for clusters of 8 and 16
    blocks and every mode, built from ``lib_dir``'s copy of the source."""
    path, _ = build_library(lib_dir / "tools" / "cluster_exchange_probe.cu", "mmk_cluster_probe")
    lib = ctypes.CDLL(str(path))
    lib.mmk_probe.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.mmk_probe.restype = ctypes.c_int
    lib.mmk_probe_error_string.argtypes = [ctypes.c_int]
    lib.mmk_probe_error_string.restype = ctypes.c_char_p
    sink = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(cl, mode, iters):
        err = lib.mmk_probe(cl, mode, iters, R, D, sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"probe CL={cl} mode={mode}: {lib.mmk_probe_error_string(err).decode()}")

    out = {}
    for cl in (8, 16):
        for mode, what in MODES.items():
            run(cl, mode, 100)
            ms = []
            for _ in range(5):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                run(cl, mode, ITERS)
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            out[f"CL{cl} mode{mode}"] = us = 1e3 * statistics.median(ms) / ITERS
            print(f"CL={cl} {what}: {us:.4f} us an exchange (median of 5; {ms})", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_exchange_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": card, "rows": R, "d": D, "iters": ITERS, "us": measure()}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
