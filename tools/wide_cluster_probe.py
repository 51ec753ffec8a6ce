"""What the wide LSTM kernels' launch can count on, on one card.

Usage, on a machine with one card: ``python3 tools/wide_cluster_probe.py``
(~20 s).  It builds ``tools/wide_cluster_probe.cu`` for sm_90a and prints
the clusters of 2, 4, 8 and 16 blocks (one block a streaming multiprocessor,
256 threads, 150 KB, 200 KB and 227 KB of shared memory) the card holds at
once (``cudaOccupancyMaxActiveClusters``), whether a launch of 128 blocks
may carry a cluster dimension and ``cudaLaunchAttributeCooperative``
together (and whether cooperative groups' grid sync then runs), and the
microseconds of one grid barrier over 128 blocks, by cooperative groups or
by a counter in device memory, as the median of 5 CUDA-event timings of one
launch of 20,000 barriers, beside the card's name and power limit.  The
last line is one JSON object of the same numbers.
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

ITERS = 20_000


def main() -> int:
    path, _ = build_library(ROOT / "tools" / "wide_cluster_probe.cu", "mmk_wide_cluster_probe")
    lib = ctypes.CDLL(str(path))
    lib.mmk_probe_clusters.argtypes = [ctypes.c_int] * 2
    lib.mmk_probe_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.mmk_probe_error_string.argtypes = [ctypes.c_int]
    lib.mmk_probe_error_string.restype = ctypes.c_char_p
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "clusters": {}, "launch": {}, "barrier_us": {}}
    for cl in (2, 4, 8, 16):
        for smem in (150 * 1024, 200 * 1024, 232448):
            out["clusters"][f"cl={cl} smem={smem}"] = lib.mmk_probe_clusters(cl, smem)
    ctr = torch.zeros(4, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    smem = 200 * 1024
    for cl in (1, 2, 4, 8):
        for coop, mode in ((1, 0), (1, 1), (0, 1)):
            key = f"cl={cl} coop={coop} {'cg grid sync' if mode == 0 else 'counter'}"
            if not coop and (cl == 1 or lib.mmk_probe_clusters(cl, smem) * cl < 128):
                # a counter barrier over blocks that are not all resident hangs
                out["launch"][key] = "not run: the card cannot hold 128 blocks at once"
                continue
            err = lib.mmk_probe_launch(cl, smem, coop, 10, mode, ctr.data_ptr(), stream)
            if err == 0:
                try:
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    out["launch"][key] = f"fault: {e}"
                    break
            out["launch"][key] = "ok" if err == 0 else lib.mmk_probe_error_string(err).decode()
            if err:
                continue
            if cl == 4 or (cl == 1 and coop == 1):
                ms = []
                for _ in range(5):
                    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    a.record()
                    lib.mmk_probe_launch(cl, smem, coop, ITERS, mode, ctr.data_ptr(), stream)
                    b.record()
                    b.synchronize()
                    ms.append(a.elapsed_time(b))
                out["barrier_us"][key] = 1e3 * statistics.median(ms) / ITERS
    for k, v in {**out["clusters"], **out["launch"], **out["barrier_us"]}.items():
        print(f"{k}: {v}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
