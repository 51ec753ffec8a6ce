"""Time one WaveNet gated-conv product on a thread-block cluster, and its push.

Usage, on a machine with one card: ``python3 tools/wavenet_product_probe.py``.
It builds ``tools/wavenet_product_probe.cu`` for sm_90a and prints, for one
cluster of CL = 8 and 16 blocks with the weights resident in shared memory
(K = 256, the block's 2D / CL of WaveNet-10's 2D = 256 gate columns), S = 1, 8
and 32 rows, the microseconds of one iteration in each mode of the source
(the product alone; the product, gate, push from registers and cluster
barrier; the push and barrier alone; the product's sums through shared memory
before the push, as the JukeBox group kernel does), at warp tasks of R = 1, 2,
4 and 8 rows, both lane maps (the quad in the lane's low bits, or the slice:
the latter conflicts on shared-memory banks) and 256 or 512 threads a block;
each the median of 3 CUDA-event timings of one launch of 4,000 iterations.
Then the card's name and power limit, and the numbers as one JSON object on
the last line.
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

MODES = {0: "product", 1: "product+gate+push+barrier", 2: "push+barrier",
         3: "product+smem sums+push+barrier"}
ITERS = 4000


def measure() -> dict:
    path, log = build_library(ROOT / "tools" / "wavenet_product_probe.cu", "mmk_product_probe")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    lib = ctypes.CDLL(str(path))
    lib.mmk_product_probe.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.mmk_product_probe.restype = ctypes.c_int
    lib.mmk_product_probe_error_string.argtypes = [ctypes.c_int]
    lib.mmk_product_probe_error_string.restype = ctypes.c_char_p
    sink = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(cl, nt, r, mode, lane_map, iters, S):
        err = lib.mmk_product_probe(cl, nt, r, mode, lane_map, iters, S, sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"probe: {lib.mmk_product_probe_error_string(err).decode()}")

    def us(*cfg):
        run(*cfg[:5], 50, cfg[5])
        ms = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run(*cfg[:5], ITERS, cfg[5])
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return 1e3 * statistics.median(ms) / ITERS

    out = {}
    for cl in (8, 16):
        for S in (1, 8, 32):
            key = f"CL{cl} S{S}"
            out[f"{key} push+barrier"] = us(cl, 256, 1, 2, 0, S)
            for nt in (256, 512):
                for r in (1, 2, 4, 8):
                    if r > 1 and r > S:
                        continue
                    for mode in (0, 1, 3):
                        for lane_map in ((0, 1) if mode == 0 and nt == 256 else (0,)):
                            k = f"{key} NT{nt} R{r} map{lane_map} {MODES[mode]}"
                            out[k] = us(cl, nt, r, mode, lane_map, S)
            for k, v in out.items():
                if k.startswith(key + " "):
                    print(f"{k}: {v:.4f} us", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wavenet_product_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": card, "K": 256, "iters": ITERS, "us": measure()}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
