"""Where a step of the fused LSTM backward walk (K3b) goes, by taking parts out.

Usage, on a machine with one card: ``python3 tools/profile_lstm_bwd.py``
(~2 min).  It builds copies of ``mimikit_tpu_torch/csrc/fused_lstm.cu`` into
``build/profile_lstm_bwd/``, each with one part of the walk's step taken out
by a text edit (the results of those copies are wrong; only their times
count), and times the walk kernel alone (``torch.profiler``, device time of
``lstm_bwd_kernel``, 3 calls) at the training path's wider tier shape
(T, B, H) = (256, 32, 256), f32 and bf16 streams, on clusters of 8 and 16
blocks.  The copies:

* ``as built``: the source as it is;
* ``no product``: the partial dh product skipped (the pieces are zeros);
* ``no push``: each piece stored into the block's own shared memory, not
  the owner's;
* ``no push or cluster barrier``: that, and the step's cluster barrier a
  block barrier (without the push no block writes into another's shared
  memory, so no block can outlive a peer that writes into it);
* ``no tanh``: tanh(c) taken as c;
* ``no loads``: the gates, c and dh_all of the step two on not loaded;
* ``no dxi stores``: dz not stored to device memory.

Each line gives the walk's µs a step and the difference to ``as built``:
what the part costs on the step's chain.  It prints one JSON line at the end.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mimikit_tpu_torch.ops import fused_lstm as fl  # noqa: E402
from mimikit_tpu_torch.ops.nvcc import NVCC_FLAGS  # noqa: E402
from tools.lstm_bwd_split import by_kernel, inputs  # noqa: E402

WORK = ROOT / "build" / "profile_lstm_bwd"
T, B, H = 256, 32, 256
EDITS = {
    "as built": [],
    "no product": [("for (int j = x.js; j < x.NC; j += x.JS) {",
                    "for (int j = x.js; j < 0; j += x.JS) {")],
    "no push": [("cluster.map_shared_rank(piece, k / U) + k % U", "piece + k % U"),
                ("cluster.map_shared_rank(piece, (k + i) / U)[(k + i) % U]", "piece[(k + i) % U]")],
    "no push or cluster barrier": [
        ("cluster.map_shared_rank(piece, k / U) + k % U", "piece + k % U"),
        ("cluster.map_shared_rank(piece, (k + i) / U)[(k + i) % U]", "piece[(k + i) % U]"),
        ('asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");', ""),
        ('asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");',
         "__syncthreads();")],
    "no tanh": [("const float tc = tanhf(in.c);", "const float tc = in.c;")],
    "no loads": [("  bwd_load(x, t - 2, in);\n", "")],
    "no dxi stores": [("    mmk_st(dr, dz[0]);\n    mmk_st(dr + H, dz[1]);\n"
                       "    mmk_st(dr + 2 * H, dz[2]);\n    mmk_st(dr + 3 * H, dz[3]);\n", "")],
}


def build(name, edits):
    src = fl.SOURCE.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to edit is not found once: {old!r}")
        src = src.replace(old, new)
    WORK.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W", "_", name)
    cu, so = WORK / f"{stem}.cu", WORK / f"lib{stem}.so"
    cu.write_text(src)
    subprocess.run(["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mmk_lstm_backward.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.mmk_lstm_backward.restype = ctypes.c_int
    return lib


def walk(lib, args, cl):
    dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh = args
    dt = gates.dtype
    _, rows = fl.lstm_bwd_plan(B, H, gates.element_size(), cl)
    outs = [torch.empty_like(gates), torch.empty_like(Wh), torch.empty_like(h0),
            torch.empty_like(c0)]
    splits = fl.dwh_splits(T * B, H)
    part = torch.empty(splits, H, 4 * H, device=gates.device)

    def run():
        err = lib.mmk_lstm_backward(
            *(a.data_ptr() for a in args), outs[0].data_ptr(), outs[1].data_ptr(),
            part.data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(), T, B, H, rows, cl, splits,
            int(dt == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
    return run


def main() -> int:
    libs = {name: build(name, edits) for name, edits in EDITS.items()}
    result = {"device": torch.cuda.get_device_name(0), "T": T, "B": B, "H": H, "us_a_step": {}}
    for dtype in (torch.float32, torch.bfloat16):
        args = inputs(fl, T, B, H, dtype)
        for cl in fl.BWD_CLUSTER_SIZES:
            base = None
            for name, lib in libs.items():
                us = 1e3 * by_kernel(walk(lib, args, cl))["walk"] / T
                base = us if base is None else base
                key = f"{str(dtype).split('.')[-1]} cl={cl} {name}"
                result["us_a_step"][key] = us
                print(f"{key}: {us:.3f} us a step ({us - base:+.3f})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
