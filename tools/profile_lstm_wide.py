"""Where a step of the wide LSTM kernels (K3a-wide, K3b-wide) goes, by taking parts out.

Usage, on a machine with one card: ``python3 tools/profile_lstm_wide.py``
(~2 min).  It builds copies of ``mimikit_tpu_torch/csrc/fused_lstm.cu``
into ``build/profile_lstm_wide/``, their nvcc runs started together, each
with one part of the wide kernels' step taken out by ``MMK_WIDE_OFF`` (a bit
mask of parts, 0 in the package's build; the results of those copies are
wrong, only their times count), and times ``lstm_forward_wide`` and
``lstm_backward_wide`` through the package's wrappers bound to each copy
(CUDA events, median of 5 calls after a warm-up) at (T, B, H) = (256, 32,
512) on f32 streams and (256, 32, 768) on bf16 streams: the wide train
step's tier shapes.  The copies:

* ``as built``: the package's build;
* ``clusters of 1``: built with ``MMK_WIDE_CL=1``, the design without
  clusters: each block bulk-loads h for itself, and every block's partial
  dh goes through the device exchange (128 partials a unit, not 64).  Its
  results are right: its largest error against the plain versions is
  printed beside the package build's;
* ``no product``: the step's product skipped;
* ``no L2 traffic``: the forward's h not read back from device memory, the
  backward's cluster sums not stored and read;
* ``no cluster exchange``: the backward's partial dh not pushed to the
  cluster's blocks, nor the cluster barrier taken;
* ``no reduction``: the partial sums of a (row, column) not added (one read);
* ``no cell``: the cell, its stores and its inputs' loads skipped;
* ``no grid barrier``: the step's grid barrier a block barrier;
* ``no dWh``: the backward's dWh product not launched (the walk alone);
* ``none of them``: all of the above.

Every copy is timed twice, in two rounds over the copies, the second in
the reverse order.  Each line gives a kernel's µs a step (the call's time
over T) in both rounds and the difference of their mean to ``as built``'s:
what the part costs on the step's chain.  The backward's ``as built`` less
``no dWh`` is the dWh product's share.  The card's name and power limit come
first; the last line is one JSON object.
"""
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mimikit_tpu_torch.ops import fused_lstm as fl  # noqa: E402
from mimikit_tpu_torch.ops.nvcc import NVCC_FLAGS  # noqa: E402

WORK = ROOT / "build" / "profile_lstm_wide"
SHAPES = ((torch.float32, 256, 32, 512), (torch.bfloat16, 256, 32, 768))
# the parts, by bit of MMK_WIDE_OFF
MASKS = {"no product": 1, "no L2 traffic": 2, "no cluster exchange": 4, "no reduction": 8,
         "no cell": 16, "no grid barrier": 32, "no dWh": 64}
# {copy: (-D flags, blocks a cluster)}
COPIES = {"as built": ([], fl.WIDE_CL), "clusters of 1": (["-DMMK_WIDE_CL=1"], 1)}
COPIES.update({k: ([f"-DMMK_WIDE_OFF={m}"], fl.WIDE_CL) for k, m in MASKS.items()})
COPIES["none of them"] = ([f"-DMMK_WIDE_OFF={sum(MASKS.values())}"], fl.WIDE_CL)
# the copies whose results are right
RIGHT = ("as built", "clusters of 1")


def build(name, flags):
    WORK.mkdir(parents=True, exist_ok=True)
    so = WORK / ("lib" + re.sub(r"\W", "_", name) + ".so")
    res = subprocess.run(["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, *flags, "-o", str(so),
                          str(fl.SOURCE)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{res.stderr[-3000:]}")
    return fl._bind(ctypes.CDLL(str(so)))


def use(lib, cl):
    """The package's wrappers on ``lib``, a build with clusters of ``cl``."""
    fl._Kernel.lib, fl.WIDE_CL = lib, cl
    fl._Kernel.wide_clusters = {}


def inputs(dtype, T, B, H):
    """(forward's arguments, backward's arguments, the plain versions' outputs)."""
    g = torch.Generator().manual_seed(T + H)
    xi, Wh, h0, c0 = ((torch.randn(*s, generator=g) * sc).to(dtype) for s, sc in (
        ((T, B, 4 * H), 0.5), ((H, 4 * H), H ** -0.5), ((B, H), 0.3), ((B, H), 0.3)))
    h_all, c_all, gates = fl.lstm_forward_plain(xi, Wh, h0, c0)
    dh_all, dh_T, dc_T = ((torch.randn(*s, generator=g) * 0.1).to(dtype)
                          for s in ((T, B, H), (B, H), (B, H)))
    bw = (dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh)
    plain = (h_all, c_all, gates) + fl.lstm_backward_plain(*bw)
    return [x.cuda() for x in (xi, Wh, h0, c0)], [x.cuda() for x in bw], plain


def event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> int:
    with ThreadPoolExecutor(len(COPIES)) as pool:
        libs = dict(zip(COPIES, pool.map(lambda kv: build(kv[0], kv[1][0]), COPIES.items())))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "us_a_step": {}, "max_abs_err": {}}
    cases = [(dt, T, B, H, *inputs(dt, T, B, H)) for dt, T, B, H in SHAPES]
    names = list(COPIES)
    for order in (names, names[::-1]):
        for name in order:
            use(libs[name], COPIES[name][1])
            for dt, T, B, H, fw, bw, plain in cases:
                case = f"{str(dt).split('.')[-1]} (T, B, H) = ({T}, {B}, {H})"
                if name in RIGHT and f"{case} {name}" not in result["max_abs_err"]:
                    got = fl.lstm_forward_wide(*fw) + fl.lstm_backward_wide(*bw)
                    result["max_abs_err"][f"{case} {name}"] = max(
                        (g.float().cpu() - p.float()).abs().max().item()
                        for g, p in zip(got, plain))
                for kernel, fn in (("K3a-wide", lambda: fl.lstm_forward_wide(*fw)),
                                   ("K3b-wide", lambda: fl.lstm_backward_wide(*bw))):
                    key = f"{kernel} {case} {name}"
                    result["us_a_step"].setdefault(key, []).append(1e3 * event_ms(fn) / T)
    for key, err in result["max_abs_err"].items():
        print(f"{key}: max |error| against the plain versions {err:.3e}", flush=True)
    for key, us in result["us_a_step"].items():
        base = result["us_a_step"][key[: key.rindex(")") + 1] + " as built"]
        print(f"{key}: {us[0]:.3f}, {us[1]:.3f} us a step"
              f" ({statistics.mean(us) - statistics.mean(base):+.3f})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
