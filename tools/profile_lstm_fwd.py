"""Where a step of the fused LSTM forward (K3a) goes, by taking parts out.

Usage, on a machine with one card: ``python3 tools/profile_lstm_fwd.py
[source.cu]`` (~2 min; the source defaults to the package's
``mimikit_tpu_torch/csrc/fused_lstm.cu``).  It builds copies of the source
into ``build/profile_lstm_fwd/``, each with one part of the forward's step
taken out by a text edit (the results of those copies are wrong; only their
times count), the copies' nvcc runs started together, and times the forward
kernel (CUDA events, median of 5 calls after a warm-up) at the training
path's tier shapes (T, B, H) = (128, 32, 256) and (256, 32, 256), f32 and
bf16 streams, on clusters of 8 and 16 blocks.  The copies:

* ``as built``: the source as it is;
* ``no product``: the recurrent product skipped (z = 0);
* ``no activations``: the gates and h without sigmoid and tanh;
* ``no push``: each block's new h stored into its own shared memory, not
  its peers';
* ``no push or cluster barrier``: that, and the step's split cluster barrier
  a block barrier (without the push no block writes into another's shared
  memory);
* ``no stores``: h, c and the gates not stored to device memory;
* ``no loads``: xi of the step two on not loaded;
* ``no stores or loads``: both;
* ``none of them``: every part above taken out (what is left: the loop, the
  product's shuffles, the block barrier, the launch's fixed cost over T);
  then ``the ... only`` copies put one part back into it.

Each line gives the forward's µs a step and the difference to ``as built``:
what the part costs on the step's chain (taken out), or, from ``none of
them`` on, what one part costs alone.  It prints one JSON line at the end.
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

WORK = ROOT / "build" / "profile_lstm_fwd"
SHAPES = ((128, 32, 256), (256, 32, 256))
STORES = ("""    mmk_st(x.h_all + row * x.H + x.hu, h);
    mmk_st(x.c_all + row * x.H + x.hu, c);
    S* gr = x.gates + row * x.H4 + x.hu;
    mmk_st(gr, ig);
    mmk_st(gr + x.H, fg);
    mmk_st(gr + 2 * x.H, gg);
    mmk_st(gr + 3 * x.H, og);
""", "")
LOADS = ("  fwd_load(x, t + 2, T, in);\n", "")
NO_PUSH = ("S* dst = cluster.map_shared_rank(hnext + rr * x.HS + x.q * x.U + x.u0, pq);",
           "S* dst = hnext + rr * x.HS + x.q * x.U + x.u0 + 0 * pq;")
EDITS = {
    "as built": [],
    "no product": [("for (int c = cs; c < nch; c += KSW) {", "for (int c = cs; c < 0; c += KSW) {"),
                   ("    if (active) {\n      const uint32_t* hw", "    if (false) {\n      const uint32_t* hw")],
    "no activations": [("ig = mmk_sigmoid(in.x[0] + z[0]);", "ig = in.x[0] + z[0];"),
                       ("fg = mmk_sigmoid(in.x[1] + z[1]);", "fg = in.x[1] + z[1];"),
                       ("gg = tanhf(in.x[2] + z[2]);", "gg = in.x[2] + z[2];"),
                       ("og = mmk_sigmoid(in.x[3] + z[3]);", "og = in.x[3] + z[3];"),
                       ("h = mmk_round<S>(og * tanhf(c));", "h = mmk_round<S>(og * c);")],
    "no push": [NO_PUSH],
    "no push or cluster barrier": [
        NO_PUSH,
        ('  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");\n  if (x.valid) {\n    const size_t row',
         '  if (x.valid) {\n    const size_t row'),
        ('  fwd_load(x, t + 2, T, in);\n  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");',
         '  fwd_load(x, t + 2, T, in);\n  __syncthreads();')],
    "no stores": [STORES],
    "no loads": [LOADS],
    "no stores or loads": [STORES, LOADS],
}
# the step with every part above taken out, then with one part put back
NONE = EDITS["no product"] + EDITS["no activations"] + EDITS["no push or cluster barrier"] + [
    STORES, LOADS]
EDITS.update({
    "none of them": NONE,
    "the cluster barrier only": (EDITS["no product"] + EDITS["no activations"]
                                 + EDITS["no push"] + [STORES, LOADS]),
    "the push and barrier only": EDITS["no product"] + EDITS["no activations"] + [STORES, LOADS],
    "the product only": EDITS["no activations"] + EDITS["no push or cluster barrier"] + [
        STORES, LOADS],
    "the activations only": EDITS["no product"] + EDITS["no push or cluster barrier"] + [
        STORES, LOADS],
    "the stores and loads only": (EDITS["no product"] + EDITS["no activations"]
                                  + EDITS["no push or cluster barrier"]),
})


def build(name, edits, source):
    src = source.read_text()
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
    return so


def load(so):
    lib = ctypes.CDLL(str(so))
    lib.mmk_lstm_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.mmk_lstm_forward.restype = ctypes.c_int
    return lib


def forward(lib, T, B, H, dtype, cl):
    g = torch.Generator().manual_seed(T)
    xi, Wh, h0, c0 = ((torch.randn(*s, generator=g) * sc).cuda().to(dtype) for s, sc in (
        ((T, B, 4 * H), 0.5), ((H, 4 * H), H ** -0.5), ((B, H), 0.3), ((B, H), 0.3)))
    _, rows = fl.lstm_fwd_plan(B, H, xi.element_size(), cl)
    outs = [torch.empty(T, B, H, device="cuda", dtype=dtype) for _ in range(2)]
    outs.append(torch.empty(T, B, 4 * H, device="cuda", dtype=dtype))

    def run():
        err = lib.mmk_lstm_forward(*(a.data_ptr() for a in (xi, Wh, h0, c0, *outs)), T, B, H,
                                   rows, cl, int(dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
    return run


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
    source = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else fl.SOURCE
    with ThreadPoolExecutor(len(EDITS)) as pool:
        sos = dict(zip(EDITS, pool.map(lambda kv: build(*kv, source), EDITS.items())))
    libs = {name: load(so) for name, so in sos.items()}
    result = {"device": torch.cuda.get_device_name(0), "source": str(source), "us_a_step": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for T, B, H in SHAPES:
            for cl in fl.FWD_CLUSTER_SIZES:
                base = None
                for name, lib in libs.items():
                    us = 1e3 * event_ms(forward(lib, T, B, H, dtype, cl)) / T
                    base = us if base is None or name == "none of them" else base
                    key = f"{str(dtype).split('.')[-1]} T={T} cl={cl} {name}"
                    result["us_a_step"][key] = us
                    print(f"{key}: {us:.3f} us a step ({us - base:+.3f})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
