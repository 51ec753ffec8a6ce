"""Where a step of the transformer decode kernels (K6, K7) spends its time.

Usage, on a machine with one card, from the root of a checkout:
``python3 tools/profile_transformer_decode.py``.  It prints

1. the cost of one grid barrier (``cooperative_groups::this_grid().sync()``,
   the kernels' stage separator) in an empty cooperative kernel of 32, 66
   and 132 blocks, timed with CUDA events over 10,000 barriers;
2. per stage kind, the share of a step and its microseconds, for K6
   (``decode_window``) at B = 1, 2 and 16 and K7 (``decode_chunk``) at
   B = 1, 16 and 32, on transformer8l with random weights: a copy of the two
   sources under ``build/profile_transformer/`` stamps ``clock64()`` in
   block 0 after every grid barrier and at each phase of block 0's task
   (``TF_MARK``: the fold, the weight wait, the products, the attention, the
   next stage's weight issue), and sums the cycles by stage kind and phase;
   the shares scale the step's wall time.

The stage kinds (``csrc/transformer_common.cuh``).  K6: (1) norm 3 folded
on load + the q|k|v products (with every layer's cross k|v at layer 0), (2)
self-attention + its out product, (3) norm 1 + cross q + cross-attention +
its out product, (4) norm 2 + FFN 1 + FFN 2, the head.  K7: (A) norm 3 +
q|k|v + self-attention + out product, (B) norm 1 + cross q|k|v +
cross-attention + out product, (C) norm 2 + FFN, the head.  Each kind's
time includes block 0's wait at the barrier that ends it, so the shares
also say which stage the slowest block spends longest in.
The copies are built with nvcc as the package builds its own (``ops/nvcc.py``);
nothing under ``mimikit_tpu_torch/`` changes.
"""
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import mimikit_tpu_torch as mmk  # noqa: E402
from mimikit_tpu_torch.ops import transformer_decode as td  # noqa: E402
from mimikit_tpu_torch.ops import transformer_kv as tk  # noqa: E402
from mimikit_tpu_torch.ops.nvcc import NVCC_FLAGS  # noqa: E402

WORK = ROOT / "build" / "profile_transformer"
KINDS = {
    "transformer_decode.cu": ("1 norm 3 + qkv (+ cross kv)", "2 self-attention + out",
                              "3 norm 1 + cross q, attention, out", "4 norm 2 + FFN", "head",
                              "first x0"),
    "transformer_kv.cu": ("A norm 3 + qkv + attention + out",
                          "B norm 1 + cross qkv, attention, out", "C norm 2 + FFN", "head",
                          "first x0"),
}
# the phases of a task block 0 runs (TF_MARK in csrc/transformer_common.cuh)
PHASES = ("fold", "weight wait", "product 1", "attention", "product 2", "issue")
# the label of each grid barrier in order of appearance in the source: the
# first x0's, the stage loop's (by the stage's kind), the head's
LABELS = {"transformer_decode.cu": ("5", "st % 4", "4"), "transformer_kv.cu": ("4", "st % 3", "3")}

BARRIER_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256, 1) barriers(int n) {
  cooperative_groups::grid_group g = cooperative_groups::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}
extern "C" int run(int n, int blocks, void* stream) {
  void* args[] = {&n};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)barriers, dim3(blocks), dim3(256),
                                              args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
"""

PROFILE_DEFS = r"""
__device__ long long g_prof[64];
__device__ long long g_last;
__device__ int g_kind;
#define PROF_AT(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
  long long _t = clock64(); g_prof[i] += _t - g_last; g_last = _t; } } while (0)
#define PROF(k) PROF_AT(k)
#define TF_MARK(p) PROF_AT(8 + 8 * g_kind + (p))
#define TF_STAGE(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) g_kind = (k); } while (0)
extern "C" int mmk_prof_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 64);
}
extern "C" int mmk_prof_reset() {
  long long z[64] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""


def nvcc(src: Path, out: Path) -> ctypes.CDLL:
    subprocess.run([shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def event_ms(fn) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def barrier_cost():
    (WORK / "barriers.cu").write_text(BARRIER_SRC)
    lib = nvcc(WORK / "barriers.cu", WORK / "libbarriers.so")
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    for blocks in (32, 66, 132):
        n = 10000
        for _ in range(2):  # the first launch warms up
            ms = event_ms(lambda: lib.run(n, blocks, stream))
        print(f"grid barrier, {blocks} blocks: {1e3 * ms / n:.3f} us", flush=True)


def instrumented(mod, name: str):
    """Build ``name`` with a clock stamp after each grid barrier, labelled by
    the stage kind it ends, and point ``mod`` at it."""
    src = (WORK / name).read_text()
    src = src.replace('#include "transformer_common.cuh"',
                      PROFILE_DEFS + '#include "transformer_common.cuh"')
    src = src.replace("cg::grid_group grid = cg::this_grid();",
                      "cg::grid_group grid = cg::this_grid();\n"
                      "  if (blockIdx.x == 0 && threadIdx.x == 0) g_last = clock64();")
    labels = iter(LABELS[name])
    src, n = re.subn(r"grid\.sync\(\);", lambda m: f"grid.sync(); PROF({next(labels)});", src)
    if n != len(LABELS[name]):
        raise RuntimeError(f"{name}: {n} grid barriers, the labels expect {len(LABELS[name])}")
    (WORK / name).write_text(src)
    mod.SOURCE = WORK / name
    mod._Kernel.lib = None
    mod.build_kernel()


def report(mod, label: str, fn, steps: int) -> None:
    kinds = KINDS[mod.SOURCE.name]
    fn()
    torch.cuda.synchronize()
    lib = mod._Kernel.lib
    lib.mmk_prof_reset()
    wall_us = 1e3 * event_ms(fn) / steps
    buf = (ctypes.c_longlong * 64)()
    lib.mmk_prof_read(buf)
    total = sum(buf)
    print(f"{label}: {wall_us:.1f} us a step", flush=True)
    for k, kind in enumerate(kinds):
        phases = [buf[8 + 8 * k + p] for p in range(len(PHASES))]
        us = [wall_us * v / total for v in phases]
        print(f"  {kind:38s} {100 * (buf[k] + sum(phases)) / total:5.1f} %"
              f"  {wall_us * (buf[k] + sum(phases)) / total:8.2f} us: barrier wait"
              f" {wall_us * buf[k] / total:.2f}, " + ", ".join(
                  f"{name} {u:.2f}" for name, u in zip(PHASES, us) if u > 0))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(ROOT / "mimikit_tpu_torch" / "csrc", WORK)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    barrier_cost()
    instrumented(td, "transformer_decode.cu")
    instrumented(tk, "transformer_kv.cu")
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=256, mlp_dim=128,
                                                      input_module_type="embedding"))
    cfg = mmk.SimpleTransformer.Config(io_spec=io, model_dim=256, n_heads=8, feedforward_dim=1024,
                                       num_layers=8, rf=64, input_dropout=0.0)
    pack = td.transformer_weight_pack(mmk.SimpleTransformer.from_config(cfg, seed=0))
    g = torch.Generator().manual_seed(1)

    def prompt(B):
        return torch.randint(0, 256, (B, 64), generator=g, dtype=torch.int32).cuda()

    for B, n in ((1, 256), (2, 128), (16, 32)):
        p = prompt(B)
        report(td, f"K6 B={B}", lambda: td.decode_window(pack, p, n, 1, 0.9), n)
    for B in (1, 16, 32):
        p = prompt(B)
        p_T = p.t().contiguous()
        report(tk, f"K7 B={B}", lambda: tk.decode_chunk(pack, p_T, tk.init_kv_state(pack, p), 1,
                                                        400, 0.9, 1), 400)


if __name__ == "__main__":
    t = time.perf_counter()
    main()
    print(f"{time.perf_counter() - t:.1f} s", flush=True)
