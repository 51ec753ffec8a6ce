"""Where a step of the SampleRNN cluster decode kernel spends its time.

Usage, on a machine with one card, from the root of a checkout:
``python3 tools/profile_samplernn_cluster.py``.  A copy of
``csrc/samplernn_cluster.cu`` under ``build/profile_samplernn/`` defines
the kernel's ``SC_MARK`` hook to stamp block 0's ``%globaltimer`` (ns) at
each phase of a step: the step's start, the end of each product (a
streamed one: its last reduction), each push of a slice to the peers, each
cluster barrier, each framed dense or LSTM cell, the pick, the arrival of
each streamed piece (the wait, and the issue of the next piece) and the end
of its share of the product.  For SampleRNN-3 (``chip_smoke.py``'s
``FULL``, random weights) at B = 4 and 256, clusters of 8 and 16 blocks,
f32 and bf16 weights, it decodes 80 steps and prints, over steps 16 .. 79
(four periods of the slowest tier), the microseconds a step by the phase
that ends each interval, the count of each mark a step, the mean step by
the tiers that fire in it, and the step's wall time from CUDA events over
1,024 steps (the marks on); before them, the copy's SASS size and its
shared, global and local loads and stores; then the card's name and power
limit.  The copy is built with nvcc as the package builds its own
(``ops/nvcc.py``); nothing under ``mimikit_tpu_torch/`` changes.
"""
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import mimikit_tpu_torch as mmk  # noqa: E402
from mimikit_tpu_torch.ops import samplernn_decode as sd  # noqa: E402
from mimikit_tpu_torch.ops.nvcc import CSRC, NVCC_FLAGS  # noqa: E402

WORK = ROOT / "build" / "profile_samplernn"
PHASES = ("step start", "product", "push", "barrier", "dense or cell", "pick", "piece wait",
          "piece product")
N_MARKS = 16384
STEPS, FIRST = 80, 16

PROFILE_DEFS = r"""
__device__ long long g_sc_ns[%d];
__device__ int g_sc_kind[%d];
__device__ int g_sc_n;
#define SC_MARK(p) do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_sc_n < %d) { \
  long long t_; asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \
  g_sc_ns[g_sc_n] = t_; g_sc_kind[g_sc_n] = (p); ++g_sc_n; } } while (0)
""" % (N_MARKS, N_MARKS, N_MARKS)

READ_FNS = r"""
extern "C" int sc_prof_read(long long* ns, int* kind, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_sc_n, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbol(ns, g_sc_ns, sizeof(long long) * %d);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(kind, g_sc_kind, sizeof(int) * %d);
}
extern "C" int sc_prof_reset(void) {
  const int zero = 0;
  return (int)cudaMemcpyToSymbol(g_sc_n, &zero, sizeof(int));
}
""" % (N_MARKS, N_MARKS)


def build() -> Path:
    """Build the profiled copy of the source."""
    WORK.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "noise.cuh", WORK / "noise.cuh")
    src = WORK / "samplernn_cluster.cu"
    src.write_text(PROFILE_DEFS + (CSRC / "samplernn_cluster.cu").read_text() + READ_FNS)
    lib = WORK / "libsc_profile.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return lib


def profile(lib_path: Path, cases) -> None:
    """Print the SASS's size and the phases of a step of the library at
    ``lib_path`` (a build of :func:`build`) for each (B, cluster size,
    dtype) of ``cases``."""
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib_path)], capture_output=True, text=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?P\d\s+)?([A-Z][A-Z0-9_]*)", sass)
    count = {k: sum(1 for o in ops if o == k) for k in ("LDS", "LD", "STS", "ST", "LDL", "STL")}
    print(f"SASS of the profiled copy: {len(ops)} instructions; {count}", flush=True)
    sd.build_cluster_kernel = lambda: lib_path
    sd._ClusterKernel.lib = None
    lib = sd._cluster_library()
    net = cs.make_net(mmk, torch, cs.FULL, seed=0)
    rf = net.rf
    ns = (ctypes.c_longlong * N_MARKS)()
    kind = (ctypes.c_int * N_MARKS)()
    n = ctypes.c_int(0)
    fs = net.frame_sizes
    for B, cl, dtype in cases:
        pack = sd.samplernn_weight_pack(net, dtype)
        prompt = cs.make_prompt(torch, B, 2 * rf, cs.FULL["q_levels"], seed=B)
        lib.sc_prof_reset()
        sd.decode_chunk(pack, prompt, sd.init_decode_state(net, prompt), rf, STEPS, 5, 0.9, cl=cl)
        torch.cuda.synchronize()
        if lib.sc_prof_read(ns, kind, ctypes.byref(n)):
            raise RuntimeError("reading the marks failed")
        marks = [(ns[i], kind[i]) for i in range(n.value)]
        starts = [i for i, (_, k) in enumerate(marks) if k == 0]
        per = {p: 0.0 for p in PHASES}
        counts = {p: 0 for p in PHASES}
        by_kind = {}
        steps = 0
        for j, (a, b) in enumerate(zip(starts[FIRST:], starts[FIRST + 1:])):
            steps += 1
            t = rf + FIRST + j
            fired = sum(1 for f in fs[:-1] if t % f == 0)
            by_kind.setdefault(fired, []).append((marks[b][0] - marks[a][0]) / 1e3)
            for (t0, _), (t1, k) in zip(marks[a:b], marks[a + 1 : b + 1]):
                per[PHASES[k]] += (t1 - t0) / 1e3
                counts[PHASES[k]] += 1
        total = sum(per.values()) / steps

        def run():
            sd.decode_chunk(pack, prompt, sd.init_decode_state(net, prompt), rf, 1024, 5, 0.9,
                            cl=cl)

        run()
        wall = statistics.median(cs.cuda_ms(torch, run, 3)) * 1e3 / 1024
        S = sd.decode_chunk.last_streams
        plan = sd.cluster_plan(pack, cl, S)
        print(f"B={B} CL={cl} {str(dtype).split('.')[-1]} (S={S}, {plan.n_slots} ring slots):"
              f" {total:.2f} us a step by block 0's marks over steps {FIRST}..{STEPS - 1}"
              f" (wall {wall:.2f} us a step over 1,024 steps, the marks on); by tiers firing: "
              + ", ".join(f"{k}: {statistics.mean(v):.2f} us ({len(v)} steps)"
                          for k, v in sorted(by_kind.items())), flush=True)
        for p in PHASES[1:]:
            print(f"  {p:>13}: {per[p] / steps:8.2f} us a step, {counts[p] / steps:5.1f} marks a"
                  f" step, {per[p] / max(1, counts[p]):.3f} us each")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_samplernn_cluster: no CUDA device", file=sys.stderr)
        return 2
    cases = [(4, 8, torch.float32), (4, 16, torch.float32), (256, 8, torch.float32),
             (256, 16, torch.float32), (256, 8, torch.bfloat16)]
    profile(build(), cases)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
