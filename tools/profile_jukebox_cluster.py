"""Where a step of the cluster tier-pyramid kernel spends its time.

Usage, on a machine with one card, from the root of a checkout:
``python3 tools/profile_jukebox_cluster.py``.  A copy of
``csrc/jukebox_cluster.cu`` under
``build/profile_jukebox/`` defines the kernel's ``JC_MARK`` hook to stamp
block 0's ``%globaltimer`` (ns) at each phase of a step: the step's start,
the end of each product (a streamed one includes its waits for the ring),
the end of each push of a slice to the peers, the end of each cluster
barrier, each norm, each attention, the pick, and the arrival of each
streamed piece.  For jukebox3 (``chip_smoke.py``'s ``JB_FULL``, random
weights) at B=1, clusters of 8 and 16 blocks, it decodes 24 steps and
prints, over steps 4 .. 23, the microseconds a step by the phase that ends
each interval, the count of each mark a step, and the step's wall time from
CUDA events over 1,024 steps (the marks on); before them, the copy's SASS
size and its shared, global and local loads and stores; then the card's
name and power limit.  The copy is built with nvcc as the package builds
its own (``ops/nvcc.py``); nothing under ``mimikit_tpu_torch/`` changes.
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
from mimikit_tpu_torch.ops import jukebox_decode as jbd  # noqa: E402
from mimikit_tpu_torch.ops.nvcc import CSRC, NVCC_FLAGS  # noqa: E402

WORK = ROOT / "build" / "profile_jukebox"
PHASES = ("step start", "product", "push", "barrier", "norm", "attention", "pick", "piece wait")
N_MARKS = 8192
STEPS, FIRST = 24, 4

PROFILE_DEFS = r"""
__device__ long long g_jc_ns[%d];
__device__ int g_jc_kind[%d];
__device__ int g_jc_n;
#define JC_MARK(p) do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_jc_n < %d) { \
  long long t_; asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \
  g_jc_ns[g_jc_n] = t_; g_jc_kind[g_jc_n] = (p); ++g_jc_n; } } while (0)
""" % (N_MARKS, N_MARKS, N_MARKS)

READ_FNS = r"""
extern "C" int jc_prof_read(long long* ns, int* kind, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_jc_n, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbol(ns, g_jc_ns, sizeof(long long) * %d);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(kind, g_jc_kind, sizeof(int) * %d);
}
extern "C" int jc_prof_reset(void) {
  const int zero = 0;
  return (int)cudaMemcpyToSymbol(g_jc_n, &zero, sizeof(int));
}
""" % (N_MARKS, N_MARKS)


def build() -> Path:
    """Build the profiled copy of the source."""
    WORK.mkdir(parents=True, exist_ok=True)
    for name in ("transformer_common.cuh", "noise.cuh"):
        shutil.copy(CSRC / name, WORK / name)
    src = WORK / "jukebox_cluster.cu"
    src.write_text(PROFILE_DEFS + (CSRC / "jukebox_cluster.cu").read_text() + READ_FNS)
    lib = WORK / "libjc_profile.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return lib


def profile(lib_path: Path, sizes=jbd.CLUSTER_SIZES) -> None:
    """Print the SASS's size and the phases of a step of the library at
    ``lib_path`` (a build of :func:`build`) for each cluster size."""
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib_path)], capture_output=True, text=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?P\d\s+)?([A-Z][A-Z0-9_]*)", sass)
    count = {k: sum(1 for o in ops if o == k) for k in ("LDS", "LD", "STS", "ST", "LDL", "STL")}
    print(f"SASS of the profiled copy: {len(ops)} instructions; {count}", flush=True)
    jbd.build_cluster_kernel = lambda: lib_path
    jbd._ClusterKernel.lib = None
    lib = jbd._cluster_library()
    net = cs.make_jukebox(mmk, torch, jbd, cs.JB_FULL, seed=0)
    pack = jbd.jukebox_weight_pack(net)
    W = pack.window
    prompt = cs.make_prompt(torch, 1, W, cs.JB_FULL["q_levels"], seed=61)
    ns = (ctypes.c_longlong * N_MARKS)()
    kind = (ctypes.c_int * N_MARKS)()
    n = ctypes.c_int(0)
    for cl in sizes:
        plan = jbd.cluster_plan(pack, cl)
        lib.jc_prof_reset()
        jbd._launch_cluster(pack, jbd.lead_window(prompt, W), W, STEPS, 5, 0.9, cl=cl)
        torch.cuda.synchronize()
        if lib.jc_prof_read(ns, kind, ctypes.byref(n)):
            raise RuntimeError("reading the marks failed")
        marks = [(ns[i], kind[i]) for i in range(n.value)]
        starts = [i for i, (_, k) in enumerate(marks) if k == 0]
        per = {p: 0.0 for p in PHASES}
        counts = {p: 0 for p in PHASES}
        steps = 0
        for a, b in zip(starts[FIRST:], starts[FIRST + 1:]):
            steps += 1
            for (t0, _), (t1, k) in zip(marks[a:b], marks[a + 1 : b + 1]):
                per[PHASES[k]] += (t1 - t0) / 1e3
                counts[PHASES[k]] += 1
        total = sum(per.values()) / steps

        def run():
            jbd._launch_cluster(pack, jbd.lead_window(prompt, W), W, 1024, 5, 0.9, cl=cl)

        run()
        wall = statistics.median(cs.cuda_ms(torch, run, 3)) * 1e3 / 1024
        print(f"CL={cl}: {total:.2f} us a step by block 0's marks over steps {FIRST}..{STEPS - 1}"
              f" (wall {wall:.2f} us a step over 1,024 steps, the marks on); resident"
              f" {plan.bytes(0, True) / 1024:.1f} KB, streamed {plan.bytes(0, False) / 1024:.1f} KB"
              f" in {len(plan.pieces(0))} pieces a step (rank 0)", flush=True)
        for p in PHASES[1:]:
            print(f"  {p:>10}: {per[p] / steps:8.2f} us a step, {counts[p] / steps:5.1f} marks a step,"
                  f" {per[p] / max(1, counts[p]):.3f} us each")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_jukebox_cluster: no CUDA device", file=sys.stderr)
        return 2
    profile(build())
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
