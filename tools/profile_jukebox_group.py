"""Where a step of the group tier-pyramid kernel spends its time, by group size.

Usage, on a machine with one card, from the root of a checkout:
``python3 tools/profile_jukebox_group.py [CL]`` (default 8).  A copy of
``csrc/jukebox_group.cu`` under ``build/profile_jukebox_group/`` defines the
kernel's ``JG_MARK`` hook to stamp block 0's ``%globaltimer`` (ns) at each
phase of a step: the step's start, the end of each product (a streamed one
includes its waits for the ring), the end of each push of a slice to the
peers, the end of each cluster barrier, each norm, each attention, each
pick, and the arrival of each streamed piece.  For jukebox3
(``chip_smoke.py``'s ``JB_FULL``, random weights) on clusters of CL blocks,
at groups of S = 1, 2 and 4 streams with every cluster that fits busy (B =
clusters x S), it decodes 24 steps and prints, over steps 4 .. 23, the
microseconds a step by the phase that ends each interval, the count of each
mark a step, and the step's wall time from CUDA events over 512 steps (the
marks on), with the plan's resident and streamed bytes; before them, the
copy's SASS size and its loads and stores; then the card's name and power
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
from mimikit_tpu_torch.ops import jukebox_decode as jbd  # noqa: E402
from mimikit_tpu_torch.ops.nvcc import CSRC, NVCC_FLAGS  # noqa: E402

WORK = ROOT / "build" / "profile_jukebox_group"
PHASES = ("step start", "product", "push", "barrier", "norm", "attention", "pick", "piece wait")
N_MARKS = 16384
STEPS, FIRST = 24, 4
GROUPS = (1, 2, 4)

PROFILE_DEFS = r"""
__device__ long long g_jg_ns[%d];
__device__ int g_jg_kind[%d];
__device__ int g_jg_n;
#define JG_MARK(p) do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_jg_n < %d) { \
  long long t_; asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \
  g_jg_ns[g_jg_n] = t_; g_jg_kind[g_jg_n] = (p); ++g_jg_n; } } while (0)
""" % (N_MARKS, N_MARKS, N_MARKS)

READ_FNS = r"""
extern "C" int jg_prof_read(long long* ns, int* kind, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_jg_n, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbol(ns, g_jg_ns, sizeof(long long) * %d);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(kind, g_jg_kind, sizeof(int) * %d);
}
extern "C" int jg_prof_reset(void) {
  const int zero = 0;
  return (int)cudaMemcpyToSymbol(g_jg_n, &zero, sizeof(int));
}
""" % (N_MARKS, N_MARKS)


def build() -> Path:
    """Build the profiled copy of the source."""
    WORK.mkdir(parents=True, exist_ok=True)
    for name in ("transformer_common.cuh", "noise.cuh"):
        shutil.copy(CSRC / name, WORK / name)
    src = WORK / "jukebox_group.cu"
    src.write_text(PROFILE_DEFS + (CSRC / "jukebox_group.cu").read_text() + READ_FNS)
    lib = WORK / "libjg_profile.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return lib


def profile(lib_path: Path, cl: int) -> None:
    """Print the SASS's size and the phases of a step of the library at
    ``lib_path`` (a build of :func:`build`) for each group size."""
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib_path)], capture_output=True, text=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?P\d\s+)?([A-Z][A-Z0-9_]*)", sass)
    count = {k: sum(1 for o in ops if o == k) for k in ("LDS", "LD", "STS", "ST", "LDL", "STL")}
    print(f"SASS of the profiled copy: {len(ops)} instructions; {count}", flush=True)
    jbd.build_group_kernel = lambda: lib_path
    jbd._GroupKernel.lib = None
    lib = jbd._group_library()
    net = cs.make_jukebox(mmk, torch, jbd, cs.JB_FULL, seed=0)
    pack = jbd.jukebox_weight_pack(net)
    W = pack.window
    ns = (ctypes.c_longlong * N_MARKS)()
    kind = (ctypes.c_int * N_MARKS)()
    n = ctypes.c_int(0)
    clusters = jbd.clusters_that_fit(pack, cl)
    for S in GROUPS:
        plan = jbd.group_plan(pack, cl, S)
        if not plan.fits:
            print(f"CL={cl} S={S}: the plan does not fit ({plan.why})")
            continue
        B = clusters * S
        prompt = cs.make_prompt(torch, B, W, cs.JB_FULL["q_levels"], seed=61)
        lib.jg_prof_reset()
        jbd._launch_group(pack, jbd.lead_window(prompt, W), W, STEPS, 5, 0.9, cl, S)
        torch.cuda.synchronize()
        if lib.jg_prof_read(ns, kind, ctypes.byref(n)):
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
            jbd._launch_group(pack, jbd.lead_window(prompt, W), W, 512, 5, 0.9, cl, S)

        run()
        wall = statistics.median(cs.cuda_ms(torch, run, 3)) * 1e3 / 512
        print(f"CL={cl} S={S} B={B} ({clusters} clusters): {total:.2f} us a step by block 0's"
              f" marks over steps {FIRST}..{STEPS - 1} (wall {wall:.2f} us a step over 512 steps,"
              f" the marks on); resident {plan.bytes(0, True) / 1024:.1f} KB, streamed"
              f" {plan.bytes(0, False) / 1024:.1f} KB in {len(plan.pieces(0))} pieces a step"
              f" (rank 0)", flush=True)
        for p in PHASES[1:]:
            print(f"  {p:>10}: {per[p] / steps:8.2f} us a step, {counts[p] / steps:5.1f} marks a"
                  f" step, {per[p] / max(1, counts[p]):.3f} us each")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_jukebox_group: no CUDA device", file=sys.stderr)
        return 2
    cl = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    profile(build(), cl)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
