"""Where a step of the WaveNet cluster decode kernel spends its time.

Usage, on a machine with one card, from the root of a checkout:
``python3 tools/profile_wavenet_cluster.py [source.cu]`` (default the
package's ``csrc/wavenet_cluster.cu``).  A copy of the source under
``build/profile_wavenet_cluster/`` defines the kernel's ``WC_MARK`` hook to
stamp block 0's ``%globaltimer`` (ns) at each phase of a step: the step's
start, the arrival of a layer's ring rows, the end of each product (a
streamed one includes its waits for the ring), the end of each push of a
slice to the peers, the end of each cluster barrier, each ring write, each
pick, and the arrival of each streamed piece.  For WaveNet-10
(``chip_smoke.py``'s ``WN_FULL``, random weights) at B = 1, 8, 64 and 256 on
clusters of 16 blocks (the groups ``streams_a_group`` picks), it
decodes 24 steps and prints, over steps 4 .. 23, the microseconds a step by
the phase that ends each interval and the count of each mark a step, and
the step's wall time from CUDA events over 512 steps (the marks on); then
the card's name and power limit.  The copy is built with nvcc as the
package builds its own (``ops/nvcc.py``); nothing under
``mimikit_tpu_torch/`` changes.
"""
import ctypes
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
from mimikit_tpu_torch.ops import wavenet_decode as wd  # noqa: E402
from mimikit_tpu_torch.ops.nvcc import CSRC, NVCC_FLAGS  # noqa: E402

WORK = ROOT / "build" / "profile_wavenet_cluster"
PHASES = ("step start", "product", "push", "barrier", "ring write", "pick", "piece wait",
          "ring rows")
N_MARKS = 16384
STEPS, FIRST = 24, 4
CASES = ((1, 16), (8, 16), (64, 16), (256, 16))

PROFILE_DEFS = r"""
__device__ long long g_wc_ns[%d];
__device__ int g_wc_kind[%d];
__device__ int g_wc_n;
#define WC_MARK(p) do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_wc_n < %d) { \
  long long t_; asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \
  g_wc_ns[g_wc_n] = t_; g_wc_kind[g_wc_n] = (p); ++g_wc_n; } } while (0)
""" % (N_MARKS, N_MARKS, N_MARKS)

READ_FNS = r"""
extern "C" int wc_prof_read(long long* ns, int* kind, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_wc_n, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbol(ns, g_wc_ns, sizeof(long long) * %d);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(kind, g_wc_kind, sizeof(int) * %d);
}
extern "C" int wc_prof_reset(void) {
  const int zero = 0;
  return (int)cudaMemcpyToSymbol(g_wc_n, &zero, sizeof(int));
}
""" % (N_MARKS, N_MARKS)


def build(source: Path) -> Path:
    """Build the profiled copy of ``source``."""
    WORK.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "noise.cuh", WORK / "noise.cuh")
    src = WORK / f"{source.stem}_marked.cu"
    src.write_text(PROFILE_DEFS + source.read_text() + READ_FNS)
    lib = WORK / f"lib{source.stem}_profile.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    return lib


def profile(lib_path: Path) -> None:
    """Print the phases of a step of the library at ``lib_path`` (a build
    of :func:`build`) for each case."""
    wd.build_cluster_kernel = lambda: lib_path
    wd._ClusterKernel.lib = None
    wd._cluster_library()
    prof = ctypes.CDLL(str(lib_path))
    net = cs.make_wavenet(mmk, torch, wd, cs.WN_FULL, seed=0)
    pack = wd.wavenet_weight_pack(net)
    ns = (ctypes.c_longlong * N_MARKS)()
    kind = (ctypes.c_int * N_MARKS)()
    n = ctypes.c_int(0)
    for B, cl in CASES:
        prompt = cs.make_prompt(torch, B, net.rf + 8, cs.WN_FULL["q_levels"], seed=B)
        prof.wc_prof_reset()
        wd.decode_chunk(pack, prompt, wd.init_decode_state(pack, prompt), 1, STEPS, 5, 0.9, cl=cl)
        torch.cuda.synchronize()
        if prof.wc_prof_read(ns, kind, ctypes.byref(n)):
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
        S = wd.decode_chunk.last_streams
        plan = wd.cluster_plan(pack, cl, S)

        def run():
            wd.decode_chunk(pack, prompt, wd.init_decode_state(pack, prompt), 1, 512, 5, 0.9,
                            cl=cl)

        run()
        wall = statistics.median(cs.cuda_ms(torch, run, 3)) * 1e3 / 512
        print(f"B={B} CL={cl} S={S} ({wd.decode_chunk.last_clusters} clusters): {total:.2f} us a"
              f" step by block 0's marks over steps {FIRST}..{STEPS - 1} (wall {wall:.2f} us a"
              f" step over 512 steps, the marks on); resident {plan.bytes(0, True) / 1024:.1f}"
              f" KB, streamed {plan.bytes(0, False) / 1024:.1f} KB in {len(plan.pieces(0))}"
              f" pieces a step (rank 0)", flush=True)
        for p in PHASES[1:]:
            print(f"  {p:>10}: {per[p] / steps:8.2f} us a step, {counts[p] / steps:5.1f} marks a"
                  f" step, {per[p] / max(1, counts[p]):.3f} us each")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_wavenet_cluster: no CUDA device", file=sys.stderr)
        return 2
    source = Path(sys.argv[1]) if len(sys.argv) > 1 else CSRC / "wavenet_cluster.cu"
    profile(build(source.resolve()))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
