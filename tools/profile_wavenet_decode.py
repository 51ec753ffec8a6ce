"""Where a step of the WaveNet block decode kernel spends its time.

Usage, on a machine with one card, from the root of a checkout:
``python3 tools/profile_wavenet_decode.py``.  Copies of
``csrc/wavenet_decode.cu`` under ``build/profile_wavenet_decode/`` get marks
that stamp block 0's ``%globaltimer`` (ns) at the end of each phase of a step
(the embedding and the ring reads; the ring write and the conv's input; the
conv product; the gate; the skip|res product; the skip and residual update;
each head product; the pick), inserted by text into the copy: the package's
source is not changed.  Three copies:

* ``as is``: the kernel with the marks;
* ``L1 weights``: every weight load of a product reads one of 16 rows of the
  weight matrix (the same columns), which stay in L1, so the products no
  longer wait on L2 for 4.2 MB a block a step;
* ``no FMAs``: the products skip their multiply-adds (and their weight
  loads); what is left of a product is its split-K partial sums' pass
  through shared memory, its bias and its block barriers.

So a product's time splits into its weight loads (as is - L1 weights), its
FMAs and operand reads (L1 weights - no FMAs) and the rest (no FMAs).  For
WaveNet-10 (``chip_smoke.py``'s ``WN_FULL``, random weights) at B = 8 and 256
(the streams a block ``group_for`` picks), each copy decodes 24 steps and the
script prints, over steps 4 .. 23, block 0's microseconds a step by phase and
the step's wall time from CUDA events over 512 steps (the marks on); then the
card's name and power limit.  The copies' tokens are not checked (the L1 and
no-FMA copies compute other numbers on purpose).
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
from mimikit_tpu_torch.ops import wavenet_decode as wd  # noqa: E402
from mimikit_tpu_torch.ops.nvcc import CSRC, NVCC_FLAGS  # noqa: E402

WORK = ROOT / "build" / "profile_wavenet_decode"
PHASES = ("step start", "embed + ring read", "ring write + conv input", "conv product", "gate",
          "skip|res product", "skip/res update", "head product", "pick")
N_MARKS = 8192
STEPS, FIRST = 24, 4

PROFILE_DEFS = r"""
__device__ long long g_wn_ns[%d];
__device__ int g_wn_kind[%d];
__device__ int g_wn_n;
#define WN_MARK(p) do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_wn_n < %d) { \
  long long t_; asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \
  g_wn_ns[g_wn_n] = t_; g_wn_kind[g_wn_n] = (p); ++g_wn_n; } } while (0)
""" % (N_MARKS, N_MARKS, N_MARKS)

READ_FNS = r"""
extern "C" int wn_prof_read(long long* ns, int* kind, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_wn_n, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbol(ns, g_wn_ns, sizeof(long long) * %d);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(kind, g_wn_kind, sizeof(int) * %d);
}
extern "C" int wn_prof_reset(void) {
  const int zero = 0;
  return (int)cudaMemcpyToSymbol(g_wn_n, &zero, sizeof(int));
}
""" % (N_MARKS, N_MARKS)

# (anchor in the source, the mark that follows it)
MARKS = (
    ("    const long long s = t - 1;\n", 0),
    ("a.rings[(row * B + b0 + g) * D + j] : 0.0f;\n    }\n    __syncthreads();\n", 1),
    ("rowA[g * ds + j] = rold[(l * G + g) * dp + j];\n      }\n      __syncthreads();\n", 2),
    ("rowA, ds, 2 * D, 2 * D, rowB, ds,\n                      red, a.red);\n"
     "      __syncthreads();\n", 3),
    ("sigmoid_f(rowB[g * ds + D + j]);\n      }\n      __syncthreads();\n", 4),
    ("                      rowB, ds, red, a.red);\n      __syncthreads();\n", 5),
    (": rowC[g * ds + j];\n      }\n      __syncthreads();\n", 6),
    ("      __syncthreads();\n      hin = hout;\n", 7),
    ("    __syncthreads();\n  }\n\n  if (tid < n_valid)", 8),
)


def _marked(text: str) -> str:
    for anchor, p in MARKS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"mark {p}: anchor found {text.count(anchor)} times")
        if p == 7:
            text = text.replace(anchor, "      __syncthreads();\n      WN_MARK(7);\n      hin = hout;\n")
        elif p == 8:
            text = text.replace(anchor, "    __syncthreads();\n    WN_MARK(8);\n  }\n\n"
                                        "  if (tid < n_valid)")
        else:
            text = text.replace(anchor, anchor + f"    WN_MARK({p});\n")
    return text


def _l1_weights(text: str) -> str:
    text, n = re.subn(r"__ldg\(wp \+ \(size_t\)(\([^)]*\)|k) \* N\)",
                      r"__ldg(wp + (size_t)((\1) & 15) * N)", text)
    if n != 6:
        raise RuntimeError(f"{n} weight loads rewritten, 6 expected")
    return text


def _no_fmas(text: str) -> str:
    old = "const int k0 = sp * kc, k1 = min(K, k0 + kc);"
    if text.count(old) != 1:
        raise RuntimeError("the product's K range was not found")
    return text.replace(old, "const int k0 = sp * kc, k1 = k0;")


VARIANTS = {"as is": lambda t: t, "L1 weights": _l1_weights, "no FMAs": _no_fmas}


def build(name: str, edit) -> Path:
    """Build a marked, edited copy of the source."""
    WORK.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "noise.cuh", WORK / "noise.cuh")
    tag = name.replace(" ", "_")
    src = WORK / f"wavenet_decode_{tag}.cu"
    src.write_text(PROFILE_DEFS + edit(_marked((CSRC / "wavenet_decode.cu").read_text()))
                   + READ_FNS)
    lib = WORK / f"libwn_profile_{tag}.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return lib


def profile(name: str, lib_path: Path, net, prompts) -> dict:
    """{B: {phase: us a step}} for the library at ``lib_path``."""
    wd.build_kernel = lambda: lib_path
    wd._Kernel.lib = None
    lib = wd._library()
    prof = ctypes.CDLL(str(lib_path))
    pack = wd.wavenet_weight_pack(net)
    ns = (ctypes.c_longlong * N_MARKS)()
    kind = (ctypes.c_int * N_MARKS)()
    n = ctypes.c_int(0)
    out = {}
    for B, prompt in prompts.items():
        prof.wn_prof_reset()
        wd.decode_chunk(pack, prompt, wd.init_decode_state(pack, prompt), 1, STEPS, 5, 0.9)
        torch.cuda.synchronize()
        if prof.wn_prof_read(ns, kind, ctypes.byref(n)):
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

        def run():
            wd.decode_chunk(pack, prompt, wd.init_decode_state(pack, prompt), 1, 512, 5, 0.9)

        run()
        wall = statistics.median(cs.cuda_ms(torch, run, 3)) * 1e3 / 512
        total = sum(per.values()) / steps
        print(f"{name}: B={B} (group {wd.group_for(pack, B, prompt.device)}): {total:.2f} us a"
              f" step by block 0's marks over steps {FIRST}..{STEPS - 1}; wall {wall:.2f} us a step"
              f" over 512 steps (the marks on)", flush=True)
        for p in PHASES[1:]:
            print(f"  {p:>24}: {per[p] / steps:8.2f} us a step, {counts[p] / steps:5.1f} marks a"
                  f" step, {per[p] / max(1, counts[p]):.3f} us each")
        out[B] = {p: per[p] / steps for p in PHASES[1:]}
        out[B]["wall"] = wall
    lib_holder = lib  # noqa: F841  (kept loaded until the next variant)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_wavenet_decode: no CUDA device", file=sys.stderr)
        return 2
    net = cs.make_wavenet(mmk, torch, wd, cs.WN_FULL, seed=0)
    prompts = {B: cs.make_prompt(torch, B, net.rf + 8, cs.WN_FULL["q_levels"], seed=B)
               for B in (8, 256)}
    res = {name: profile(name, build(name, edit), net, prompts)
           for name, edit in VARIANTS.items()}
    prod = ("conv product", "skip|res product", "head product")
    for B in prompts:
        a, l1, nf = (sum(res[v][B][p] for p in prod) for v in VARIANTS)
        rest = res["as is"][B]["wall"] - a
        print(f"B={B}: products {a:.2f} us a step = weight loads {a - l1:.2f} + FMAs and operand"
              f" reads {l1 - nf:.2f} + partial sums, bias and barriers {nf:.2f}; the other"
              f" phases {sum(res['as is'][B][p] for p in PHASES[1:] if p not in prod):.2f};"
              f" wall {res['as is'][B]['wall']:.2f} (L1 weights: {res['L1 weights'][B]['wall']:.2f},"
              f" no FMAs: {res['no FMAs'][B]['wall']:.2f}); marks beyond the wall {rest:.2f}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
