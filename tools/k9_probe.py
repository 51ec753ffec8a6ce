"""Split the categorical sampler's (K9) device time, and set its machine code
beside the Triton kernel's it replaced.

Usage, on a machine with one card: ``python3 tools/k9_probe.py <parent root>``,
where ``<parent root>`` is a checkout whose ``ops/categorical.py`` holds the
Triton kernel (e.g. ``git archive`` of the parent into ``build/parent``);
about a minute.  At (B, Q) = (256, 256), f32 logits, it prints one JSON line
each for:

* the Triton kernel (in a process of its own, its cache under
  ``chiprun_out/k9/triton_cache``): device ms a call (100 calls in a CUDA
  graph, median of 5 replays) and its SASS digest;
* each variant of ``tools/k9_probe.cu`` (the production kernel, an empty
  kernel on its grid, its loads and argmax without the division or the
  noise, with the division, with fast arithmetic, the production kernel on
  Triton's launch shape, and the kernel before its division was hoisted and
  its passes straightened): the
  same, and whether its indices equal the production kernel's; then the
  kernel unrolled for Q = 256 on one warp or 64 threads a row, its noise
  drawn before or after the loads, the loads and argmax alone on one warp
  a row, the Triton kernel's own cubin launched through the driver API from
  the probe's library, and the production kernel launched the same way;
* the division check: the quotients, over every f32 significand of x in
  [1, 2) and its negation at 4,096 temperatures (0.9, 1, 0.5, 0.7, 1.3, 2,
  0.1, 10 and log-uniform draws over [2^-40, 2^40]), in which the production
  kernel's division differs in a bit from `/`.

A SASS digest is the instruction count, the registers a thread, and the count
of each opcode (``cuobjdump -sass``); the full listings go to
``chiprun_out/k9/``.
"""
import collections
import ctypes
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "k9")
SHAPE, PER, REPS, T, SEED = (256, 256), 100, 5, 0.9, 5
VARIANTS = ("production", "empty on its grid", "loads and argmax of x",
            "argmax of x / t", "fast division and logs", "warp a row, row a block",
            "warp a row, 8 rows a block", "before: a loop, `/` for every logit",
            "unrolled, warp a row, noise first", "unrolled, warp a row, loads first",
            "unrolled, 64 threads a row, noise first", "unrolled, warp a row, 4 rows a block",
            "loads and argmax of x, warp a row", "Triton's cubin, launched from here",
            "production through cuLaunchKernel")


def cuobjdump(*args):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, *args], capture_output=True, text=True, check=True).stdout


def sass_digests(binary: str, tag: str) -> dict:
    """{function: {"instructions", "regs", "ops": {opcode: count}}} of a cubin
    or a library; its listing written to chiprun_out/k9/<tag>.sass."""
    text = cuobjdump("-sass", binary)
    with open(os.path.join(OUT, tag + ".sass"), "w") as f:
        f.write(text)
    regs, name = {}, None
    for line in cuobjdump("-res-usage", binary).splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and name:
            regs[name] = int(m.group(1))
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"instructions": 0, "regs": regs.get(name), "ops": collections.Counter()}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if m and name:
            out[name]["instructions"] += 1
            out[name]["ops"][m.group(1)] += 1
    for d in out.values():
        d["ops"] = dict(d["ops"].most_common())
    return out


def graph_ms(torch, fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(PER):
            fn()
    g.replay()
    ms = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b) / PER)
    return statistics.median(ms), ms


def logits(torch):
    return torch.randn(*SHAPE, generator=torch.Generator().manual_seed(7)).cuda()


def triton_side(parent: str) -> dict:
    """In a process of its own: the parent's Triton kernel, timed, its cubin
    digested."""
    cache = os.path.join(OUT, "triton_cache")
    os.environ["TRITON_CACHE_DIR"] = cache
    sys.path.insert(0, os.path.abspath(parent))
    import torch

    from mimikit_tpu_torch.ops import categorical as cat

    x = logits(torch)
    idx = cat.categorical(x, T, SEED)
    ms, all_ms = graph_ms(torch, lambda: cat.categorical(x, T, SEED))
    cubins = sorted(glob.glob(os.path.join(cache, "**", "*.cubin"), recursive=True))
    sass = {}
    for i, c in enumerate(cubins):
        sass.update(sass_digests(c, f"triton_{i}"))
    return {"kernel": "triton", "ms": ms, "all_ms": all_ms, "sass": sass,
            "indices": idx.cpu().tolist(), "cubins": cubins}


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    if len(sys.argv) == 3 and sys.argv[1] == "--triton":
        print(json.dumps(triton_side(sys.argv[2])), flush=True)
        return 0
    res = subprocess.run([sys.executable, __file__, "--triton", sys.argv[1]],
                         capture_output=True, text=True)
    if res.returncode:
        print(res.stderr[-3000:], file=sys.stderr)
        return res.returncode
    triton = json.loads(res.stdout.strip().splitlines()[-1])
    print(json.dumps({k: v for k, v in triton.items() if k != "indices"}), flush=True)
    with open(triton["cubins"][0], "rb") as f:
        cubin = f.read()

    sys.path.insert(0, ROOT)
    import torch

    from mimikit_tpu_torch.ops.nvcc import build_library

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lib_path = str(build_library(Path(ROOT) / "tools" / "k9_probe.cu", "mmk_k9_probe")[0])
    lib = ctypes.CDLL(lib_path)
    p = ctypes.c_void_p
    lib.mmk_k9_probe.argtypes = [ctypes.c_int, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_uint, p]
    lib.mmk_k9_probe.restype = ctypes.c_int
    lib.mmk_k9_div_check.argtypes = [p, ctypes.c_int, p, p]
    lib.mmk_k9_div_check.restype = ctypes.c_int
    lib.mmk_k9_load_cubin.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.mmk_k9_load_cubin.restype = ctypes.c_int
    sass = sass_digests(lib_path, "cuda")
    loaded = lib.mmk_k9_load_cubin(cubin, b"_categorical_src")
    print(json.dumps({"Triton cubin loaded": loaded == 0, "code": loaded}), flush=True)
    fixed = [0.9, 1.0, 0.5, 0.7, 1.3, 2.0, 0.1, 10.0]
    drawn = torch.exp2(torch.empty(4096 - len(fixed)).uniform_(
        -40, 40, generator=torch.Generator().manual_seed(3)))
    ts = torch.cat([torch.tensor(fixed), drawn]).float().cuda()
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    err = lib.mmk_k9_div_check(ts.data_ptr(), ts.numel(), bad.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    print(json.dumps({"division check": {"launch error": err, "temperatures": ts.numel(),
                                         "quotients": ts.numel() * 2 ** 24,
                                         "differing from /": int(bad.item())}}), flush=True)
    x = logits(torch)
    out = torch.zeros(SHAPE[0], dtype=torch.int32, device="cuda")

    def launch(v):
        err = lib.mmk_k9_probe(v, x.data_ptr(), out.data_ptr(), SHAPE[0], SHAPE[1], T, SEED,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {v}: cudaError_t {err}")

    launch(0)
    torch.cuda.synchronize()
    production = out.cpu().tolist()
    print(json.dumps({"card": card, "production indices equal the Triton kernel's":
                      production == triton["indices"]}), flush=True)
    for v, what in enumerate(VARIANTS):
        out.zero_()
        launch(v)
        torch.cuda.synchronize()
        same = out.cpu().tolist() == production
        ms, all_ms = graph_ms(torch, lambda: launch(v))
        print(json.dumps({"variant": v, "what": what, "ms": ms, "all_ms": all_ms,
                          "indices equal production": same}), flush=True)
    print(json.dumps({"cuda sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
