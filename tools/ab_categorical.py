"""Time the categorical sampler (K9) of one checkout on the card.

Usage: ``python3 tools/ab_categorical.py <root> [<root> ...]``, e.g.
``python3 tools/ab_categorical.py build/parent . . build/parent`` for an A/B
in turns.  For each checkout's ``mimikit_tpu_torch.ops.categorical`` (each in
a process of its own) it prints one JSON line at (B, Q) = (256, 256), the
decode path's shape, f32 logits: the device time of one call (100 calls
captured in a CUDA graph, replayed between CUDA events, median of 5), the
host time of one call (2,000 calls from the host, then a synchronize: the
launcher's cost, the card being faster), the same for bf16 logits, an empty
kernel's device time (``tools/launch_floor.cu``, this checkout's), the floor
below which no launch goes; and the card's name and power limit.
"""
import json
import os
import statistics
import subprocess
import sys
import time

SHAPE, PER, REPS, HOST_CALLS = (256, 256), 100, 5, 2000


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mimikit_tpu_torch.ops import categorical as cat

    def graph_ms(fn):
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
        out = []
        for _ in range(REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / PER)
        return statistics.median(out)

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t) / HOST_CALLS

    x = torch.randn(*SHAPE, generator=torch.Generator().manual_seed(7)).cuda()
    res = {"root": root, "source": cat.__file__}
    for name, logits in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        fn = lambda: cat.categorical(logits, 0.9, 5)  # noqa: E731
        res[f"{name}_ms"] = graph_ms(fn)
        res[f"{name}_host_us"] = host_us(fn)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import launch_floor

    res["empty_ms"] = graph_ms(launch_floor.empty_launch)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    for root in sys.argv[1:]:
        res = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                             text=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
