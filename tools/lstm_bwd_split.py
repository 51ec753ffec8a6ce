"""Split the fused LSTM backward (K3b) of one checkout into its kernels.

Usage, on a machine with one card: ``python3 tools/lstm_bwd_split.py <root>``
for two checkouts in turns (old, new, new, old), so that both run on one
card; unpack the parent with ``git archive HEAD | tar -x -C build/parent``.
It builds ``<root>/mimikit_tpu_torch/csrc/fused_lstm.cu`` and, on f32 and
bf16 streams at the training path's tier shapes (T, B, H) = (128, 32, 256)
and (256, 32, 256), times ``lstm_backward`` by CUDA events (median of 5
after a warm-up) and splits one call's device time by kernel with
``torch.profiler``: the reverse-time walk (``lstm_bwd_kernel``) and dWh
(``lstm_dwh_kernel`` and its partial-tile sum).  Where the checkout's walk
takes a cluster size (``lstm_backward(..., cl=)``) each size is timed.  It
prints one JSON line.
"""
import inspect
import json
import os
import statistics
import sys

import torch

SHAPES = ((128, 32, 256), (256, 32, 256))


def event_ms(fn, reps=5):
    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def by_kernel(fn, reps=3):
    """{kernel part: device ms a call} over ``reps`` calls under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        name = ev.key
        part = ("walk" if "lstm_bwd_kernel" in name else
                "dwh_sum" if "lstm_dwh_sum_kernel" in name else
                "dwh" if "lstm_dwh_kernel" in name else None)
        if part:
            parts[part] = parts.get(part, 0.0) + us / 1e3 / reps
    return parts


def inputs(fl, T, B, H, dtype):
    g = torch.Generator().manual_seed(T)
    mk = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).cuda().to(dtype)  # noqa: E731
    xi, Wh = mk(T, B, 4 * H), mk(H, 4 * H, sc=H ** -0.5)
    h0, c0 = mk(B, H, sc=0.3), mk(B, H, sc=0.3)
    h_all, c_all, gates = fl.lstm_forward(xi, Wh, h0, c0)
    return (mk(T, B, H), mk(B, H), mk(B, H), gates, c_all, h_all, h0, c0, Wh)


def main() -> int:
    sys.path.insert(0, os.path.abspath(sys.argv[1]))
    from mimikit_tpu_torch.ops import fused_lstm as fl

    sizes = ((None, 8, 16) if "cl" in inspect.signature(fl.lstm_backward).parameters
             else (None,))
    out = {"root": sys.argv[1], "device": torch.cuda.get_device_name(0), "rows": []}
    for dtype in (torch.float32, torch.bfloat16):
        for T, B, H in SHAPES:
            args = inputs(fl, T, B, H, dtype)
            for cl in sizes:
                kw = {} if cl is None else {"cl": cl}
                fn = lambda: fl.lstm_backward(*args, **kw)  # noqa: E731
                ms = event_ms(fn)
                out["rows"].append(dict(
                    dtype=str(dtype).split(".")[-1], T=T, B=B, H=H, cl=cl or "route",
                    plan=getattr(fl.lstm_backward, "last_cluster_size", 8),
                    ms=statistics.median(ms), all_ms=ms, parts=by_kernel(fn)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
