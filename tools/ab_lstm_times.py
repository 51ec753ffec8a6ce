"""Time the fused LSTM kernels (K3a/K3b) of one checkout, and digest their SASS.

Usage, on a machine with one card: ``python3 tools/ab_lstm_times.py <root>``
for two checkouts in turns (old, new, new, old), so that both run on one
card; unpack the parent with ``git archive HEAD | tar -x -C build/parent``.
It builds ``<root>/mimikit_tpu_torch/csrc/fused_lstm.cu`` and prints one JSON
line: CUDA-event times (median and all of 5 runs, after a warm-up) of
``lstm_forward`` and ``lstm_backward`` on f32 streams at the training path's
tier shapes (T, B, H) = (128, 32, 256) and (256, 32, 256), the same on bf16
streams where the checkout has them, ``lstm_forward_wide`` and
``lstm_backward_wide`` (K3a-wide, K3b-wide) at the wide train step's tier
shape, (256, 32, 512) on f32 and (256, 32, 768) on bf16 streams, where the
checkout has them, and a digest of each kernel's SASS
(``cuobjdump -sass`` of the built library, addresses and encodings dropped),
keyed by kernel, template integers (cluster size, rows a cluster) and stream
type: equal digests are equal
machine code; beside each digest, the kernel's registers and stack bytes a
thread (``cuobjdump -res-usage``).
"""
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)

from mimikit_tpu_torch.ops import fused_lstm as fl  # noqa: E402

SHAPES = ((128, 32, 256), (256, 32, 256))
WIDE_SHAPES = ((torch.float32, 256, 32, 512), (torch.bfloat16, 256, 32, 768))


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


def kernel_key(name):
    """A mangled kernel name -> "kernel template-ints stream" (the cluster
    size and the rows a cluster where the kernel takes them, e.g.
    "lstm_fwd_kernel 8,4 f32")."""
    kernel = re.search(r"(lstm_\w+?_kernel)", name).group(1)
    ints = re.findall(r"Li(\d+)E", name)
    stream = "bf16" if "bfloat16" in name else "f32"
    return f"{kernel} {','.join(ints) or '-'} {stream}"


def sass_digests(lib_path):
    """{"kernel rows stream": "sha256 prefix of its instructions, REG n STACK
    m"}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    usage = {}
    res = subprocess.run([tool, "-res-usage", str(lib_path)], capture_output=True,
                         text=True).stdout
    for fn, line in re.findall(r"Function (\S+):\s*\n\s*(.*)", res):
        reg, stack = re.search(r"REG:(\d+)", line), re.search(r"STACK:(\d+)", line)
        usage[kernel_key(fn)] = (f"REG {reg.group(1) if reg else '?'}"
                                 f" STACK {stack.group(1) if stack else '?'}")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out, name, body = {}, None, []

    def close():
        if name is not None:
            key = kernel_key(name)
            digest = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
            out[key] = f"{digest} {usage.get(key, '')}".strip()

    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            close()
            name, body = m.group(1), []
        elif name is not None:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", ln)
            if ins:
                body.append(ins.group(1))
    close()
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"root": ROOT, "sass": sass_digests(fl.build_lstm_kernel()), "ms": {}}
    dtypes = [torch.float32] + ([torch.bfloat16] if hasattr(fl.lstm_forward, "launches_bf16")
                                else [])
    g = torch.Generator().manual_seed(0)
    for dt in dtypes:
        for T, B, H in SHAPES:
            def mk(*s, sc=1.0):
                return (torch.randn(*s, generator=g) * sc).cuda().to(dt)

            xi, Wh, h0, c0 = mk(T, B, 4 * H), mk(H, 4 * H, sc=H ** -0.5), mk(B, H), mk(B, H)
            h_all, c_all, gates = fl.lstm_forward(xi, Wh, h0, c0)
            bw = (mk(T, B, H), mk(B, H), mk(B, H), gates, c_all, h_all, h0, c0, Wh)
            tag = "bf16" if dt == torch.bfloat16 else "f32"
            for name, fn in (("lstm_forward", lambda: fl.lstm_forward(xi, Wh, h0, c0)),
                             ("lstm_backward", lambda: fl.lstm_backward(*bw))):
                ms = event_ms(fn)
                res["ms"][f"{name} {tag} T={T}"] = [statistics.median(ms), ms]
    if hasattr(fl, "lstm_forward_wide"):
        for dt, T, B, H in WIDE_SHAPES:
            def mk(*s, sc=1.0):
                return (torch.randn(*s, generator=g) * sc).cuda().to(dt)

            xi, Wh, h0, c0 = mk(T, B, 4 * H), mk(H, 4 * H, sc=H ** -0.5), mk(B, H), mk(B, H)
            h_all, c_all, gates = fl.lstm_forward_wide(xi, Wh, h0, c0)
            bw = (mk(T, B, H), mk(B, H), mk(B, H), gates, c_all, h_all, h0, c0, Wh)
            tag = "bf16" if dt == torch.bfloat16 else "f32"
            for name, fn in (("lstm_forward_wide", lambda: fl.lstm_forward_wide(xi, Wh, h0, c0)),
                             ("lstm_backward_wide", lambda: fl.lstm_backward_wide(*bw))):
                ms = event_ms(fn)
                res["ms"][f"{name} {tag} (T, B, H)=({T}, {B}, {H})"] = [statistics.median(ms), ms]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
