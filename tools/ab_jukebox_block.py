"""Time K8's block kernel (``csrc/jukebox_decode.cu``) of one checkout, and of
variant sources of it.

Usage, on a machine with one card: ``python3 tools/ab_jukebox_block.py
<root> [variant.cu ...]``, for two checkouts in turns (old, new, new, old).
It imports ``<root>/mimikit_tpu_torch``, builds jukebox3 (frames (32, 16,
4), d 128, 8 heads, ff 256, 2 layers a tier, rf 128; weights from a seed),
and times one 256-step launch of the block kernel at B=64 (the route's
shape), sampled at T=0.9 and argmax, median of 5 by CUDA events; then the
same for each variant source (a copy of the checkout's ``jukebox_decode.cu``
with its ``csrc/`` headers beside it, built in place of the package's), its
tokens required equal to the package build's.  It prints one JSON line: per
build, microseconds a step and the kernel's SASS digest, registers and
stack (``tools/sass_digest.py``).
"""
import json
import os
import sys
from pathlib import Path

import torch

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import mimikit_tpu_torch as mmk  # noqa: E402
from mimikit_tpu_torch.ops import jukebox_decode as jbd  # noqa: E402
from sass_digest import digests  # noqa: E402

B, N, REPS, SEED = 64, 256, 5, 7


def event_ms(fn):
    fn()
    out = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)[REPS // 2]


def main():
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=256, mlp_dim=128))
    net = mmk.JukeBox.from_config(mmk.JukeBox.Config(
        io_spec=io, frame_sizes=(32, 16, 4), model_dim=128, n_heads=8, feedforward_dim=256,
        num_layers=2, rf=128, input_dropout=0.0), device="cuda", seed=0).eval()
    pack = jbd.jukebox_weight_pack(net)
    W = net._window_len()
    g = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, 256, (B, W), generator=g, dtype=torch.int32).cuda()
    res, ref = {}, {}
    for name in ["package"] + sys.argv[2:]:
        if name != "package":
            jbd.SOURCE, jbd._Kernel.lib = Path(name).resolve(), None
        row = {"sass": digests(jbd.build_kernel())}
        for temp in (0.9, None):
            def run():
                return jbd._launch(pack, jbd.lead_window(prompt, W), W, N, SEED, temp)

            toks = run()
            torch.cuda.synchronize()
            ref.setdefault(temp, toks)
            row[f"us_{temp}"] = event_ms(run) * 1e3 / N
            row[f"tokens_equal_{temp}"] = bool(torch.equal(toks, ref[temp]))
        res[name] = row
    print(json.dumps({"root": ROOT, "card": torch.cuda.get_device_name(0), "builds": res}))


if __name__ == "__main__":
    main()
