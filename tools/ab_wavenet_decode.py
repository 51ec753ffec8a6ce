"""Time the WaveNet-10 decode kernel of the package under a checkout root.

Usage, on a machine with one card: ``python3 tools/ab_wavenet_decode.py
<root>`` for two checkouts in turns (old, new, new, old), so that both run
on one card.  It builds ``<root>/mimikit_tpu_torch/csrc/wavenet_decode.cu``,
checks a short sampled decode at B=8 and an argmax one at B=256 against the
plain twin by teacher forcing, then prints one JSON line: microseconds a
step of ``decode_single`` at B=8 (2,048 steps after a prompt of rf + 8) and
of one 1,024-step ``decode_chunk`` at B=256 (three runs each, CUDA events),
and the host-clock latency of 1,600-step ``stream_audio`` chunks at B=64.
"""
import json
import os
import sys
import time

import torch

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)

import mimikit_tpu_torch as mmk  # noqa: E402
from mimikit_tpu_torch.ops import wavenet_decode as wd  # noqa: E402


def prompt(rf, B, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, rf + 8), generator=g, dtype=torch.int32).cuda()


def event_ms(fn, reps=3):
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def main():
    assert wd.__file__.startswith(ROOT), wd.__file__
    torch.backends.cudnn.allow_tf32 = False
    wd.build_kernel()
    res = {"root": sys.argv[1],
           "spills": [l.strip() for l in wd._Kernel.build_log.splitlines() if "spill" in l]}
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=256, mlp_dim=128,
                                                      input_module_type="embedding"))
    cfg = mmk.WaveNet.Config(io_spec=io, blocks=(10,), dims_dilated=(128,), skips_dim=128,
                             residuals_dim=128, pad_side=0)
    net = mmk.WaveNet.from_config(cfg, device="cuda", seed=0).eval()
    pack, rf = wd.wavenet_weight_pack(net), net.rf
    p8, p256, p64 = prompt(rf, 8, 8), prompt(rf, 256, 256), prompt(rf, 64, 64)
    # teacher forcing: every kernel token is its row's argmax of the plain scores
    for B, p, temp in ((8, p8, 0.9), (256, p256, None)):
        n = 96
        toks = wd.decode_chunk(pack, p, wd.init_decode_state(pack, p), 1, rf + 7 + n, 11,
                               temp)[:, rf + 7:]
        full = torch.cat([p, toks], 1).contiguous()
        _, sc = wd.decode_plain(pack, full, wd.init_decode_state(pack, full), 1,
                                full.shape[1] - 1, 1, 1, 11, temp, return_scores=True)
        s = sc[rf + 7:]
        gap = s.max(-1).values - s.gather(-1, toks.T.long()[..., None])[..., 0]
        bad = int((gap > 1e-4 * s.abs().amax(-1)).sum())
        res[f"check_B{B}"] = [float(gap.max()), bad]
        assert bad == 0, res
    steps = rf + 8 + 2048 - 1
    wd.decode_single(pack, p8, 16, 1, 0.9)
    res["B8_us_step"] = [1e3 * m / steps
                         for m in event_ms(lambda: wd.decode_single(pack, p8, 2048, 1, 0.9))]
    wd.decode_chunk(pack, p256, wd.init_decode_state(pack, p256), 1, 16, 1, 0.9)
    res["B256_us_step"] = [1e3 * m / 1024 for m in event_ms(lambda: wd.decode_chunk(
        pack, p256, wd.init_decode_state(pack, p256), 1, 1024, 1, 0.9))]
    it = mmk.stream_audio(net, (p64,), 1600, temperature=0.9, seed=3)
    lat, t = [], time.perf_counter()
    for _ in range(5):
        next(it)
        now = time.perf_counter()
        lat.append(1e3 * (now - t))
        t = now
    it.close()
    res["stream_B64_chunk_ms"] = lat
    print(json.dumps(res))


if __name__ == "__main__":
    main()
