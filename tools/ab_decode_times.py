"""Time the SampleRNN, WaveNet and transformer decode kernels of one checkout.

Usage, on a machine with one card: ``python3 tools/ab_decode_times.py
<root>`` for two checkouts in turns (old, new, new, old), so that both run on
one card.  It builds ``<root>/mimikit_tpu_torch/csrc/samplernn_decode.cu``,
``wavenet_decode.cu``, ``transformer_decode.cu`` and ``transformer_kv.cu``
and prints one JSON line of CUDA-event times (three runs each, f32 weight
packs, temperature 0.9, the shapes of ``chip_smoke.py``'s ``kernels`` rows):
``decode_single`` at B=4 (4,096 steps after a 32-token prompt), one
2,048-step ``decode_chunk`` at B=256, K6 (``decode_window``) at B=1 over
1,024 steps after a 64-token prompt, and one 1,600-step K7 ``decode_chunk``
at B=16 (transformer8l).  Where the checkout packs bf16 weights, the same
SampleRNN and K7 calls on bf16 packs too.  WaveNet-10 (K4/K5): a short
sampled decode at B=8 and an argmax one at B=256 checked against the plain
twin by teacher forcing, then microseconds a step of ``decode_single`` at
B=8 (2,048 steps after a prompt of rf + 8) and of one 1,024-step
``decode_chunk`` at B=256, and the host-clock latency of 1,600-step
``stream_audio`` chunks at B=64.
"""
import json
import os
import sys
import time

import torch

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)

import mimikit_tpu_torch as mmk  # noqa: E402
from mimikit_tpu_torch.ops import samplernn_decode as sd  # noqa: E402
from mimikit_tpu_torch.ops import transformer_decode as td  # noqa: E402
from mimikit_tpu_torch.ops import transformer_kv as tk  # noqa: E402
from mimikit_tpu_torch.ops import wavenet_decode as wd  # noqa: E402

SEED, TEMP = 1234, 0.9


def prompt(B, T, q, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, q, (B, T), generator=g, dtype=torch.int32).cuda()


def event_ms(fn, reps=3, warm=True):
    if warm:
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


def packs(build, net):
    """The f32 pack, and the bf16 one where the checkout has it."""
    out = {"f32": build(net)}
    try:
        out["bf16"] = build(net, torch.bfloat16)
    except TypeError:  # a checkout from before the bf16 packs
        pass
    return out


def wavenet(res):
    """WaveNet-10's kernel (K4/K5): teacher-forcing checks, then its times."""
    res["wavenet_spills"] = [l.strip() for l in wd._Kernel.build_log.splitlines()
                             if "spill" in l]
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=256, mlp_dim=128,
                                                      input_module_type="embedding"))
    cfg = mmk.WaveNet.Config(io_spec=io, blocks=(10,), dims_dilated=(128,), skips_dim=128,
                             residuals_dim=128, pad_side=0)
    net = mmk.WaveNet.from_config(cfg, device="cuda", seed=0).eval()
    pack, rf = wd.wavenet_weight_pack(net), net.rf
    p8, p256, p64 = (prompt(B, rf + 8, 256, B) for B in (8, 256, 64))
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
        res[f"wavenet_check_B{B}"] = [float(gap.max()), bad]
        assert bad == 0, res
    steps = rf + 8 + 2048 - 1
    wd.decode_single(pack, p8, 16, 1, 0.9)
    res["K4_B8_us_step"] = [1e3 * m / steps for m in event_ms(
        lambda: wd.decode_single(pack, p8, 2048, 1, 0.9), warm=False)]
    wd.decode_chunk(pack, p256, wd.init_decode_state(pack, p256), 1, 16, 1, 0.9)
    res["K5_B256_us_step"] = [1e3 * m / 1024 for m in event_ms(lambda: wd.decode_chunk(
        pack, p256, wd.init_decode_state(pack, p256), 1, 1024, 1, 0.9), warm=False)]
    it = mmk.stream_audio(net, (p64,), 1600, temperature=0.9, seed=3)
    lat, t = [], time.perf_counter()
    for _ in range(5):
        next(it)
        now = time.perf_counter()
        lat.append(1e3 * (now - t))
        t = now
    it.close()
    res["wavenet_stream_B64_chunk_ms"] = lat


def main():
    assert sd.__file__.startswith(ROOT), sd.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mod in (sd, wd, td, tk):
        mod.build_kernel()
    res = {"root": sys.argv[1]}
    wavenet(res)
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=256, mlp_dim=256))
    net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(
        frame_sizes=(16, 8, 8), hidden_dim=256, io_spec=io), device="cuda", seed=0).eval()
    p4, p256 = prompt(4, 32, 256, 4), prompt(256, 32, 256, 256)
    for tag, pack in packs(sd.samplernn_weight_pack, net).items():
        res[f"K1_{tag}_ms"] = event_ms(lambda: sd.decode_single(pack, p4, 4096, SEED, TEMP))
        res[f"K2_{tag}_ms"] = event_ms(lambda: sd.decode_chunk(
            pack, p256, sd.init_decode_state(net, p256), 16, 2048, SEED, TEMP))
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=256, mlp_dim=128,
                                                      input_module_type="embedding"))
    tf = mmk.SimpleTransformer.from_config(mmk.SimpleTransformer.Config(
        io_spec=io, model_dim=256, n_heads=8, feedforward_dim=1024, num_layers=8, rf=64,
        input_dropout=0.0), device="cuda", seed=0).eval()
    p1, p16 = prompt(1, 64, 256, 1), prompt(16, 64, 256, 16)
    for tag, pack in packs(td.transformer_weight_pack, tf).items():
        if tag == "f32":
            res["K6_f32_us_step"] = [1e3 * m / 1024 for m in event_ms(
                lambda: td.decode_window(pack, p1, 1024, SEED, TEMP))]
        res[f"K7_{tag}_ms"] = event_ms(lambda: tk.decode_chunk(
            pack, p16.t().contiguous(), tk.init_kv_state(pack, p16), 1, 1600, TEMP, SEED))
    res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
