"""Digest the tokens every decode kernel draws at one temperature, in one checkout.

Usage, on a machine with one card: ``python3 tools/ab_tokens.py <root>``
for two checkouts, each in its own process (e.g. ``build/parent`` and
``.``); equal lines are bit-identical tokens.  It imports
``<root>/mimikit_tpu_torch``, builds its decode kernels, and prints one JSON
line: for each kernel and route (K1 and K2 on the cluster and the block
kernel, f32 and bf16 packs; K4 and K5 on both WaveNet kernels; K6; K7 f32
and bf16; K8's cluster, group and block kernels), at argmax and at a scalar
temperature of 0.9, the sha256 prefix of the (B, n) int32 tokens decoded
after a seeded prompt by a net whose weights come from a seed.  The calls
pass the temperature as a plain float, which every checkout takes.
"""
import hashlib
import json
import os
import sys

import torch

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)

import mimikit_tpu_torch as mmk  # noqa: E402
from mimikit_tpu_torch.ops import jukebox_decode as jbd  # noqa: E402
from mimikit_tpu_torch.ops import samplernn_decode as sd  # noqa: E402
from mimikit_tpu_torch.ops import transformer_decode as td  # noqa: E402
from mimikit_tpu_torch.ops import transformer_kv as tk  # noqa: E402
from mimikit_tpu_torch.ops import wavenet_decode as wd  # noqa: E402

SEED, TEMP, B, N = 77, 0.9, 4, 160


def prompt(T, q, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, q, (B, T), generator=g, dtype=torch.int32).cuda()


def digest(x):
    torch.cuda.synchronize()
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def io(q, mlp, emb):
    return mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
        q_levels=q, mlp_dim=mlp, input_module_type="embedding" if emb else "framed_linear"))


def main():
    out = {}
    net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(
        frame_sizes=(8, 4, 2), hidden_dim=128, io_spec=io(64, 128, False)), device="cuda",
        seed=1).eval()
    p = prompt(2 * net.rf, 64, 2)
    for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pack = sd.samplernn_weight_pack(net, dt)
        for cl in (16, 8, 0):
            for temp in (None, TEMP):
                key = f"{dn}/cl{cl}/{'argmax' if temp is None else temp}"
                out[f"decode_single/{key}"] = digest(sd.decode_single(pack, p, N, SEED, temp,
                                                                      cl=cl))
                state = sd.init_decode_state(net, p)
                out[f"decode_chunk/{key}"] = digest(sd.decode_chunk(
                    pack, p, state, net.rf, p.shape[1] + N - net.rf, SEED, temp, cl=cl))
    wn = mmk.WaveNet.from_config(mmk.WaveNet.Config(
        io_spec=io(32, 16, True), blocks=(3,), dims_dilated=(16,), skips_dim=16,
        residuals_dim=16, pad_side=0), device="cuda", seed=1).eval()
    pack = wd.wavenet_weight_pack(wn)
    p = prompt(wn.rf + 8, 32, 3)
    for cl in (16, 0):
        for temp in (None, TEMP):
            key = f"cl{cl}/{'argmax' if temp is None else temp}"
            out[f"wavenet_decode_single/{key}"] = digest(wd.decode_single(pack, p, N, SEED, temp,
                                                                          cl=cl))
            state = wd.init_decode_state(pack, p)
            out[f"wavenet_decode_chunk/{key}"] = digest(wd.decode_chunk(
                pack, p, state, 1, p.shape[1] + N - 1, SEED, temp, cl=cl))
    tf = mmk.SimpleTransformer.from_config(mmk.SimpleTransformer.Config(
        io_spec=io(32, 16, True), model_dim=32, n_heads=4, feedforward_dim=64, num_layers=2,
        rf=16, input_dropout=0.0), device="cuda", seed=1).eval()
    p = prompt(32, 32, 4)
    for temp in (None, TEMP):
        mode = "argmax" if temp is None else str(temp)
        pack = td.transformer_weight_pack(tf)
        out[f"transformer_decode_window/{mode}"] = digest(td.decode_window(pack, p, N, SEED,
                                                                           temp))
        for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            pack = td.transformer_weight_pack(tf, dt)
            state = tk.init_kv_state(pack, p)
            out[f"transformer_decode_chunk/{dn}/{mode}"] = digest(tk.decode_chunk(
                pack, p.t().contiguous(), state, 1, p.shape[1] + N - 1, temp, SEED))
    jb = mmk.JukeBox.from_config(mmk.JukeBox.Config(
        io_spec=io(32, 16, False), frame_sizes=(8, 4, 2), model_dim=32, n_heads=4,
        feedforward_dim=64, num_layers=2, rf=16, input_dropout=0.0), device="cuda",
        seed=1).eval()
    pack = jbd.jukebox_weight_pack(jb)
    p = prompt(jb._window_len(), 32, 5)
    launches = {"cluster": lambda *a: jbd._launch_cluster(*a),
                "group": lambda *a: jbd._launch_group(*a, 8),
                "block": lambda *a: jbd._launch(*a)}
    for name, launch in launches.items():
        for temp in (None, TEMP):
            window = jbd.lead_window(p, pack.window)
            out[f"decode_pyramid/{name}/{'argmax' if temp is None else temp}"] = digest(
                launch(pack, window, p.shape[1], N, SEED, temp))
    print(json.dumps({"root": ROOT, "tokens": out}))


if __name__ == "__main__":
    main()
