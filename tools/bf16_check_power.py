"""How well teacher forcing tells the bf16 decode kernels from a faulty one.

Usage, on a machine with one card: ``python3 tools/bf16_check_power.py``.
It runs the cases of ``chip_smoke.py``'s phase 2 for the bf16 instantiations
(SampleRNN's ``decode_single`` B=4 and ``decode_chunk``, K7 at B=1, 16 and
32; small and full width; argmax and T=0.9) with three token sources:

* ``bf16``: the kernel on the bf16 pack (the route under test);
* ``control``: the f32 instantiation on bf16-valued weights, which leaves
  the products' inputs unrounded (the fault the check must catch);
* ``alt``: the bf16 twin's own free run with f64 sums (a correct decode in
  another summation order).

Each source's tokens are fed to the f32-summed bf16 twin, and per case it
prints one line per source: the rows, those whose token lies more than
1e-4 * max|score| below the row's maximum, those beyond that tolerance
widened by the f64 twin's spread (what ``verify_tokens`` counts against
``BF16_FLIP_ROWS``), and the largest gap in units of the row's scale.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import mimikit_tpu_torch as mmk  # noqa: E402
from mimikit_tpu_torch.ops import samplernn_decode as sd  # noqa: E402
from mimikit_tpu_torch.ops import transformer_decode as td  # noqa: E402
from mimikit_tpu_torch.ops import transformer_kv as tk  # noqa: E402


def report(tag, prompt, toks, tf, t_first, tf_chunk=1024):
    """One line of row counts for ``toks`` under the twin's scores ``tf``."""
    B, prior_t = prompt.shape
    n = toks.shape[1]
    full = torch.cat([prompt, toks.to(torch.int32)], 1).contiguous()
    rows = off = beyond = 0
    worst, st, st64, t = 0.0, None, None, t_first
    while t < prior_t + n:
        m = min(tf_chunk, prior_t + n - t)
        s, st = tf(full, st, t, m, torch.float32)
        a, st64 = tf(full, st64, t, m, torch.float64)
        lo = max(t, prior_t)
        if lo < t + m:
            s, a = s[lo - t :], a[lo - t :]
            tok = full[:, lo : t + m].T.long()
            scale = s.abs().amax(-1)
            gap = (s.amax(-1) - s.gather(-1, tok[..., None])[..., 0]) / scale
            spread = (s - a).abs().amax(-1) / scale
            rows += gap.numel()
            off += int((gap > cs.TOL).sum())
            beyond += int((gap > cs.TOL + spread).sum())
            worst = max(worst, float(gap.max()))
        t += m
    print(f"{tag}: rows {rows}, beyond 1e-4 {off}, beyond the widened tolerance {beyond}"
          f" ({beyond / rows:.3%}), largest gap {worst:.3e}", flush=True)


def samplernn(spec, jitter, B_single, B_chunk, n, size):
    net = cs.make_net(mmk, torch, spec, seed=1, jitter=jitter)
    pack = sd.samplernn_weight_pack(net, torch.bfloat16)
    ctl = sd.samplernn_weight_pack(cs.bf16_valued(torch, net))
    rf, q = net.rf, spec["q_levels"]
    for temp in (None, cs.TEMPERATURE):
        mode = "argmax" if temp is None else f"T={temp}"
        for kind, B, seed, key in (("decode_single", B_single, 2, 11),
                                   ("decode_chunk", B_chunk, 3, 13)):
            def tf(full, state, t, m, acc):
                state = state or sd.init_decode_state(net, full)
                _, s = sd.decode_plain(pack, full, state, t, m, t, m, key, temp,
                                       return_scores=True, accumulate=acc)
                return s, state

            prompt = cs.make_prompt(torch, B, 2 * rf, q, seed=seed)
            prior_t = prompt.shape[1]
            for who, p in (("bf16", pack), ("control", ctl)):
                if kind == "decode_single":
                    toks = sd.decode_single(p, prompt, n, key, temp)
                else:
                    toks = sd.decode_chunk(p, prompt, sd.init_decode_state(net, prompt), rf,
                                           prior_t + n - rf, key, temp)[:, prior_t - rf :]
                report(f"{size} {kind} B={B} {mode} {who}", prompt, toks, tf, rf)
            alt = sd.decode_plain(pack, prompt, sd.init_decode_state(net, prompt), rf,
                                  prior_t + n - rf, prior_t, n, key, temp,
                                  accumulate=torch.float64)
            report(f"{size} {kind} B={B} {mode} alt", prompt, alt, tf, rf)


def kv(spec, jitter, batches, n, size):
    net = cs.make_transformer(mmk, torch, td, spec, seed=1, jitter=jitter)
    pack = td.transformer_weight_pack(net, torch.bfloat16)
    ctl = td.transformer_weight_pack(cs.bf16_valued(torch, net))
    rf, q = spec["rf"], spec["q_levels"]
    for temp in (None, cs.TEMPERATURE):
        mode = "argmax" if temp is None else f"T={temp}"

        def tf(full, state, t, m, acc):
            state = state or tk.init_kv_state(pack, full)
            _, s = tk.decode_chunk_plain(pack, full.t().contiguous(), state, t, m, 13, temp,
                                         return_scores=True, accumulate=acc)
            return s, state

        for B in batches:
            prompt = cs.make_prompt(torch, B, rf, q, seed=5 + B)
            prior_t = prompt.shape[1]
            for who, p in (("bf16", pack), ("control", ctl)):
                toks = cs.kv_run(torch, tk, p, prompt, n, n + 63, temp, 13)
                report(f"{size} K7 B={B} {mode} {who}", prompt, toks, tf, 1)
            alt = tk.decode_chunk_plain(pack, prompt.t().contiguous(),
                                        tk.init_kv_state(pack, prompt), 1, prior_t + n - 1, 13,
                                        temp, accumulate=torch.float64)[:, prior_t - 1 :]
            report(f"{size} K7 B={B} {mode} alt", prompt, alt, tf, 1)


def main():
    if not torch.cuda.is_available():
        print("bf16_check_power: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sd.build_kernel()
    tk.build_kernel()
    print(cs.card_line(), flush=True)
    samplernn(cs.SMALL, 0.5, 4, 64, 300, "small")
    samplernn(cs.FULL, 0.0, 4, 256, 1024, "full")
    kv(cs.TF_SMALL, 0.5, cs.TF_KV_BATCHES, 150, "small")
    kv(cs.TF_FULL, 0.0, cs.TF_KV_BATCHES, 64, "full")
    return 0


if __name__ == "__main__":
    sys.exit(main())
