"""How well the bf16 LSTM check tells the bf16 kernels from a faulty one.

Usage, on a machine with one card: ``python3 tools/bf16_lstm_check_power.py``
(about a minute).  It runs the cases of ``chip_smoke.py``'s phase 2 for the
bf16 instantiation of the fused LSTM layer (K3a/K3b): (T, B, H) = (12, 4, 16)
at eight input seeds, and the two tier shapes of the training path, (128,
32, 256) and (256, 32, 256), at two, with three sources against the bf16 twin
on the card:

* ``bf16``: the layer through the bf16 kernels (the route under test), and
  ``bf16 forward on 8`` / ``on 16``: the same with the forward on clusters of
  that size (``lstm_forward(..., cl=)``, as chip_smoke's phase 2 runs it);
* ``control``: the f32 instantiation on the bf16 streams' values, outputs
  rounded where stored: kernels that skip the rounding of h and dz (the
  fault the check must catch, ``chip_smoke.unrounded``);
* ``alt``: the bf16 twin on the CPU (a correct computation that sums in
  another order).

With ``--wide`` it runs the wide kernels' cases instead (K3a-wide, K3b-wide:
``chip_smoke.LSTM_WIDE_BF16_SHAPES`` at input seeds T + H + 1 + s for s = 0
to 5, s = 0 being chip_smoke's own case), without the cluster sizes, and
ends with each source's range per tensor over those cases: what
``chip_smoke.BF16_LSTM_WIDE_SHARES`` is set between.  With ``--s2s`` it runs
the seq2seq demo net's bf16 cases (``chip_smoke.LSTM_S2S_BF16_SHAPES``: T = 4,
B = 16, H = 512 on the cluster kernels, the forward on each cluster size
that takes H) at the same six seeds each, and ends with the same ranges:
what ``chip_smoke.BF16_LSTM_S2S_SHARES`` is set between.

Per case and source it prints the largest gap over the outputs and the six
gradients in bf16 ulps of each tensor's scale, the share of the case's
elements that differ from the twin, and each tensor's gap: what
``chip_smoke.bf16_lstm_verdict`` holds against ``BF16_LSTM_ULPS`` and
``BF16_LSTM_SHARE``.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from mimikit_tpu_torch.ops import fused_lstm as fl  # noqa: E402

CASES = [((12, 4, 8, 16), seed) for seed in range(8)] + [
    ((T, 32, 256, 256), seed) for T in (128, 256) for seed in range(2)]


def line(tag, source, gaps, ranges=None):
    if ranges is not None:
        for n, g in gaps.items():
            lo, hi = ranges.setdefault((source, n), (1.0, 0.0))
            ranges[source, n] = (min(lo, g[1] / g[2]), max(hi, g[1] / g[2]))
    worst = max(g[0] for g in gaps.values())
    share = sum(g[1] for g in gaps.values()) / sum(g[2] for g in gaps.values())
    each = ", ".join(f"{n} {g[0]:.2f}/{g[1] / g[2]:.1%}" for n, g in gaps.items())
    print(f"{tag} {source}: largest {worst:.3f} ulps, {share:.3%} of elements differ"
          f" ({each})", flush=True)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    wide, s2s = "--wide" in sys.argv[1:], "--s2s" in sys.argv[1:]
    shapes = cs.LSTM_S2S_BF16_SHAPES if s2s else cs.LSTM_WIDE_BF16_SHAPES
    ranged = wide or s2s
    cases = ([(s, T + H + 1 + seed) for s in shapes for seed in range(6)
              for T, _, _, H in (s,)] if ranged else [(s, 1000 + seed) for s, seed in CASES])
    ranges = {} if ranged else None
    for (T, B, D, H), seed in cases:
        tag = f"(T, B, H) = ({T}, {B}, {H}) seed {seed}"
        args, cts = cs.lstm_bf16_inputs(torch, T, B, D, H, seed=seed)
        gaps, _, (p_out, p_grads) = cs.lstm_bf16_gaps(torch, fl, args, cts)
        line(tag, "bf16", gaps, ranges)
        for cl in () if wide else cs.fwd_cluster_sizes(torch, fl, B, H, torch.bfloat16):
            line(tag, f"bf16 forward on {cl}",
                 cs.lstm_bf16_gaps(torch, fl, args, cts, fwd_cl=cl)[0])
        bad, _, _ = cs.lstm_bf16_gaps(torch, fl, args, cts, control=True)
        line(tag, "control", bad, ranges)
        c_out, c_grads = cs.lstm_plain_layer(torch, fl, tuple(a.cpu() for a in args),
                                             tuple(c.cpu() for c in cts))
        alt = {n: (*cs.bf16_ulps(c.cuda(), p), p.numel())
               for n, c, p in zip(cs.LSTM_NAMES, (*c_out, *c_grads), (*p_out, *p_grads))}
        line(tag, "alt", alt, ranges)
    for source in ("bf16", "alt", "control") if ranged else ():
        print(f"{source} over the {'seq2seq' if s2s else 'wide'} cases, share of each"
              " tensor's elements that differ: "
              + ", ".join(f"{n} {ranges[source, n][0]:.2%}-{ranges[source, n][1]:.2%}"
                          for n in cs.LSTM_NAMES), flush=True)


if __name__ == "__main__":
    main()
