#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mimikit_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and ``nvcc``; it imports nothing of JAX or of ``mimikit_tpu``.

Phases (any failure exits non-zero; no exception is swallowed):

1. environment and build: the card's name and power limit, torch/CUDA
   versions; build ``csrc/samplernn_decode.cu`` for sm_90a and time it;
2. kernel against its plain twin, for ``decode_single`` and
   ``decode_chunk``, argmax and sampled (temperature 0.9), at a small size
   and at the main path's widths.  The kernel's tokens are verified by
   teacher forcing: fed back as the prompt of the plain PyTorch twin, every
   kernel token must score within 1e-4 * max|score| of its row's maximum,
   and the free-running plain tokens must equal the kernel's up to the
   first such near-tie.  Several chunk lengths and stream groupings must
   give identical tokens;
3. the main path at full width (bench.py's mu-law SampleRNN-3: frame_sizes
   (16, 8, 8), hidden 256, q 256, a two-layer Mish head; random weights from
   a seed): ``generate`` with B=4 (decode_single's route) and with B=256 for
   16384 steps at temperature 0.9 (decode_chunk's route), median of 3 with
   spread, the B=256 output itself verified as in phase 2; ``stream_audio``
   over 1600-step chunks, which must equal that output mu-law expanded; each
   wrapper and its plain twin timed on one call at the main path's shapes;
4. a ``kernels`` JSON line, the card line, and the device line last.

``--quick`` runs phases 1-2 at the small size only (a build check);
``--bench`` runs phase 1 and phase 3's timings without the checks, plus
decode_chunk at B=256 for each number of streams a block owns.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit):
# f32 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FULL = dict(frame_sizes=(16, 8, 8), hidden_dim=256, q_levels=256, mlp_dim=256)
SMALL = dict(frame_sizes=(8, 4, 2), hidden_dim=32, q_levels=32, mlp_dim=32)
TEMPERATURE = 0.9
TOL = 1e-4  # a kernel token must score within TOL * max|score| of the row max
N_SMALL, N_WIDE, STREAM_CHUNK, SEED = 4096, 16384, 1600, 1234


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def make_net(mmk, torch, spec, seed, jitter=0.0):
    io = mmk.IOSpec.mulaw_io(
        mmk.IOSpec.MuLawIOConfig(q_levels=spec["q_levels"], mlp_dim=spec["mlp_dim"])
    )
    cfg = mmk.SampleRNN.Config(
        frame_sizes=spec["frame_sizes"], hidden_dim=spec["hidden_dim"], io_spec=io
    )
    net = mmk.SampleRNN.from_config(cfg, device="cuda", seed=seed).eval()
    if jitter:
        # random-init nets can collapse to one argmax token; jittered weights
        # keep the trajectories varied so the token checks exercise every tier
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g).to(p.device) * jitter)
    if not mmk.supports_kernel_decode(net):
        raise AssertionError("the decode kernel's gate refused the net")
    return net


def make_prompt(torch, B, T, q, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, q, (B, T), generator=g, dtype=torch.int32).cuda()


def verify(torch, sd, net, prompt, toks, seed, temperature, tf_chunk=1024):
    """Teacher-forced check of kernel tokens ``toks`` (B, n) decoded after
    ``prompt``.  Returns (the largest score gap of a kernel token below its
    row's maximum, the number of streams where the free-running plain decode
    parted from the kernel's at a near-tie).  Raises when a token is outside
    the tolerance, or when the free-running plain tokens differ before the
    stream's first near-tie."""
    B, prior_t = prompt.shape
    n, rf = toks.shape[1], net.rf
    full = torch.cat([prompt, toks.to(torch.int32)], 1).contiguous()
    state = sd.init_decode_state(net, full)
    worst = 0.0
    near_tie = torch.full((B,), n, dtype=torch.long, device=toks.device)
    t = rf
    while t < prior_t + n:
        m = min(tf_chunk, prior_t + n - t)
        _, scores = sd.decode_plain(net, full, state, t, m, t, m, seed, temperature,
                                    return_scores=True)
        lo = max(t, prior_t)
        if lo < t + m:
            s = scores[lo - t :]                           # (k, B, Q)
            tok = full[:, lo : t + m].T.long()             # (k, B)
            top2 = s.topk(2, dim=-1).values
            tol = TOL * s.abs().amax(-1)
            gap = top2[..., 0] - s.gather(-1, tok[..., None])[..., 0]
            bad = gap > tol
            if bool(bad.any()):
                k, b = (int(v) for v in bad.nonzero()[0])
                raise AssertionError(
                    f"kernel token at step {lo + k}, stream {b}: {float(gap[k, b]):.3e}"
                    f" below the row max (tolerance {float(tol[k, b]):.3e})"
                )
            worst = max(worst, float(gap.max()))
            ties = (top2[..., 0] - top2[..., 1]) <= tol    # (k, B)
            first = torch.where(
                ties.any(0), ties.long().argmax(0) + (lo - prior_t),
                torch.full_like(near_tie, n),
            )
            near_tie = torch.minimum(near_tie, first)
        t += m
    state = sd.init_decode_state(net, prompt)
    plain = sd.decode_plain(net, prompt, state, rf, prior_t + n - rf, prior_t, n, seed,
                            temperature)
    diff = plain != toks
    first_diff = torch.where(diff.any(1), diff.long().argmax(1), torch.full_like(near_tie, n))
    early = first_diff < near_tie
    if bool(early.any()):
        b = int(early.nonzero()[0])
        raise AssertionError(
            f"stream {b}: plain and kernel tokens differ at step {int(first_diff[b])},"
            f" before the first near-tie (step {int(near_tie[b])})"
        )
    return worst, int((first_diff < n).sum())


def check_kernels(torch, mmk, sd, spec, B_single, B_chunk, n, chunk_lens, jitter):
    """Phase 2 at one size; returns {wrapper: largest score gap}."""
    net = make_net(mmk, torch, spec, seed=1, jitter=jitter)
    pack = sd.samplernn_weight_pack(net)
    rf, q = net.rf, spec["q_levels"]
    err = {"decode_single": 0.0, "decode_chunk": 0.0}
    for temp in (None, TEMPERATURE):
        mode = "argmax" if temp is None else f"T={temp}"
        # decode_single: the whole decode in one launch
        prompt = make_prompt(torch, B_single, 2 * rf, q, seed=2)
        toks = sd.decode_single(pack, prompt, n, 11, temp)
        torch.cuda.synchronize()
        if spec is SMALL:
            for g in (1, 2, 4, 8):
                other = sd.decode_single(pack, prompt, n, 11, temp, group=g)
                if not torch.equal(other, toks):
                    raise AssertionError(f"decode_single group={g} changed the tokens")
            if temp is None and len(set(toks[0].tolist())) < 2:
                raise AssertionError("argmax tokens are constant: the check is vacuous")
        gap, parted = verify(torch, sd, net, prompt, toks, 11, temp)
        err["decode_single"] = max(err["decode_single"], gap)
        log(f"  decode_single B={B_single} n={n} {mode}: ok, max gap {gap:.3e},"
            f" {parted} streams parted at near-ties")
        # decode_chunk: the state carried across launches of several lengths
        prompt = make_prompt(torch, B_chunk, 2 * rf, q, seed=3)
        prior_t = prompt.shape[1]
        runs = []
        for C in chunk_lens:
            state = sd.init_decode_state(net, prompt)
            parts = [
                sd.decode_chunk(pack, prompt, state, t0, min(C, prior_t + n - t0), 13, temp)
                for t0 in range(rf, prior_t + n, C)
            ]
            runs.append(torch.cat(parts, 1)[:, prior_t - rf :])
        torch.cuda.synchronize()
        for C, r in zip(chunk_lens[1:], runs[1:]):
            if not torch.equal(r, runs[0]):
                raise AssertionError(f"decode_chunk with chunk {C} changed the tokens")
        gap, parted = verify(torch, sd, net, prompt, runs[0], 13, temp)
        err["decode_chunk"] = max(err["decode_chunk"], gap)
        log(f"  decode_chunk B={B_chunk} n={n} chunks {chunk_lens} {mode}: ok,"
            f" max gap {gap:.3e}, {parted} streams parted at near-ties")
    return err


def cuda_ms(torch, fn, reps):
    """Milliseconds of ``fn()`` by CUDA events, one per rep."""
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def decode_bound(pack, B, prior_t, t0, n, out_len):
    """(bound_ms, bound_by) for one decode call: the larger of its f32
    operations over the card's f32 rate and its bytes (each input read once,
    each output written once) over the memory rate."""
    fs, up, H = pack.frame_sizes, pack.up_factors, pack.hidden_dim
    steps = range(t0, t0 + n)
    mac = n * (fs[-1] * H + sum(i * o for i, o in pack.head_dims))
    for i in range(len(fs) - 1):
        fires = sum(1 for t in steps if t % fs[i] == 0)
        mac += fires * (fs[i] * H + 2 * H * 4 * H + H * up[i] * H)
    flops = 2.0 * mac * B
    state = 4 * B * (fs[0] + 2 * (len(fs) - 1) * H + sum(up) * H)
    nbytes = 4 * pack.flat.numel() + 4 * B * prior_t + 2 * state + 4 * B * out_len
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def spread(xs):
    med = statistics.median(xs)
    return med, (max(xs) - min(xs)) / med


def main_path(torch, mmk, net, p4, p256):
    """Time the user entry points at full width; returns the generated
    buffers {B: (B, prior_t + n)}."""
    q = FULL["q_levels"]
    log(f"  SampleRNN-3: {net.n_parameters} parameters")
    outs = {}
    for B, prompt, n in ((4, p4, N_SMALL), (256, p256, N_WIDE)):
        net.generate((prompt,), 64, temperature=TEMPERATURE, seed=SEED)  # lazy set-up

        def run():
            outs[B] = net.generate((prompt,), n, temperature=TEMPERATURE, seed=SEED)[0]

        ms = cuda_ms(torch, run, reps=3)
        med, spr = spread(ms)
        toks = outs[B][:, prompt.shape[1]:]
        if toks.shape != (B, n) or int(toks.min()) < 0 or int(toks.max()) >= q:
            raise AssertionError(f"generate B={B}: bad tokens {tuple(toks.shape)}")
        if len(set(toks[0].tolist())) < 2:
            raise AssertionError(f"generate B={B}: constant sampled tokens")
        log(f"  generate B={B} n={n} T={TEMPERATURE}: {B * n / (med / 1e3):.6g} samples/s"
            f" (median of 3: {med:.3f} ms, spread {spr:.3%}; {ms})")

    lat, audio = [], []
    it = mmk.stream_audio(net, (p256,), STREAM_CHUNK, temperature=TEMPERATURE, seed=SEED)
    t = time.perf_counter()
    for _ in range(12):
        audio.append(next(it))
        now = time.perf_counter()
        lat.append(1e3 * (now - t))
        t = now
    it.close()
    # noise is keyed by absolute step: the stream must be generate's decode,
    # mu-law expanded, chunk for chunk (this holds the read-behind copies too)
    n_cmp = (N_WIDE // STREAM_CHUNK) * STREAM_CHUNK
    toks = outs[256][:, p256.shape[1] : p256.shape[1] + n_cmp].cpu().numpy()
    ref = mmk.MuLawExpand(FULL["q_levels"])(toks)
    got = np.concatenate(audio, axis=1)[:, :n_cmp]
    if got.shape != ref.shape or not np.array_equal(got, ref):
        raise AssertionError("stream_audio differs from the expanded generate output")
    lat_s = sorted(lat)
    log(f"  stream_audio B=256, 12 chunks of {STREAM_CHUNK} steps (equal to the expanded"
        f" generate output): per-chunk ms p50"
        f" {statistics.median(lat):.3f}, p95 {lat_s[int(0.95 * (len(lat) - 1) + 0.5)]:.3f},"
        f" max {max(lat):.3f} (first {lat[0]:.3f}); {lat}")
    return outs


def bench(torch, mmk, sd):
    """--bench: the main path's timings, and decode_chunk at B=256 for each
    number of streams a block can own."""
    net = make_net(mmk, torch, FULL, seed=0)
    rf = net.rf
    p4, p256 = (make_prompt(torch, B, 2 * rf, FULL["q_levels"], seed=B) for B in (4, 256))
    main_path(torch, mmk, net, p4, p256)
    pack = sd.samplernn_weight_pack(net)
    for g in (1, 2, 4, 8):
        ms = cuda_ms(torch, lambda: sd.decode_chunk(
            pack, p256, sd.init_decode_state(net, p256), rf, net._CHUNK, SEED, TEMPERATURE,
            group=g), reps=3)
        med, spr = spread(ms)
        log(f"  decode_chunk B=256 steps={net._CHUNK} group={g}: {med:.3f} ms"
            f" (median of 3, spread {spr:.3%})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true", help="phases 1-2 at the small size only")
    mode.add_argument("--bench", action="store_true",
                      help="phase 1 and the main path's timings only, no checks")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import mimikit_tpu_torch as mmk
    from mimikit_tpu_torch.ops import samplernn_decode as sd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 -------------------------------------------------------------
    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" python {sys.version.split()[0]}")
    t = time.perf_counter()
    sd.build_kernel()
    build_s = time.perf_counter() - t
    for line in sd._Kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    log(f"  built {sd.SOURCE.name} for sm_90a in {build_s:.1f} s")

    if args.bench:
        bench(torch, mmk, sd)
        log(card)
        return 0

    # -- phase 2 -------------------------------------------------------------
    log("phase 2: kernel against its plain twin")
    err = check_kernels(torch, mmk, sd, SMALL, 4, 64, 300, (300 + 16, 7, 64), jitter=0.5)
    if args.quick:
        log(json.dumps({"ok": True, "quick": True, "max_gap": err}))
        return 0
    err_full = check_kernels(torch, mmk, sd, FULL, 4, 256, 2048, (2048 + 32, 700, 1600),
                             jitter=0.0)
    err = {k: max(err[k], err_full[k]) for k in err}

    # -- phase 3 -------------------------------------------------------------
    log("phase 3: the main path at full width")
    net = make_net(mmk, torch, FULL, seed=0)
    rf = net.rf
    p4, p256 = (make_prompt(torch, B, 2 * rf, FULL["q_levels"], seed=B) for B in (4, 256))
    sd.decode_single.launches = 0
    sd.decode_chunk.launches = 0
    outs = main_path(torch, mmk, net, p4, p256)
    gap, parted = verify(torch, sd, net, p256, outs[256][:, p256.shape[1]:], SEED, TEMPERATURE)
    err["decode_chunk"] = max(err["decode_chunk"], gap)
    log(f"  generate B=256 output verified: max gap {gap:.3e}, {parted} streams parted at"
        f" near-ties")
    launches = {"decode_single": sd.decode_single.launches,
                "decode_chunk": sd.decode_chunk.launches}
    log(f"  launches on the main path: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")

    # each wrapper, and its plain twin, on one call at the main path's shapes
    pack = sd.samplernn_weight_pack(net)
    calls = {
        "decode_single": (p4, lambda: sd.decode_single(pack, p4, N_SMALL, SEED, TEMPERATURE),
                          lambda: sd.decode_plain(net, p4, sd.init_decode_state(net, p4), rf,
                                                  p4.shape[1] + N_SMALL - rf, p4.shape[1],
                                                  N_SMALL, SEED, TEMPERATURE),
                          rf, p4.shape[1] + N_SMALL - rf, N_SMALL),
        "decode_chunk": (p256, lambda: sd.decode_chunk(pack, p256, sd.init_decode_state(net, p256),
                                                       rf, net._CHUNK, SEED, TEMPERATURE),
                         lambda: sd.decode_plain(net, p256, sd.init_decode_state(net, p256), rf,
                                                 net._CHUNK, rf, net._CHUNK, SEED, TEMPERATURE),
                         rf, net._CHUNK, net._CHUNK),
    }
    source = "mimikit_tpu_torch/csrc/samplernn_decode.cu"
    replaces = {"decode_single": "mimikit_tpu/ops/pallas_decode.py:148",
                "decode_chunk": "mimikit_tpu/ops/pallas_decode.py:868"}
    rows = []
    for name, (prompt, kern, plain, t0, n, out_len) in calls.items():
        k_ms, _ = spread(cuda_ms(torch, kern, reps=3))
        p_ms = cuda_ms(torch, plain, reps=1)[0]
        bound, by = decode_bound(pack, prompt.shape[0], prompt.shape[1], t0, n, out_len)
        log(f"  {name} B={prompt.shape[0]} steps={n}: kernel {k_ms:.3f} ms (median of 3),"
            f" plain twin {p_ms:.3f} ms, bound {bound:.3f} ms by {by}")
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces[name],
            launches=launches[name], max_abs_err=err[name], ms=k_ms, plain_ms=p_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
        ))

    # -- phase 4 -------------------------------------------------------------
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
