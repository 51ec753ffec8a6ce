"""Where the recipe net's train step spends its time on the host.

Usage, on a machine with one card: ``python3 tools/recipe_step_host.py``
(~1.5 min, the LSTM kernels' build included).  It trains, through
``TrainARMLoop`` at B=32 x 2048 (TBPTT over 8 s, seeded batches, 20 s of
``chip_smoke.recipe_wav``'s audio), ``mimikit_tpu/demos/srnn.py``'s net
(frames (256, 128, 64, 32, 16, 8, 4, 8), hidden 128, a Mish head of 128)
with and without weight norm, and the same widths cut to its last three
frame sizes (8, 4, 8) with and without; one epoch of 8 steps sets each loop
up.  Then, in two rounds of the four in turn, the step as the loop runs it
(gather + step): 3 windows of 8 steps timed with CUDA events, the median a
step printed beside the card's name and power limit.  Last, one window of
the weight-normed eight-tier net under ``cProfile``, its top 35 functions by
own time and by cumulative time.
"""
import cProfile
import io
import os
import pstats
import statistics
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import mimikit_tpu_torch as mmk  # noqa: E402
from mimikit_tpu_torch.ops import fused_lstm as fl  # noqa: E402

STEPS = 8


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    fl.build_lstm_kernel()
    work = tempfile.mkdtemp()
    wav = os.path.join(work, "a.wav")
    cs.recipe_wav(wav, seconds=20)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "db.h5"),
                           extractors=(mmk.Extractor.signal(sr=16000),))
    ds.create(mode="w")

    def loop_for(wn, fs):
        io_ = mmk.IOSpec.mulaw_io(extractor=ds.extractors[0], config=mmk.IOSpec.MuLawIOConfig(
            sr=16000, compression=0.5, mlp_dim=128, n_mlp_layers=0, min_temperature=1e-3))
        net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(
            frame_sizes=fs, hidden_dim=128, weight_norm=wn, io_spec=io_), device="cuda", seed=0)
        cfg = mmk.TrainARMConfig(
            root_dir=os.path.join(work, f"tr_{wn}_{len(fs)}"), batch_size=32, batch_length=2048,
            tbptt_chunk_length=8 * 16000, max_epochs=1, limit_train_batches=STEPS,
            MONITOR_TRAINING=False, CHECKPOINT_TRAINING=False, max_lr=1e-3, betas=(0.9, 0.9),
            trainer_kwargs={"data_seed": 0})
        loop = mmk.TrainARMLoop.from_config(cfg, ds.get(mode="r"), net)
        loop.run()
        return loop

    def window(loop):
        hidden = None
        for k, (inputs, targets) in enumerate(loop._batches()):
            if k == STEPS:
                break
            _, hidden = loop.train_step(inputs, targets, hidden)

    fs = cs.RECIPE["frame_sizes"]
    loops = {(wn, n): loop_for(wn, fs[-n:]) for wn in (True, False) for n in (8, 3)}
    for rnd in range(2):
        for (wn, n), loop in loops.items():
            window(loop)
            ms = [w / STEPS for w in cs.cuda_ms(torch, lambda: window(loop), reps=3)]
            print(f"round {rnd} weight_norm={wn} tiers={n}: {statistics.median(ms):.3f} ms a"
                  f" step {ms} on {card}", flush=True)
    loop = loops[(True, 8)]
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    window(loop)
    torch.cuda.synchronize()
    prof.disable()
    for key in ("tottime", "cumulative"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(35)
        print(out.getvalue())


if __name__ == "__main__":
    main()
