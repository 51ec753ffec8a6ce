"""Where the seq2seq demo net's train step spends its time.

Usage, on a machine with one card: ``python3 tools/s2s_step_host.py``
(~1.5 min, the LSTM kernels' build included).  It trains
``mimikit_tpu/demos/seq2seq.py``'s net (1,025 STFT bins, model_dim 512, hop 4,
2 + 2 bidirectional layers) through ``TrainARMLoop`` at B=16 on 20 s of
``chip_smoke.spectral_wav``'s audio, f32 (the wide LSTM kernels) and under
``param_dtype="bfloat16"`` (the bf16 cluster kernels); one epoch of 8 steps
sets each loop up.  Then, in two rounds of both in turn, a window of 8 steps
cut at each layer of the step (CUDA events, the median of 3 windows a step,
beside the card's name and power limit; the batches of one pass over the
loader): the batches alone (the device batcher's gather and MagSpec), then
the forward and the loss, then the backward, then the whole step (the
optimizer's update too).  Last, one f32
window under ``cProfile``, its top 30 functions by own time and by
cumulative time.
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
    cs.spectral_wav(wav, seconds=20)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "db.h5"),
                           extractors=(mmk.Extractor.signal(sr=cs.SPECTRAL_SR),))
    ds.create(mode="w")

    def loop_for(param_dtype):
        net = cs.s2s_net(mmk, "cuda", seed=0, extractor=ds.extractors[0])
        kw = {"data_seed": 0, **({"param_dtype": param_dtype} if param_dtype else {})}
        cfg = mmk.TrainARMConfig(
            root_dir=os.path.join(work, f"tr_{param_dtype}"), batch_size=16, batch_length=4,
            max_epochs=1, limit_train_batches=STEPS, MONITOR_TRAINING=False,
            CHECKPOINT_TRAINING=False, max_lr=1e-3, betas=(0.9, 0.9), trainer_kwargs=kw)
        loop = mmk.TrainARMLoop.from_config(cfg, ds.get(mode="r"), net)
        loop.run()
        return loop

    passes = {}

    def window(loop, upto):
        """``STEPS`` batches of one pass over the loader (as an epoch takes
        them: a new pass shuffles every window's index), each taken through
        the step up to ``upto``."""
        batches = passes.setdefault(id(loop), loop._batches())
        for _ in range(STEPS):
            inputs, targets = next(batches)
            if upto == "batches":
                continue
            if upto == "step":
                loop.train_step(inputs, targets, None)
                continue
            outputs, _ = loop._apply_train(inputs, None)
            loss = loop.loss_fn(outputs, targets)["loss"]
            if upto == "backward":
                loss.backward()
                loop.opt.adam.zero_grad(set_to_none=True)

    loops = {"float32": loop_for(None), "bfloat16": loop_for("bfloat16")}
    for rnd in range(2):
        for name, loop in loops.items():
            for upto in ("batches", "forward", "backward", "step"):
                window(loop, upto)
                ms = [w / STEPS for w in cs.cuda_ms(torch, lambda: window(loop, upto), reps=3)]
                print(f"round {rnd} {name} up to {upto}: {statistics.median(ms):.3f} ms a step"
                      f" {ms} on {card}", flush=True)
    loop = loops["float32"]
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    window(loop, "step")
    torch.cuda.synchronize()
    prof.disable()
    for key in ("tottime", "cumulative"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(30)
        print(out.getvalue())


if __name__ == "__main__":
    main()
