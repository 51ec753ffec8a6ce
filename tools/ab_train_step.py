"""Time the SampleRNN-3 train step of one checkout, f32 and under the bf16 policy.

Usage, on a machine with one card: ``python3 tools/ab_train_step.py <root>``
for two checkouts in turns (old, new, new, old), so that both run on one
card; unpack the parent with ``git archive HEAD | tar -x -C build/parent``.
It trains ``<root>``'s ``mimikit_tpu_torch`` as ``chip_smoke.py``'s phase 4
does (bench.py's mu-law SampleRNN-3, random weights from seed 0; 60 s of
16 kHz two-tone audio; ``TrainARMLoop`` at B=32 x 2048 with TBPTT over
8 x 2048 samples, seeded batches), with ``trainer_kwargs={"param_dtype":
...}`` float32 and then bfloat16: one epoch of 8 steps to set the loop up,
then the step as the loop runs it (gather + step), 7 windows of 8 steps
timed with CUDA events.  It prints one JSON line: per policy the median ms
a step and every window's, and the card's name and power limit.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)

import mimikit_tpu_torch as mmk  # noqa: E402

B, LEN, STEPS, WINDOWS, SEED = 32, 2048, 8, 7, 1234


def dataset(work):
    from scipy.io import wavfile

    sr = 16000
    t = np.arange(sr * 60) / sr
    y = (0.6 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 587 * t)).astype(np.float32)
    wav = os.path.join(work, "s.wav")
    wavfile.write(wav, sr, (y * 32767).astype(np.int16))
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "db.h5"),
                           extractors=(mmk.Extractor.signal(sr=sr),))
    return ds, ds.create(mode="w")


def step_ms(ds, db, work, dtype):
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=256, mlp_dim=256),
                             extractor=ds.extractors[0])
    net = mmk.SampleRNN.from_config(
        mmk.SampleRNN.Config(frame_sizes=(16, 8, 8), hidden_dim=256, io_spec=io),
        device="cuda", seed=0)
    cfg = mmk.TrainARMConfig(
        root_dir=os.path.join(work, dtype), batch_size=B, batch_length=LEN,
        tbptt_chunk_length=8 * LEN, max_epochs=1, limit_train_batches=STEPS,
        MONITOR_TRAINING=False, CHECKPOINT_TRAINING=False,
        trainer_kwargs={"data_seed": SEED, "param_dtype": dtype},
    )
    loop = mmk.TrainARMLoop.from_config(cfg, db, net)
    loop.run()

    def window():
        hidden = None
        for k, (inputs, targets) in enumerate(loop._batches()):
            if k == STEPS:
                break
            _, hidden = loop.train_step(inputs, targets, hidden)

    window()
    out = []
    for _ in range(WINDOWS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        window()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / STEPS)
    return {"median_ms": statistics.median(out), "windows_ms": out}


def main():
    work = os.path.join(ROOT, "build", "ab_train_step")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ds, db = dataset(work)
    res = {"root": ROOT}
    for dtype in ("float32", "bfloat16"):
        res[dtype] = step_ms(ds, db, work, dtype)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
