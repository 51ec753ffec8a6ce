"""Serving recipe (counterpart of ``mimikit_tpu/demos/serving.py``): train
briefly, then stream unbounded audio in bounded-latency chunks, and fan a
batch of streams out across every device.

Two APIs this demo exercises:

* ``mmk.stream_audio(net, prompts, chunk_steps)`` — an endless generator of
  audio chunks; SampleRNN streams through its state-carrying decode kernel
  (the concatenated stream equals one long decode);
* ``mmk.parallel.sharded_generate(net, prompts, n_steps, devices=...)`` —
  a batch of streams decoded across devices (a copy of the net on each,
  the slices launched back to back, no collectives).
"""


def demo(sources=None, sample_rate=16000, db_path="train-serving.h5",
         n_chunks=10, chunk_seconds=0.1, device=None, **overrides):
    """Extract ``sources`` (default: every sound file under ``./``), train the
    recipe's small net on ``device`` (default: the card; ``"cpu"`` runs it
    all on the CPU, over two CPU devices for the sharded call), stream
    ``n_chunks`` chunks of ``chunk_seconds`` and decode a batch of streams
    sharded over every CUDA device.  ``overrides`` replace the recipe's
    ``TrainARMConfig`` fields.  Returns (the streamed audio, the sharded
    call's outputs)."""
    import os

    import numpy as np
    import torch

    import mimikit_tpu_torch as mmk

    if sources is None:
        sources = tuple(mmk.FileWalker(mmk.SOUND_FILE_REGEX, "./"))
    if os.path.exists(db_path):
        os.remove(db_path)

    signal = mmk.Extractor.signal(sr=sample_rate)
    ds = mmk.DatasetConfig(
        sources=sources, filename=db_path, extractors=(signal,)
    )
    ds.create(mode="w")
    dataset = ds.get(mode="r")

    io = mmk.IOSpec.mulaw_io(
        extractor=signal,
        config=mmk.IOSpec.MuLawIOConfig(sr=sample_rate, mlp_dim=128),
    )
    net = mmk.SampleRNN.from_config(
        mmk.SampleRNN.Config(
            frame_sizes=(16, 8, 8), hidden_dim=128, io_spec=io
        ),
        device=device,
    )
    train = dict(
        batch_size=16,
        batch_length=1024,
        tbptt_chunk_length=sample_rate,
        max_epochs=4,
        max_lr=2e-3,
        every_n_epochs=100,
        MONITOR_TRAINING=False,
        OUTPUT_TRAINING="",
        CHECKPOINT_TRAINING=False,
        root_dir="trainings-serving",
    )
    train.update(
        {k: v for k, v in overrides.items() if k in mmk.TrainARMConfig.__dataclass_fields__}
    )
    loop = mmk.TrainARMLoop.from_config(
        mmk.TrainARMConfig(**train), dataset, net
    )
    loop.run()

    # --- unbounded low-latency streaming -----------------------------------
    prompt = np.asarray(dataset.signal[: sample_rate // 4])
    tokens = mmk.MuLawCompress(io.inputs[0].elem_type.size)(prompt)
    chunk_steps = int(chunk_seconds * sample_rate)
    stream = mmk.stream_audio(net, (tokens[None, :].astype(np.int32),),
                              chunk_steps, temperature=0.7)
    chunks = [next(stream) for _ in range(n_chunks)]
    stream.close()
    audio = np.concatenate([np.asarray(c[0]) for c in chunks])
    print(f"streamed {len(chunks)} chunks = {len(audio) / sample_rate:.2f} s "
          f"of audio at {chunk_seconds * 1e3:.0f} ms/chunk granularity")

    # --- batch-of-streams sharded across every device ----------------------
    if net.device.type == "cpu":
        devices = [torch.device("cpu")] * 2
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    B = max(len(devices), 2) * 2
    prompts = (np.tile(tokens[None, :], (B, 1)).astype(np.int32),)
    outs = mmk.parallel.sharded_generate(
        net, prompts, chunk_steps, temperature=0.7, devices=devices
    )
    print(f"decoded {B} streams across {len(devices)} device(s): "
          f"{outs[0].shape}")
    return audio, outs
