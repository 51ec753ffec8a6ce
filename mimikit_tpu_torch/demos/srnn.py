"""SampleRNN training recipe (counterpart of ``mimikit_tpu/demos/srnn.py``):
a deep tier stack under weight norm, TBPTT over 8-second chunks, audio
monitoring during training."""


def demo(sources=None, sample_rate=16000, db_path="train-srnn.h5", device=None, **overrides):
    """Extract ``sources`` (default: every sound file under ``./``) into
    ``db_path``, build the recipe's net on ``device`` (default: the card) and
    train it; ``overrides`` replace the recipe's ``TrainARMConfig`` fields.
    Returns the finished ``TrainARMLoop``."""
    import os

    import mimikit_tpu_torch as mmk

    if sources is None:
        sources = tuple(mmk.FileWalker(mmk.SOUND_FILE_REGEX, "./"))
    if os.path.exists(db_path):
        os.remove(db_path)

    signal = mmk.Extractor(
        "signal",
        mmk.Compose(
            mmk.FileToSignal(sample_rate), mmk.RemoveDC(), mmk.Normalize()
        ),
    )
    ds = mmk.DatasetConfig(sources=sources, filename=db_path, extractors=(signal,))
    ds.create(mode="w")
    dataset = ds.get(mode="r")

    N = dataset.signal.shape[0]
    print(f"Dataset length in minutes is: {(N / sample_rate) / 60:.2f}")
    print("Extracted following files:")
    for f in dataset.index:
        print("\t", f)

    io = mmk.IOSpec.mulaw_io(
        extractor=signal,
        config=mmk.IOSpec.MuLawIOConfig(
            sr=sample_rate,
            compression=0.5,
            mlp_dim=128,
            n_mlp_layers=0,
            min_temperature=1e-3,
        ),
    )
    net = mmk.SampleRNN.from_config(
        mmk.SampleRNN.Config(
            rnn_class="lstm",
            n_rnn=1,
            rnn_dropout=0.0,
            frame_sizes=(256, 128, 64, 32, 16, 8, 4, 8),
            hidden_dim=128,
            weight_norm=True,
            io_spec=io,
        ),
        device=device,
    )
    train_kwargs = dict(
        max_lr=1e-3,
        betas=(0.9, 0.9),
        div_factor=1.0,
        final_div_factor=1.0,
        pct_start=0.0,
        temperature=(1.0, 0.75, 0.5, 0.1),
        n_examples=4,
        prompt_length_sec=1.0,
        batch_size=32,
        tbptt_chunk_length=8 * sample_rate,
        batch_length=2048,
        oversampling=4,
        limit_train_batches=None,
        max_epochs=2000,
        every_n_epochs=5,
        outputs_duration_sec=10,
        MONITOR_TRAINING=True,
        OUTPUT_TRAINING="",
        CHECKPOINT_TRAINING=True,
    )
    train_kwargs.update(overrides)
    loop = mmk.TrainARMLoop.from_config(
        mmk.TrainARMConfig(**train_kwargs), dataset, net
    )
    loop.run()
    return loop
