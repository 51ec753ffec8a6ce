"""FreqNet recipe (counterpart of ``mimikit_tpu/demos/freqnet.py``): WaveNet
over STFT magnitude frames, grouped convolutions, wide dims."""


def demo(sources=None, sample_rate=22050, db_path="train-freqnet.h5", device=None,
         **overrides):
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

    io = mmk.IOSpec.magspec_io(
        mmk.IOSpec.MagSpecIOConfig(
            sr=sample_rate, n_fft=2048, hop_length=512, activation="Identity"
        ),
        signal,
    )
    net = mmk.WaveNet.from_config(
        mmk.WaveNet.Config(
            io_spec=io,
            kernel_sizes=(2,),
            blocks=(3,),
            dims_dilated=(2048,),
            apply_residuals=False,
            residuals_dim=None,
            skips_dim=None,
            groups=8,
            act_f="Tanh",
            act_g="Sigmoid",
            pad_side=0,
            bias=True,
            use_fast_generate=False,
            tie_io_weights=False,
        ),
        device=device,
    )
    train_kwargs = dict(
        max_lr=1e-3,
        betas=(0.9, 0.9),
        div_factor=1.0,
        final_div_factor=1.0,
        pct_start=0.0,
        n_examples=4,
        prompt_length_sec=3.0,
        batch_size=16,
        tbptt_chunk_length=None,
        batch_length=64,
        downsampling=64,
        limit_train_batches=10000,
        max_epochs=300,
        every_n_epochs=10,
        outputs_duration_sec=60,
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
