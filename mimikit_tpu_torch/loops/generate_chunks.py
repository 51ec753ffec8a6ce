"""Chunked long-form generation (counterpart of
``mimikit_tpu/loops/generate_chunks.py``): fixed-length generations in a
loop, each chunk's prompt the tail of the track so far, the tracks stored in
an h5 file, with a random walk of the temperatures.

Files go through the port's :mod:`..data.h5` (HDF5 through h5py where it is
installed, else its npz container).  Like the JAX package, the module is not
in the flat namespace: import it as ``mimikit_tpu_torch.loops.generate_chunks``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["generate_chunks", "main"]


def generate_chunks(
    checkpoint,
    out_filename: str = "chunked_outputs.h5",
    batch_size: int = 64,
    n_chunks: int = 10,
    chunk_seconds: float = 30.0,
    prompt_seconds: float = 5.0,
    temp_lo: float = 0.85,
    temp_hi: float = 0.999,
    positions=None,
    seed: int = 0,
):
    """Generate ``n_chunks`` x ``chunk_seconds`` continuations a stream from
    ``checkpoint``'s network and dataset.  The file holds the prompts under
    ``"0"`` and chunk i's new tokens under ``str(i)``; returns the (B,
    prompt + (n_chunks - 1) * chunk) tokens.  Positions (where not given)
    and temperatures are drawn from ``RandomState(seed)`` as in the JAX
    package, so both draw the same ones."""
    from ..data import h5
    from .generate import GenerateLoopV2

    rng = np.random.RandomState(seed)
    dataset, network = checkpoint.dataset, checkpoint.network
    feature = checkpoint.network_config.io_spec.targets[0]
    sr = feature.sr
    prompt_len = int(sr * prompt_seconds)

    if positions is None:
        max_i = dataset.signal.shape[0] - prompt_len
        positions = rng.randint(0, max_i, size=batch_size)
    temperature = rng.uniform(temp_lo, temp_hi, size=batch_size)

    config = GenerateLoopV2.Config(
        output_duration_sec=chunk_seconds,
        prompts_length_sec=prompt_seconds,
        prompts_position_sec=tuple(float(p) / sr for p in positions),
        batch_size=batch_size,
        downsampling=getattr(checkpoint.training_config, "downsampling", 1),
        display_waveform=False,
        yield_inversed_outputs=False,
        parameters=dict(temperature=temperature),
    )
    seed_batch = next(iter(GenerateLoopV2.get_dataloader(config, dataset, network)))
    tracks = np.asarray(seed_batch[1])

    with h5.File(out_filename, "w") as f:
        f.create_dataset("0", data=tracks)
        for i in range(1, n_chunks):
            prompts = tracks[:, -prompt_len:]
            # temperature random walk, clipped to the working range
            temperature = np.clip(temperature + rng.randn(batch_size) * 0.1, temp_lo, temp_hi)
            config.parameters["temperature"] = temperature
            loop = GenerateLoopV2(config, network, int(sr * chunk_seconds),
                                  [[np.ones(1), prompts]])
            for output in loop.run():
                new = np.asarray(output[0])[:, prompt_len:]
                tracks = np.concatenate([tracks, new], axis=1)
                f.create_dataset(str(i), data=new)
                break
            f.flush()
    return tracks


def main():
    """Script-style entry, as the JAX package's: epoch 20 of the bank
    ``./trainings/srnn_1min_chunk``, its tracks shown by an ``AudioLogger``."""
    from ..checkpoint import Checkpoint
    from .logger import AudioLogger

    ckpt = Checkpoint(root_dir="./trainings", id="srnn_1min_chunk", epoch=20)
    tracks = generate_chunks(ckpt)
    feature = ckpt.network_config.io_spec.targets[0]
    logger = AudioLogger(sr=feature.sr)
    for track in tracks:
        logger.display(feature.inv(track))
