"""Generate many outputs from a checkpoint and keep the ``k_bests`` whose
nearest-neighbor sequence in the training signal has the highest
cumulative entropy (counterpart of ``mimikit_tpu/demos/checkpoint_k_bests.py``).
The network decodes on ``device`` (default: the card)."""


def demo(
    root_dir="./",
    ckpt_id=None,
    epoch=1,
    n_trials=500,
    k_bests=10,
    output_duration_sec=30.0,
    prompts_position_sec=(1.1, 8.5, 46.3),
    batch_size=32,
    device=None,
):
    import numpy as np

    import mimikit_tpu_torch as mmk

    if ckpt_id is None:
        path = next(iter(mmk.FileWalker(mmk.CHECKPOINT_REGEX, root_dir)), None)
        if path is None:
            raise RuntimeError(f"no checkpoint found under {root_dir}")
        ckpt = mmk.Checkpoint.from_path(path, device=device)
    else:
        ckpt = mmk.Checkpoint(root_dir=root_dir, id=ckpt_id, epoch=epoch, device=device)

    dataset, network = ckpt.dataset, ckpt.network
    S = network.config.io_spec.inputs[0].transform(np.asarray(dataset.signal[:]))

    loop = mmk.GenerateLoopV2.from_config(
        mmk.GenerateLoopV2.Config(
            output_duration_sec=output_duration_sec,
            prompts_length_sec=1.0,
            prompts_position_sec=tuple(prompts_position_sec),
            batch_size=batch_size,
            display_waveform=False,
            yield_inversed_outputs=True,
        ),
        dataset,
        network,
    )
    saved = {}
    n_done = 0
    for outputs in loop.run():
        for out in np.asarray(outputs[0]):
            _, nn = mmk.nearest_neighbor(out[:, None] if out.ndim == 1 else out,
                                         S[:, None] if S.ndim == 1 else S)
            saved[float(mmk.cum_entropy(nn, neg_diff=False))] = out
            n_done += 1
        if n_done >= n_trials:
            break
    return [saved[k] for k in sorted(saved, reverse=True)[:k_bests]]
