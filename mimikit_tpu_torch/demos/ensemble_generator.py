"""Ensemble generation recipe (counterpart of
``mimikit_tpu/demos/ensemble_generator.py``): every checkpoint under
``root_dir`` reopened on ``device`` (default: the card), three prompts of
one second of the first checkpoint's dataset, and the recipe's event
pattern (``models/patterns.py``: the first checkpoint for 3-5 s argmax,
the second for 0.1-1 s at a temperature in [0.25, 1.5], in turn) chained
by ``EnsembleGenerator``; pass your own ``stream`` to override it."""


def demo(root_dir="./", total_seconds=10.0, output_sr=22050, stream=None, device=None):
    import mimikit_tpu_torch as mmk

    checkpoints = {}
    for i, path in enumerate(mmk.FileWalker(mmk.CHECKPOINT_REGEX, root_dir)):
        checkpoints[i] = mmk.Checkpoint.from_path(path, device=device)
    if not checkpoints:
        raise RuntimeError(f"no checkpoints found under {root_dir}")

    db = checkpoints[0].dataset
    prompt_positions = (0, output_sr // 2, output_sr)
    prompt_length = output_sr

    prompts = next(iter(db.serve(
        (mmk.Input(data="signal", getter=mmk.AsSlice(shift=0, length=prompt_length)),),
        shuffle=False,
        batch_size=len(prompt_positions),
        sampler=mmk.IndicesSampler(indices=prompt_positions, N=len(prompt_positions),
                                   max_i=db.signal.shape[0] - prompt_length),
    )))[0]

    if stream is None:
        keys = sorted(checkpoints)
        binds = [mmk.Pbind("generator", checkpoints[keys[0]],
                           "seconds", mmk.Pwhite(lo=3.0, hi=5.0, repeats=1, seed=42))]
        if len(keys) > 1:
            binds.append(mmk.Pbind(
                "generator", checkpoints[keys[1]],
                "temperature", mmk.Pwhite(lo=0.25, hi=1.5, seed=43),
                "seconds", mmk.Pwhite(lo=0.1, hi=1.0, repeats=1, seed=44),
            ))
        stream = mmk.Pseq(binds, mmk.inf).asStream()

    ensemble = mmk.EnsembleGenerator(prompts, total_seconds, output_sr, stream,
                                     print_events=False)
    outputs = ensemble.run()
    mmk.AudioLogger(sr=output_sr).display_batch(outputs)
    return outputs
