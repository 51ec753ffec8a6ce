"""The seeded event pattern both packages stream in
``tests/test_torch_ensemble.py``; it takes the package (``mimikit_tpu`` or
``mimikit_tpu_torch``) as its argument and imports neither."""


def ensemble_patterns(mmk):
    return mmk.Pseq([
        mmk.Pbind("a", mmk.Pwhite(0.0, 1.0, repeats=3, seed=1),
                  "b", mmk.Prand([1, 2, mmk.Pseq([8, 9], 1)], repeats=mmk.inf, seed=2)),
        mmk.Pbind("a", mmk.Pseq([5, 6], 2), "c", 7),
        mmk.Pbind("w", mmk.Pwhite(-2.0, 2.0, seed=3), "r", mmk.Prand(["x", "y"], 4, seed=4)),
    ], 2)
