"""Hold the port's XLA-ordered product to jax.lax.dot on this CPU.

Usage, on the CPU, from the root of a checkout (~1 min):
``python tools/xla_dot_order.py``.  ``mimikit_tpu_torch/modules/rounding.py``
computes the bf16 training path's products on CPU tensors in the order XLA's
CPU backend sums them (``matmul``, its rule ``_dot_lanes``).  This script
draws bf16-valued operands from a numpy seed at every (m, k, n) of
{4, 8, 16, 32, 33, 48, 64, 96, 128, 256} x {2, ..., 256} x {2, 4, 8, 16,
24, 32, 33, 48, 64, 96, 128} (at m = n = 2 XLA sums otherwise, and the
rule does not follow it), and with the left operand transposed at
the attention's shapes, runs ``jax.lax.dot`` in f32 (XLA's excess
precision off, as the tests run it), runs the port's ``matmul`` in a
second process (torch and jax are kept apart), and prints the shapes
where the two are not bit-equal before rounding to bf16.

The rule was read off with cancelling probes: for one output element, a
term of 1 between two terms of +2^25 and -2^25 survives only if it joins
the sum after they have cancelled, which shows, for every pair of terms,
the size of the smallest partial sum holding both.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = (4, 8, 16, 32, 33, 48, 64, 96, 128, 256)
KS = (2, 4, 8, 16, 32, 64, 128, 256)
NS = (2, 4, 8, 16, 24, 32, 33, 48, 64, 96, 128)
# (m, k, n) of products XLA reads with the left operand transposed: the
# attention's key cotangent (Tk, Tq) by (Tq, d) at the tests' windows
LHS_T = ((8, 8, 8), (16, 16, 8), (64, 64, 8), (64, 64, 32))


def _operands():
    import ml_dtypes

    rng = np.random.default_rng(0)
    bf = lambda *s: rng.standard_normal(s).astype(ml_dtypes.bfloat16).astype(np.float32)  # noqa
    cases = {f"{m},{k},{n},N": (bf(m, k), bf(k, n)) for m in MS for k in KS for n in NS}
    cases.update({f"{m},{k},{n},T": (bf(m, k), bf(k, n)) for m, k, n in LHS_T})
    return cases


def jax_side(path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    plain = jax.jit(lambda a, b: a @ b)
    transposed = jax.jit(lambda at, b: jax.lax.dot_general(at, b, (((0,), (0,)), ((), ()))))
    for key, (a, b) in _operands().items():
        out[key + "/a"], out[key + "/b"] = a, b
        f = transposed if key.endswith("T") else plain
        out[key + "/jax"] = np.asarray(f(a.T.copy() if key.endswith("T") else a, b))
    np.savez(path, **out)


def port_side(path):
    import torch

    sys.path.insert(0, ROOT)
    from mimikit_tpu_torch.modules import rounding

    with np.load(path) as f:
        d = dict(f)
    bad = []
    keys = sorted({k.rsplit("/", 1)[0] for k in d})
    for key in keys:
        a, b = torch.from_numpy(d[key + "/a"]), torch.from_numpy(d[key + "/b"])
        # matmul rounds to its operands' dtype: f32 operands keep the f32 sum
        got = rounding.matmul(a, b, lhs_transposed=key.endswith("T")).numpy()
        same = float((got == d[key + "/jax"]).mean())
        if same < 1.0:
            bad.append((key, same))
    print(f"{len(keys)} shapes; not bit-equal: {len(bad)}")
    for key, same in bad:
        print(f"  {key}: {same:.4f} of the elements equal")
    return 1 if bad else 0


def main() -> int:
    if sys.argv[1:2] == ["--port"]:
        return port_side(sys.argv[2])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "dots.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                              + " --xla_allow_excess_precision=false").strip())
        subprocess.run([sys.executable, "-c",
                        f"import sys; sys.path.insert(0, {ROOT!r}); "
                        f"from tools.xla_dot_order import jax_side; jax_side({path!r})"],
                       check=True, env=env, cwd=ROOT)
        return subprocess.run([sys.executable, os.path.abspath(__file__), "--port", path],
                              cwd=ROOT).returncode


if __name__ == "__main__":
    sys.exit(main())
