"""How far the port's bf16 training loop lies from JAX's, net by net.

Usage, on the CPU, from the root of a checkout (~3 min):
``python tools/bf16_train_gaps.py [wavenet,transformer,jukebox]``.  For each
stateless net of ``tests/test_torch_train.py`` (the same weights, data and
three steps) it runs JAX's f32 and bf16 loops with XLA's excess precision
off (as ``tests/test_torch_bf16_train.py`` runs them) and the port's bf16
loop and its controls (WaveNet: the conv's bias inside its product; the
transformers: the softmax differentiated by autograd, the layer norm with
``torch.rsqrt``; JukeBox: a row's partial sums added in order), and
prints each step's |port - JAX bf16| as a share of |JAX bf16 - JAX f32|:
the measure whose bound, 0.1, the test holds.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests.torch_port_harness import run_port  # noqa: E402


def main() -> int:
    kinds = sys.argv[1] if len(sys.argv) > 1 else "wavenet,transformer,jukebox"
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "jax.npz")
        env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                              + " --xla_allow_excess_precision=false").strip())
        subprocess.run([sys.executable, os.path.join(ROOT, "tests", "test_torch_bf16_train.py"),
                        "stateless", path, tmp, kinds], check=True, env=env, cwd=ROOT,
                       capture_output=True)
        with np.load(path, allow_pickle=False) as f:
            inp = dict(f)
        port = run_port("bf16_train_stateless", inp, tmp)
    for kind in kinds.split(","):
        j16, j32 = inp[f"{kind}/jax_losses/bfloat16"], inp[f"{kind}/jax_losses/float32"]
        gap = np.abs(j16 - j32)
        for who in sorted(k.split("/", 1)[1] for k in port
                          if k.startswith(f"{kind}/") and k.endswith("losses")):
            share = np.abs(port[f"{kind}/{who}"] - j16) / gap
            print(f"{kind} {who.replace('_', ' ')}: each step's |port - JAX bf16| / |JAX bf16 - "
                  f"JAX f32| = {np.array2string(share, precision=4)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
