"""JAX-side helpers of the ``tests/test_torch_*.py`` parity tests.

The port runs in a subprocess (``torch_port_worker.py``) that imports only
torch and ``mimikit_tpu_torch``; this module, imported by the JAX-side test
process, never imports torch.  Arrays travel through ``.npz`` files.
"""
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts of arrays -> {``prefix`` + "a/b/c": np.ndarray}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def run_port(task: str, inputs: dict, tmp_dir) -> dict:
    """Run ``torch_port_worker.py <task>`` on ``inputs``; return its outputs."""
    src, dst = os.path.join(tmp_dir, "in.npz"), os.path.join(tmp_dir, "out.npz")
    np.savez(src, **inputs)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_port_worker.py"), task, src, dst],
        capture_output=True, text=True, env=env, timeout=300,
    )
    if res.returncode != 0:
        raise RuntimeError(f"port worker '{task}' failed:\n{res.stdout[-3000:]}{res.stderr[-4000:]}")
    with np.load(dst, allow_pickle=False) as f:
        return dict(f)
