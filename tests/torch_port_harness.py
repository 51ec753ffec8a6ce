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


class PortRun:
    """A ``torch_port_worker.py <task>`` subprocess started on ``inputs``;
    ``result()`` waits for it and returns its outputs."""

    def __init__(self, task: str, inputs: dict, tmp_dir):
        self.task = task
        src, self.dst = os.path.join(tmp_dir, "in.npz"), os.path.join(tmp_dir, "out.npz")
        np.savez(src, **inputs)
        env = dict(os.environ, PYTHONPATH=ROOT)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_port_worker.py"), task, src, self.dst],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    def result(self) -> dict:
        try:
            out, err = self.proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise
        if self.proc.returncode != 0:
            raise RuntimeError(f"port worker '{self.task}' failed:\n{out[-3000:]}{err[-4000:]}")
        with np.load(self.dst, allow_pickle=False) as f:
            return dict(f)


def start_port(task: str, inputs: dict, tmp_dir) -> PortRun:
    """Start ``torch_port_worker.py <task>`` on ``inputs`` and return at once:
    the JAX side of a test computes its references while the port runs."""
    return PortRun(task, inputs, tmp_dir)


def run_port(task: str, inputs: dict, tmp_dir) -> dict:
    """Run ``torch_port_worker.py <task>`` on ``inputs``; return its outputs."""
    return PortRun(task, inputs, tmp_dir).result()
