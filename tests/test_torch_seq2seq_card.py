"""The seq2seq path's LSTM kernels on the card.

Marked ``cuda``: they skip without a card and nvcc, and run on the card with
``python -m pytest -m cuda tests/``.  Each runs a script in a subprocess (the
same checks as ``chip_smoke.py``'s phase 7):

* K3a-wide and K3b-wide at the seq2seq demo's shapes, (T, B, H) = (4, 16,
  512) for training and (4, 4, 512) for its 4-stream block decode, the
  first layer's input 1,025 wide and 512, non-zero h0/c0 and cotangents on
  h_T and c_T: all nine outputs and gradients against the plain versions
  (``check_lstm``'s tolerance);
* the bf16 cluster kernels (K3a-bf16, K3b-bf16) at (4, 16, 512), the shapes
  of the demo's bf16 training, against their bf16 twin, each tensor within
  its share of elements that differ, and the control refused
  (``check_lstm_bf16`` at ``BF16_LSTM_S2S_SHARES``);
* two LSTM modules chained through a seeded carry (the first's input width
  D differing from H), on the wide route at (4, 16, 1025 -> 512) and the
  cluster route at (16, 8, 40 -> 256): the gradient that reaches the first
  layer through h_T and c_T against the same on the CPU
  (``check_lstm_chain``);
* one train step of the seq2seq demo's net on the card against the same step
  on the CPU (``check_s2s_step``: every LSTM call on the wide kernels).
"""
import functools
import os
import subprocess
import sys

import pytest

from tests.torch_port_harness import ROOT

_KERNELS = """
import torch
import chip_smoke as cs
from mimikit_tpu_torch.ops import fused_lstm as fl
torch.backends.cuda.matmul.allow_tf32 = False
cs.check_lstm(torch, fl, cs.LSTM_S2S_SHAPES)
assert fl.lstm_forward_wide.launches >= 2 and fl.lstm_backward_wide.launches >= 2
print("ok")
"""

_BF16 = """
import torch
import chip_smoke as cs
from mimikit_tpu_torch.ops import fused_lstm as fl
torch.backends.cuda.matmul.allow_tf32 = False
cs.check_lstm_bf16(torch, fl, cs.LSTM_S2S_BF16_SHAPES, cs.BF16_LSTM_S2S_SHARES)
assert fl.lstm_forward.launches_bf16 >= 2 and fl.lstm_backward.launches_bf16 >= 2
print("ok")
"""

_CHAIN = """
import torch
import chip_smoke as cs
from mimikit_tpu_torch.ops import fused_lstm as fl
torch.backends.cuda.matmul.allow_tf32 = False
cs.check_lstm_chain(torch, fl, ((4, 16, 1025, 512), (16, 8, 40, 256)))
print("ok")
"""

_STEP = """
import torch
import chip_smoke as cs
import mimikit_tpu_torch as mmk
from mimikit_tpu_torch.ops import fused_lstm as fl
from mimikit_tpu_torch.ops import samplernn_decode as sd
torch.backends.cuda.matmul.allow_tf32 = False
cs.check_s2s_step(torch, mmk, fl, sd, cs.card_line())
print("ok")
"""


@functools.lru_cache(maxsize=None)
def _has_card() -> bool:
    """One probe a module (torch is imported in a subprocess: this process
    has jax)."""
    probe = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
                           capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    return probe.stdout.strip() == "True"


def _run_on_card(script):
    env = dict(os.environ, PYTHONPATH=ROOT)
    if not _has_card():
        pytest.skip("needs a CUDA device and nvcc (run on the card: python3 chip_smoke.py)")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=900)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


@pytest.mark.cuda
def test_wide_kernels_at_the_seq2seq_shapes_on_card():
    _run_on_card(_KERNELS)


@pytest.mark.cuda
def test_bf16_cluster_kernels_at_the_seq2seq_shapes_on_card():
    _run_on_card(_BF16)


@pytest.mark.cuda
def test_chained_carry_gradients_on_card():
    _run_on_card(_CHAIN)


@pytest.mark.cuda
def test_seq2seq_train_step_matches_the_cpu_step_on_card():
    _run_on_card(_STEP)
