"""The wide LSTM kernels (K3a-wide, K3b-wide) on the card.

Marked ``cuda``: they skip without a card and nvcc, and run on the card with
``python -m pytest -m cuda tests/``.  Each runs a script in a subprocess (the
same checks as ``chip_smoke.py``'s):

* the wide kernels against their plain versions at (T, B, H) = (8, 32, 512),
  f32, and (8, 32, 768), bf16, with the tolerance of ``check_lstm``
  (1e-5 + 1e-4 * max|plain|) in f32 and the share-of-gap rule of
  ``check_lstm_bf16`` in bf16; the wrappers' counters rise;
* the same at other batch sizes, ``chip_smoke.LSTM_WIDE_B_SHAPES`` (B = 8,
  48 and 128 at T = 16, H = 512, f32) and ``LSTM_WIDE_BF16_B_SHAPES`` (the
  same B at T = 32, H = 768, bf16, each tensor against
  ``BF16_LSTM_WIDE_SHARES``, the control refused), and at B = 48 and 128
  repeated calls giving the same bits (``check_wide_repeatable``);
* a SampleRNN-3 train step at hidden_dim 512 (f32) and 768 (f32 and bf16)
  on the card against the same step on the CPU (``check_train_step``: the
  wide kernels' counters rise, loss within 1e-5 relative and gradients
  within 1e-5 + 1e-3 * max|plain| in f32; the bf16 step's loss within
  max(10 %, 5e-3) of the f32 CPU step's).
"""
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
err = cs.check_lstm(torch, fl, ((8, 32, 512, 512),))
err.update(cs.check_lstm_bf16(torch, fl, ((8, 32, 768, 768),), cs.BF16_LSTM_SHARE[1]))
assert fl.lstm_forward_wide.launches >= 1 and fl.lstm_backward_wide.launches >= 1
assert fl.lstm_forward_wide.launches_bf16 >= 1 and fl.lstm_backward_wide.launches_bf16 >= 1
print("ok")
"""

_BATCHES = """
import torch
import chip_smoke as cs
from mimikit_tpu_torch.ops import fused_lstm as fl
torch.backends.cuda.matmul.allow_tf32 = False
cs.check_lstm(torch, fl, cs.LSTM_WIDE_B_SHAPES)
cs.check_lstm_bf16(torch, fl, cs.LSTM_WIDE_BF16_B_SHAPES, cs.BF16_LSTM_WIDE_SHARES)
cs.check_wide_repeatable(torch, fl)
assert fl.lstm_forward_wide.launches >= 3 and fl.lstm_backward_wide.launches >= 3
assert fl.lstm_forward_wide.launches_bf16 >= 3 and fl.lstm_backward_wide.launches_bf16 >= 3
print("ok")
"""

_STEPS = """
import torch
import chip_smoke as cs
import mimikit_tpu_torch as mmk
from mimikit_tpu_torch.ops import fused_lstm as fl
torch.backends.cuda.matmul.allow_tf32 = False
cs.check_train_step(torch, mmk, fl, hidden_dim=512)
cs.check_train_step(torch, mmk, fl, hidden_dim=768, bf16=True)
print("ok")
"""


def _run_on_card(script):
    env = dict(os.environ, PYTHONPATH=ROOT)
    probe = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
                           capture_output=True, text=True, env=env)
    if probe.stdout.strip() != "True":
        pytest.skip("needs a CUDA device and nvcc (run on the card: python3 chip_smoke.py)")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=900)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


@pytest.mark.cuda
def test_wide_kernels_match_plain_versions_on_card():
    _run_on_card(_KERNELS)


@pytest.mark.cuda
def test_wide_kernels_at_other_batch_sizes_on_card():
    _run_on_card(_BATCHES)


@pytest.mark.cuda
def test_wide_train_steps_match_the_cpu_step_on_card():
    _run_on_card(_STEPS)
