"""One temperature a row through every decode kernel, on the card.

Marked ``cuda``: it skips without a card and nvcc, and runs on the card with
``python -m pytest -m cuda tests/``.  It runs ``chip_smoke.py``'s
``check_row_temperatures`` in a subprocess: K1 and K2 on the cluster and the
block kernel (f32 and bf16 packs), K4 and K5 on both WaveNet kernels, K6, K7
(f32 and bf16) and K8's cluster, group and block kernels decode six streams
at ``chip_smoke.ROW_TEMPERATURES``, their tokens verified against the plain
twins by teacher forcing, each row equal to that row decoded at its own
temperature.
"""
import pytest

from tests.test_torch_lstm_wide_card import _run_on_card

_ROWS = """
import torch
import chip_smoke as cs
import mimikit_tpu_torch as mmk
from mimikit_tpu_torch.ops import jukebox_decode as jbd
from mimikit_tpu_torch.ops import samplernn_decode as sd
from mimikit_tpu_torch.ops import transformer_decode as td
from mimikit_tpu_torch.ops import transformer_kv as tk
from mimikit_tpu_torch.ops import wavenet_decode as wd
cs.check_row_temperatures(torch, mmk, sd, wd, td, tk, jbd)
print("ok")
"""


@pytest.mark.cuda
def test_per_row_temperatures_through_every_decode_kernel_on_card():
    _run_on_card(_ROWS)
