"""The spectral recipes on the port, on the CPU at a test size.

``mimikit_tpu_torch.demos.seq2seq.demo`` and ``demos.freqnet.demo`` (the JAX
package's recipes, ``mimikit_tpu/demos/seq2seq.py`` and ``freqnet.py``: their
nets at their own widths, 1,025 bins) run with ``device="cpu"`` for one
epoch of two steps at B=2 on one second of audio, the monitor writing one
0.2 s example: each run directory holds ``hp.yaml``, ``epoch=1.ckpt`` and
the example's wav (Griffin-Lim from the generated frames), finite, at the
recipe's 22,050 Hz.  FreqNet's demo stride of 64 samples assumes minutes of
audio: the test reads windows at stride 1 and 16 frames long (as
``tests/test_demos.py`` runs the JAX recipe).  The port runs in a subprocess
(``torch_port_worker.py spectral_demos``).
"""
import numpy as np
import pytest
from scipy.io import wavfile

from tests.torch_port_harness import run_port

SR = 22050
DEMOS = ("seq2seq", "freqnet")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    work = tmp_path_factory.mktemp("spectral_demos")
    t = np.arange(SR) / SR
    y = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
    wav = str(work / "tone.wav")
    wavfile.write(wav, SR, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))
    return run_port("spectral_demos", {"work": np.array(str(work)), "wav": np.array(wav),
                                       "sr": np.array(SR)}, str(work))


@pytest.mark.parametrize("name", DEMOS)
def test_demo_writes_its_run_directory(port, name):
    files = port[f"{name}/files"].tolist()
    assert {"hp.yaml", "epoch=1.ckpt", "outputs"} <= set(files), files
    assert str(port[f"{name}/device"]) == "cpu"


@pytest.mark.parametrize("name", DEMOS)
def test_demo_trains_and_writes_a_wav_through_griffin_lim(port, name):
    assert port[f"{name}/losses"].shape == (1,) and np.isfinite(port[f"{name}/losses"]).all()
    assert len(port[f"{name}/wavs"]) == 1
    assert int(port[f"{name}/wav_sr"]) == SR
    y = port[f"{name}/wav"]
    assert y.size > 0 and np.isfinite(y).all()


def test_demo_nets_are_the_recipes(port):
    """Parameter counts of the recipes' nets at their own widths."""
    assert int(port["seq2seq/n_params"]) > 10_000_000
    assert int(port["freqnet/n_params"]) > 5_000_000
