"""The port's loggers and audio files against the JAX package's, on the CPU.

Ports of ``tests/test_loggers.py`` (``EpochMetrics``' averages and NaN
guard; ``LossLogger``'s groups by step, a step written again replacing its
values; ``AudioLogger``'s template, a WAV at its rate, another extension
falling back to WAV without ffmpeg, a multichannel array refused), and:

* JAX's h5py reads the port's ``LossLogger`` file, with the values JAX's
  own ``LossLogger`` writes for the same calls; without h5py (the card's
  machine) the port writes its npz container and reads it back;
  ``EpochMetrics.flush_epoch(epoch, logger)`` logs the epoch's averages;
* the WAV bytes the port writes (``AudioLogger.write``, ``write_wav`` of a
  signal past full scale, peak-normalised) equal JAX's ``write_wav``'s;
* ``load_audio`` of a 22,050 Hz file at 22,050 and at 16,000 Hz (the
  polyphase resampling), with an offset and a duration, equals JAX's to
  ``atol=1e-6``, and so does ``FileToSignal`` at another rate than the
  file's and on 8-bit PCM;
* ``GradNormCallback.grad_norm`` equals JAX's for ord 1, 2 and 3.

The port runs in one subprocess for the module (``torch_port_worker.py
loggers``).
"""
import os

import numpy as np
import pytest
from scipy.io import wavfile

import jax.numpy as jnp
import mimikit_tpu as mmk
from mimikit_tpu.features.audio_io import load_audio, write_wav
from mimikit_tpu.loops.callbacks import GradNormCallback
from mimikit_tpu.loops.logger import AudioLogger, EpochMetrics, LossLogger

from tests.torch_port_harness import run_port


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("loggers"))
    rng = np.random.default_rng(0)
    y = np.sin(np.linspace(0, 40, 4000)).astype(np.float32)
    t = np.arange(22050) / 22050
    wav22 = os.path.join(work, "a22.wav")
    sig = 0.6 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(t.size)
    wavfile.write(wav22, 22050, (sig * 32767).astype(np.int16))
    wav_u8 = os.path.join(work, "u8.wav")
    wavfile.write(wav_u8, 8000, (128 + 100 * np.sin(np.arange(800) / 9)).astype(np.uint8))
    g = [rng.standard_normal((5, 7)).astype(np.float32), rng.standard_normal(11).astype(np.float32)]
    port = run_port("loggers", {"work": np.array(work), "y": y, "wav22": np.array(wav22),
                                "wav_u8": np.array(wav_u8), "g0": g[0], "g1": g[1]}, work)
    # JAX's loggers on the same calls
    m = EpochMetrics(print_fn=lambda *_: None)
    m.on_epoch_start()
    m.log_output({"loss": 2.0, "acc": 0.5})
    m.log_output({"loss": 4.0, "acc": 1.0})
    jx = {"path": os.path.join(work, "jax", "metrics.h5"), "y": y, "wav22": wav22,
          "wav_u8": wav_u8, "g": g, "work": work}
    ll = LossLogger(jx["path"])
    ll.log_metrics({"loss": 1.5, "lr": 1e-3}, step=0)
    ll.log_metrics({"loss": 1.25}, step=1)
    ll.log_metrics({"loss": 1.0}, step=1)
    m.flush_epoch(2, logger=ll)
    return jx, port


def test_epoch_metrics_averages_and_nan_guard(case):
    _, port = case
    np.testing.assert_array_equal(port["metrics/avg"], [3.0, 0.75])
    assert str(port["metrics/nan"]).startswith("RuntimeError")


@pytest.mark.parametrize("backend", ("h5py", "npz"))
def test_loss_logger_round_trip(case, backend):
    _, port = case
    np.testing.assert_array_equal(port[f"{backend}/read"], [1.5, 1e-3, 1.0, 3.0, 0.75])
    assert port[f"{backend}/groups"].tolist() == ["0", "1", "2"]


def test_jax_h5py_reads_the_ports_loss_log_as_jaxs_own(case):
    import h5py

    jx, port = case
    with h5py.File(str(port["h5py/path"]), "r") as f, h5py.File(jx["path"], "r") as g:
        assert sorted(f.keys()) == sorted(g.keys()) == ["0", "1", "2"]
        for step in g:
            assert sorted(f[step].keys()) == sorted(g[step].keys())
            for k in g[step]:
                assert f[step][k].shape == g[step][k].shape == (1,)
                assert f[step][k].dtype == g[step][k].dtype
                np.testing.assert_array_equal(f[step][k][()], g[step][k][()])


def test_audio_logger_writes_jaxs_wav_bytes(case):
    jx, port = case
    path = str(port["audio/path"])
    assert path.endswith("epoch=3_p=7.wav")
    want = AudioLogger(sr=8000, file_template=os.path.join(
        jx["work"], "jax_out", "epoch={epoch}_p={prompt_idx}.wav")).write(jx["y"], epoch=3,
                                                                        prompt_idx=7)
    with open(path, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    sr, audio = wavfile.read(path)
    assert sr == 8000 and len(audio) == 4000
    with open(str(port["audio/torch_path"]), "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


def test_other_extension_falls_back_as_jax_does(case):
    jx, port = case
    got = str(port["audio/mp3_path"])
    want = AudioLogger(sr=8000, file_template=os.path.join(jx["work"], "jax_out",
                                                           "take_{epoch}.mp3")).write(jx["y"],
                                                                                      epoch=1)
    assert os.path.exists(got)
    assert os.path.basename(got) == os.path.basename(want)


def test_audio_logger_rejects_multichannel(case):
    _, port = case
    assert str(port["audio/multichannel"]) == "ValueError"


def test_write_wav_peak_normalises_as_jax(case):
    jx, port = case
    want = write_wav(os.path.join(jx["work"], "jax_loud.wav"), 3 * jx["y"], 8000)
    with open(str(port["write_wav"]), "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("sr", (22050, 16000))
def test_load_audio_matches_jax(case, sr):
    jx, port = case
    want = load_audio(jx["wav22"], sr=sr)
    assert port[f"load_audio/{sr}"].dtype == np.float32
    assert port[f"load_audio/{sr}"].shape == want.shape == (sr,)
    np.testing.assert_allclose(port[f"load_audio/{sr}"], want, atol=1e-6)


def test_load_audio_offset_and_duration_match_jax(case):
    jx, port = case
    want = load_audio(jx["wav22"], sr=16000, offset=0.1, duration=0.2)
    np.testing.assert_allclose(port["load_audio/offset"], want, atol=1e-6)


def test_file_to_signal_resamples_as_jax(case):
    jx, port = case
    want = np.asarray(mmk.FileToSignal(16000)(jx["wav22"]))
    np.testing.assert_allclose(port["file_to_signal"], want, atol=1e-6)


def test_file_to_signal_reads_8_bit_pcm_as_jax(case):
    jx, port = case
    want = np.asarray(mmk.FileToSignal(8000)(jx["wav_u8"]))
    np.testing.assert_array_equal(port["file_to_signal/u8"], want)


def test_grad_norm_matches_jax(case):
    jx, port = case
    leaves = [jnp.asarray(x) for x in jx["g"]]
    want = [float(GradNormCallback.grad_norm(leaves, ord=o)) for o in (1.0, 2.0, 3.0)]
    np.testing.assert_allclose(port["grad_norm"], want, rtol=1e-6)
    np.testing.assert_allclose(port["grad_norm/callback"], want[:1], rtol=1e-6)


def test_is_notebook_is_false_outside_a_notebook(case):
    _, port = case
    assert not bool(port["is_notebook"])
