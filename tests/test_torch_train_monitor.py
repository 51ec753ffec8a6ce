"""Monitored training in the port against the JAX package's loop, on the CPU.

* ``TrainARMConfig()``'s defaults (``MONITOR_TRAINING`` on) run: a
  checkpoint callback, then a ``GenerateCallback`` that decodes
  ``n_examples`` prompts of ``outputs_duration_sec`` at the second epoch and
  shows them.
* An interrupted, monitored run (``OUTPUT_TRAINING``, a per-example
  ``temperature`` tuple, ``loss_logs_file``, the prompts' positions drawn
  from one seed in both packages) resumes from its checkpoint: its
  per-epoch losses match JAX's interrupted-and-resumed run at ``rtol=1e-4``
  (the tolerance of ``test_torch_train.py``'s per-step losses; JAX with
  ``MMK_FUSED_LSTM=1``), its loss log holds the same losses, and it writes
  the files JAX's loop names, ``outputs/epoch{e}_prm{i}.wav``.
* ``trainer_kwargs["remat"]`` at ``True``, ``"dots_saveable"``,
  ``"nothing_saveable"``, ``"everything_saveable"`` and a selective-
  checkpoint policy callable gives parameters equal to the plain run's
  (``atol=1e-6``, as JAX's ``test_remat_step_matches_plain``), in f32 and
  under ``param_dtype="bfloat16"``; the LSTM forward runs twice a step where
  the forward is recomputed.  An unknown policy name raises
  ``NotImplementedError`` naming it, a value of another type ``TypeError``.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py train_monitor``).
"""
import os

import numpy as np
import pytest
from scipy.io import wavfile

import jax
import mimikit_tpu as mmk
from mimikit_tpu.loops.callbacks import GenerateCallback

from tests.torch_port_harness import flatten, run_port

SR, Q, H, FS = 16000, 32, 16, (8, 4, 2)
MONITORED = dict(batch_size=4, batch_length=64, tbptt_chunk_length=256, max_epochs=3,
                 limit_train_batches=1, MONITOR_TRAINING=True, OUTPUT_TRAINING="wav",
                 every_n_epochs=1, n_examples=2, temperature=(1.0, 0.5),
                 prompt_length_sec=0.004, outputs_duration_sec=0.003, save_optimizer=True,
                 trainer_kwargs={"data_seed": 5, "loss_logs_file": "loss.h5"})
REMAT = ("true", "dots_saveable", "nothing_saveable", "everything_saveable", "callable")
TIERS = len(FS) - 1  # LSTM layers a forward


def _wav(path, sr, seconds):
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    y = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(t.size)
    wavfile.write(path, sr, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))


def _pin_prompts(loop):
    for cb in loop.callbacks:
        if isinstance(cb, GenerateCallback):
            s = cb.loop.dataloader.sampler
            s._rng = np.random.RandomState(0)
            s.indices = s.draw_indices(s.N, s._indices)


def _logged(loop, into):
    log_output = loop.metrics.log_output
    loop.metrics.log_output = lambda d: into.append(float(d["loss"])) or log_output(d)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("train_monitor"))
    wav, wav8 = os.path.join(work, "a.wav"), os.path.join(work, "b8.wav")
    _wav(wav, SR, 1.0)
    _wav(wav8, 8000, 0.6)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=Q, mlp_dim=H),
                             extractor=ds.extractors[0])
    net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(frame_sizes=FS, hidden_dim=H, io_spec=io))
    net.seed(0)
    net.init_params()
    params0 = jax.device_get(net.params)
    cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, "jax_tr"), **MONITORED)
    jx = {"losses": []}

    def stop(*_):
        raise KeyboardInterrupt

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMK_FUSED_LSTM", "1")
        mp.setenv("MMK_PALLAS_DECODE", "0")
        mp.setattr(mmk.AudioLogger, "display", lambda self, y, **kw: None)
        first = mmk.TrainARMLoop.from_config(cfg, db, net)
        _pin_prompts(first)
        _logged(first, jx["losses"])
        first.on_train_epoch_end = stop
        first.run()
        resumed = mmk.TrainARMLoop.from_checkpoint(
            mmk.Checkpoint(id=first.hash_, epoch=1, root_dir=cfg.root_dir))
        _pin_prompts(resumed)
        _logged(resumed, jx["losses"])
        resumed.run()
    run_dir = os.path.join(cfg.root_dir, first.hash_)
    jx["outputs"] = sorted(os.listdir(os.path.join(run_dir, "outputs")))
    jx["log_path"] = os.path.join(run_dir, "loss.h5")
    db.close()  # the port opens the same file
    inp = {"work": np.array(work), "wav": np.array(wav), "wav8": np.array(wav8),
           "jax_h5": np.array(ds.filename), "net_yaml": np.array(net.config.serialize()),
           "train_yaml": np.array(cfg.serialize()), **flatten(params0, "params0/")}
    return jx, run_port("train_monitor", inp, work)


def test_default_config_runs_with_monitoring(case):
    _, port = case
    assert port["default/callbacks"].tolist() == ["MMKCheckpoint", "GenerateCallback"]
    losses = port["default/losses"]
    assert losses.shape == (2,) and np.all(np.isfinite(losses))
    shown = port["default/shown"]
    assert shown.shape == (3, 2) and set(shown[:, 0].tolist()) == {2}
    assert int(port["default/n_steps"]) == 8000


def test_monitored_run_resumes_from_its_checkpoint(case):
    _, port = case
    assert port["resume/start"].tolist() == [1, 1]
    assert port["resume/end"].tolist() == [3, 3]


def test_resumed_per_epoch_losses_match_jax(case):
    jx, port = case
    assert len(jx["losses"]) == port["resume/losses"].shape[0] == 3
    np.testing.assert_allclose(port["resume/losses"], jx["losses"], rtol=1e-4)


def test_loss_log_holds_each_epochs_losses_as_jaxs(case):
    import h5py

    jx, port = case
    with h5py.File(str(port["resume/log_path"]), "r") as f, h5py.File(jx["log_path"], "r") as g:
        assert sorted(f.keys()) == sorted(g.keys()) == ["1", "2", "3"]
        got = [float(f[e]["loss"][0]) for e in ("1", "2", "3")]
        want = [float(g[e]["loss"][0]) for e in ("1", "2", "3")]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, port["resume/losses"], rtol=1e-12)


def test_output_training_writes_the_files_jax_names(case):
    jx, port = case
    got = port["resume/outputs"].tolist()
    assert len(got) == 3 * MONITORED["n_examples"]
    assert got == jx["outputs"]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("remat", REMAT)
def test_remat_gives_the_plain_runs_parameters(case, dtype, remat):
    _, port = case
    plain, p = f"remat/{dtype}/plain/params/", f"remat/{dtype}/{remat}/params/"
    keys = [k[len(plain):] for k in port if k.startswith(plain)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[p + k], port[plain + k], atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(port[f"remat/{dtype}/{remat}/losses"],
                               port[f"remat/{dtype}/plain/losses"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("remat", ("plain",) + REMAT)
def test_remat_runs_the_lstm_forward_again_in_the_backward(case, dtype, remat):
    _, port = case
    calls, steps = port[f"remat/{dtype}/{remat}/calls"].tolist()
    again = remat not in ("plain", "everything_saveable")
    assert steps == MONITORED["max_epochs"]
    assert calls == TIERS * steps * (2 if again else 1)


def test_unknown_remat_policy_raises_naming_it(case):
    _, port = case
    msg = str(port["remat/refused/unknown"])
    assert msg.startswith("NotImplementedError") and "offload_dot_with_no_batch_dims" in msg


def test_remat_of_another_type_raises_type_error(case):
    _, port = case
    assert str(port["remat/refused/int"]).startswith("TypeError")
