"""The port's training path against the JAX package, on the CPU.

* data: the port's ``Database`` reads a JAX-written h5, and the JAX package
  reads a port-written h5 of the same source with equal arrays and attrs;
* batches: the same ``data_seed`` draws identical batches in both packages
  (host loaders, TBPTT sampler), and the port's ``DeviceBatcher`` serves the
  host loader's batches;
* cross-entropy equals the JAX loss's (``rtol=1e-6``) and the one-cycle
  schedule's LR per step optax's (``rtol=1e-5``: optax evaluates it in f32,
  the port in f64);
* three f32 steps of ``TrainARMLoop`` (``limit_train_batches=1``,
  ``max_epochs=3``: each epoch mean is one step's loss) from the same
  weights, JAX with ``MMK_FUSED_LSTM=1`` (the Pallas LSTM in interpret
  mode): losses per step ``rtol=1e-4``; the first step's gradients
  ``rtol=1e-3, atol=1e-5 * max|g|`` (f32, summed in another order); the
  final parameters: every element within the total movement Adam allows,
  ``sum_t 2 * 1.001 * lr_t`` (with b1=0.9, b2=0.93 the normalised step
  ``|m_hat / sqrt(v_hat)|`` stays below 1.001 over three steps, so each
  package moves an element by at most ``1.001 * lr_t`` a step, and where
  ``|g|`` is near Adam's eps the two can move it in opposite directions),
  and 99% of the elements within ``1e-6 + 1e-4 * |p|``;
* the port's LSTMs have one bias: ``bias_ih`` stays zero through training
  and a loaded ``bias_ih`` is folded into ``bias_hh``;
* the npz file layer (where h5py is missing) round-trips a dataset and a
  bank;
* a bank written by the JAX package loads in the port and decodes the same
  argmax tokens; a bank written by the port loads in the JAX package with
  the port's parameters;
* an interrupted run resumes from its checkpoint (``from_checkpoint``),
  optimizer state included, and a ``param_dtype="bfloat16"`` run resumes
  from its hp.yaml under the same policy;
* ``matmul_precision`` sets ``torch.set_float32_matmul_precision`` for each
  step (JAX's names mapped to torch's) and puts the previous value back;
  ``steps_per_dispatch`` and ``flat_optimizer`` (TPU dispatch and optimizer
  layout) leave the losses as they are;
* unported ``trainer_kwargs`` (and ``MONITOR_TRAINING``) raise
  ``NotImplementedError`` naming the key.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py train``).
"""
import os

import numpy as np
import pytest
from scipy.io import wavfile

import jax
import mimikit_tpu as mmk

from tests.torch_port_harness import flatten, run_port

SR, Q, H, FS = 16000, 32, 16, (8, 4, 2)
N_STEPS = 48
TRAIN = dict(batch_size=4, batch_length=64, tbptt_chunk_length=256, max_epochs=3,
             limit_train_batches=1, MONITOR_TRAINING=False, every_n_epochs=1,
             trainer_kwargs={"data_seed": 5})
SCHED = np.array([[3, 5e-4, 1 / 3 + 1e-9, 3.0, 1.0], [100, 1e-3, 0.25, 25.0, 1e4],
                  [7, 2e-4, 0.5, 3.0, 10.0]])


def _wav(path):
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    y = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(SR)
    wavfile.write(path, SR, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))


def _batches(loader, n):
    out = []
    for k, (inputs, targets) in enumerate(loader):
        if k == n:
            break
        out.append((np.asarray(inputs[0]), np.asarray(targets[0])))
    return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import optax

    from mimikit_tpu.modules.loss_functions import cross_entropy

    work = str(tmp_path_factory.mktemp("train"))
    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    jx = {"signal": db.signal[:]}
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=Q, mlp_dim=H),
                             extractor=ds.extractors[0])
    net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(frame_sizes=FS, hidden_dim=H, io_spec=io))
    net.seed(0)
    net.init_params()
    params0 = jax.device_get(net.params)
    cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, "jax_tr"), **TRAIN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMK_FUSED_LSTM", "1")
        host_cfg = mmk.TrainARMConfig(**{**TRAIN, "trainer_kwargs": {
            **TRAIN["trainer_kwargs"], "device_batching": False}})
        jx["batches"] = _batches(mmk.TrainARMLoop.get_dataloader(db, net, host_cfg), 3)
        inputs, targets = next(iter(mmk.TrainARMLoop.get_dataloader(db, net, cfg)))
        key = jax.random.PRNGKey(0)

        def loss(p):
            outputs, _ = net.module.apply({"params": p}, inputs, None, True,
                                          rngs={"dropout": key, "sample": key})
            return io.loss_fn(outputs, targets)["loss"]

        jx["grads0"] = flatten(jax.device_get(jax.grad(loss)(net.params)))
        loop = mmk.TrainARMLoop.from_config(cfg, db, net)
        logged = []
        log_output = loop.metrics.log_output
        loop.metrics.log_output = lambda d: logged.append(dict(d)) or log_output(d)
        loop.run()
        jx["losses"] = np.array([d["loss"] for d in logged])
        jx["params"] = flatten(jax.device_get(net.params))
        mp.setenv("MMK_PALLAS_DECODE", "0")
        bank = mmk.Checkpoint(id=loop.hash_, epoch=3, root_dir=cfg.root_dir)
        prompt = np.random.default_rng(1).integers(0, Q, (2, 2 * FS[0])).astype(np.int32)
        jx["bank_tokens"] = np.asarray(
            bank.network.generate((prompt,), n_steps=N_STEPS, temperature=None)[0])
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5, Q)).astype(np.float32) * 3
    labels = rng.integers(0, Q, (3, 5)).astype(np.int32)
    jx["ce"] = float(cross_entropy(logits, labels))
    jx["sched"] = np.array([[float(optax.cosine_onecycle_schedule(int(n), *rest)(i))
                             for i in range(12)] for n, *rest in SCHED])
    db.close()  # the port opens the same file
    inp = {
        "work": np.array(work), "wav": np.array(wav), "jax_h5": np.array(ds.filename),
        "net_yaml": np.array(net.config.serialize()), "train_yaml": np.array(cfg.serialize()),
        "jax_bank_root": np.array(cfg.root_dir), "jax_bank_id": np.array(loop.hash_),
        "jax_bank_epoch": np.array(3), "prompt": prompt, "n_steps": np.array(N_STEPS),
        "ce_logits": logits, "ce_targets": labels, "sched_cfgs": SCHED, "sched_steps": np.array(12),
        **flatten(params0, "params0/"),
    }
    port = run_port("train", inp, work)
    return jx, port, work


def test_port_database_reads_jax_h5(case):
    jx, port, _ = case
    np.testing.assert_array_equal(port["jax_h5/signal"], jx["signal"])
    np.testing.assert_array_equal(port["jax_h5/refs"], [0, jx["signal"].shape[0]])
    assert [os.path.basename(s) for s in port["jax_h5/sources"]] == ["a.wav"]


def test_port_written_h5_reads_in_jax(case):
    jx, port, work = case
    assert str(port["h5_backend"]) == "h5py"
    cfg = mmk.DatasetConfig(filename=os.path.join(work, "port.h5"))
    db = cfg.get(mode="r")
    np.testing.assert_array_equal(db.signal[:], jx["signal"])
    np.testing.assert_array_equal(db.signal.attrs["refs"], [0, jx["signal"].shape[0]])
    assert db.config.extractors[0].name == "signal"
    db.close()


@pytest.mark.parametrize("k", range(3))
def test_same_data_seed_draws_the_same_batches(case, k):
    jx, port, _ = case
    x, y = jx["batches"][k]
    np.testing.assert_array_equal(port[f"batches/host/{k}/in"], x)
    np.testing.assert_array_equal(port[f"batches/host/{k}/tgt"], y)


@pytest.mark.parametrize("k", range(3))
def test_device_batcher_serves_the_host_loader_batches(case, k):
    _, port, _ = case
    for part in ("in", "tgt"):
        np.testing.assert_array_equal(port[f"batches/device/{k}/{part}"],
                                      port[f"batches/host/{k}/{part}"])


def test_cross_entropy_matches_jax(case):
    jx, port, _ = case
    np.testing.assert_allclose(float(port["ce"]), jx["ce"], rtol=1e-6)


def test_schedule_matches_optax(case):
    jx, port, _ = case
    np.testing.assert_allclose(port["sched"], jx["sched"], rtol=1e-5, atol=1e-12)


def test_losses_per_step_match_jax_loop(case):
    jx, port, _ = case
    assert jx["losses"].shape == port["losses"].shape == (3,)
    np.testing.assert_allclose(port["losses"], jx["losses"], rtol=1e-4)


def test_first_step_gradients_match_jax(case):
    jx, port, _ = case
    for k, g in jx["grads0"].items():
        p = port[f"grads0/{k}"]
        np.testing.assert_allclose(p, g, rtol=1e-3, atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=k)


def test_final_parameters_within_adams_reach(case):
    jx, port, _ = case
    from optax import cosine_onecycle_schedule

    total = TRAIN["max_epochs"] * TRAIN["limit_train_batches"]
    sched = cosine_onecycle_schedule(total, 5e-4, 1 / total + 1e-9, 3.0, 1.0)
    lr = [float(sched(i)) for i in range(total)]
    reach = sum(2 * 1.001 * x for x in lr)
    close = total_n = 0
    for k, ref in jx["params"].items():
        got = port[f"params/{k}"]
        assert got.shape == ref.shape, k
        assert np.abs(got - ref).max() <= reach, k
        close += int((np.abs(got - ref) <= 1e-6 + 1e-4 * np.abs(ref)).sum())
        total_n += ref.size
    assert close >= 0.99 * total_n, (close, total_n)


def test_bias_ih_stays_zero(case):
    _, port, _ = case
    assert float(port["bias_ih_max"]) == 0.0


def test_a_loaded_input_bias_folds_into_the_single_lstm_bias(case):
    """bias_hh takes the sum, bias_ih reads zero, and bias_ih is a buffer
    (no optimizer moves it) that keeps its state_dict name."""
    _, port, _ = case
    assert port["bias_fold"].tolist() == [True, True, True, True]


def test_npz_file_layer_round_trips_a_dataset_and_a_bank(case):
    """Where h5py is not installed the same tree goes to one npz file."""
    jx, port, _ = case
    np.testing.assert_array_equal(port["npz/signal"], jx["signal"])
    np.testing.assert_array_equal(port["npz/refs"], [0, jx["signal"].shape[0]])
    assert bool(port["npz/bank_equal"]) and int(port["npz/trainer_state"]) == 1


def test_interrupted_run_resumes_from_its_checkpoint(case):
    """An interrupt after epoch 1 saves ``epoch=1.ckpt`` and ``.opt``;
    ``from_checkpoint`` restarts at epoch 1, step 1, with the optimizer's
    count restored, and finishes epoch 2."""
    _, port, _ = case
    assert port["resume/start"].tolist() == [1, 1]
    assert port["resume/end"].tolist() == [2, 2]
    files = set(port["resume/files"].tolist())
    assert {"epoch=1.ckpt", "epoch=1.opt", "epoch=2.ckpt", "epoch=2.opt", "hp.yaml"} <= files


def test_jax_bank_decodes_the_same_argmax_tokens_in_the_port(case):
    jx, port, _ = case
    assert port["jax_bank_tokens"].shape == jx["bank_tokens"].shape == (2, 2 * FS[0] + N_STEPS)
    np.testing.assert_array_equal(port["jax_bank_tokens"], jx["bank_tokens"])


def test_port_bank_loads_in_jax(case):
    _, port, _ = case
    bank = mmk.Checkpoint(id=str(port["port_bank_id"]), epoch=3,
                          root_dir=str(port["port_bank_root"]))
    params = flatten(jax.device_get(bank.network.params))
    assert bank.trainer_state["fit_loop"] == {"epoch": 3, "global_step": 3}
    assert set(params) == {k[len("params/"):] for k in port if k.startswith("params/")}
    for k, v in params.items():
        np.testing.assert_array_equal(v, port[f"params/{k}"], err_msg=k)


def test_bf16_run_resumes_from_its_hp_yaml_under_its_policy(case):
    """An interrupted ``param_dtype="bfloat16"`` run: ``from_checkpoint``
    reads the policy from its hp.yaml and finishes epoch 2 with f32 master
    parameters and finite losses."""
    _, port, _ = case
    assert str(port["bf16_resume/policy"]) == "torch.bfloat16"
    assert port["bf16_resume/end"].tolist() == [2, 2]
    assert np.all(np.isfinite(port["bf16_resume/losses"]))
    assert port["bf16_resume/dtypes"].tolist() == ["torch.float32"]


@pytest.mark.parametrize("name,torch_name", [("float32", "highest"), ("tensorfloat32", "high"),
                                             ("bfloat16", "medium")])
def test_matmul_precision_is_set_for_each_step_and_restored(case, name, torch_name):
    """JAX's matmul precision names (``train_loops.py:337-342,410-414``) map
    to torch's for every step's forward; the value set before the run
    ("high") is back after it."""
    _, port, _ = case
    seen = port[f"matmul/{name}"].tolist()
    assert seen[:-1] and set(seen[:-1]) == {torch_name}, seen
    assert seen[-1] == "high"


@pytest.mark.parametrize("key", ["steps_per_dispatch", "flat_optimizer"])
def test_tpu_dispatch_kwargs_are_no_ops(case, key):
    """``steps_per_dispatch`` (``train_loops.py:788``) and ``flat_optimizer``
    (``:568``) group TPU dispatches and lay out the optimizer state for XLA:
    the port accepts them and trains exactly as without them."""
    _, port, _ = case
    np.testing.assert_array_equal(port[f"noop/{key}"], port["losses"])


@pytest.mark.parametrize("key", ["remat", "data_parallel", "n_model", "fsdp", "loss_logs_file",
                                 "MONITOR_TRAINING"])
def test_unported_trainer_kwargs_raise(case, key):
    _, port, _ = case
    msg = str(port[f"unported/{key}"])
    assert msg.startswith("NotImplementedError") and key in msg, msg


# -- the stateless nets through TrainARMLoop -----------------------------------------

STATELESS = ("wavenet", "transformer", "jukebox")


def _stateless_net(kind, ds):
    """A small net of ``kind`` bound to ``ds``, dropout 0, with parameters
    drawn from a numpy seed (N(0, 0.1); norm scales 1 + that)."""
    import jax.numpy as jnp

    emb = "embedding" if kind != "jukebox" else "framed_linear"
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=Q, mlp_dim=H,
                                                      input_module_type=emb),
                             extractor=ds.extractors[0])
    if kind == "wavenet":
        net = mmk.WaveNet.from_config(mmk.WaveNet.Config(
            io_spec=io, blocks=(3,), dims_dilated=(H,), skips_dim=H, residuals_dim=H,
            pad_side=0))
        length = net.rf + 1
    elif kind == "transformer":
        net = mmk.SimpleTransformer.from_config(mmk.SimpleTransformer.Config(
            io_spec=io, model_dim=32, n_heads=4, feedforward_dim=64, num_layers=2, rf=16,
            input_dropout=0.0))
        length = 16
    else:
        net = mmk.JukeBox.from_config(mmk.JukeBox.Config(
            io_spec=io, frame_sizes=(8, 4, 2), model_dim=32, n_heads=4, feedforward_dim=64,
            num_layers=2, rf=16, input_dropout=0.0))
        length = net._window_len()
    net.seed(0)
    shapes = jax.eval_shape(
        lambda k: net.module.init({"params": k, "dropout": k, "sample": k},
                                  (jnp.zeros((1, length), jnp.int32),), None, True),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(3)

    def draw(path, s):
        key = jax.tree_util.keystr(path)
        return jnp.asarray(rng.standard_normal(s.shape) * 0.1 + ("scale" in key), jnp.float32)

    net.params = jax.tree_util.tree_map_with_path(draw, shapes)
    return net


@pytest.fixture(scope="module")
def stateless(tmp_path_factory):
    """Three f32 steps of the JAX TrainARMLoop for each stateless net, from
    the weights the port gets; the port trains the same nets in one
    subprocess (``torch_port_worker.py train_stateless``)."""
    work = str(tmp_path_factory.mktemp("train_stateless"))
    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    jx, inp = {}, {"work": np.array(work), "wav": np.array(wav), "jax_h5": np.array(ds.filename)}
    for kind in STATELESS:
        net = _stateless_net(kind, ds)
        cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, f"jax_{kind}"), **TRAIN)
        inp[f"{kind}/net_yaml"] = np.array(net.config.serialize())
        inp[f"{kind}/train_yaml"] = np.array(cfg.serialize())
        inp.update(flatten(jax.device_get(net.params), f"{kind}/params0/"))
        loop = mmk.TrainARMLoop.from_config(cfg, db, net)
        logged = []
        log_output = loop.metrics.log_output
        loop.metrics.log_output = (
            lambda d, logged=logged, f=log_output: logged.append(dict(d)) or f(d))
        loop.run()
        jx[kind] = np.array([d["loss"] for d in logged])
    db.close()
    return jx, run_port("train_stateless", inp, work)


@pytest.mark.parametrize("kind", STATELESS)
def test_stateless_net_losses_per_step_match_jax_loop(stateless, kind):
    """WaveNet, SimpleTransformer and JukeBox carry no hidden state: the
    port's loop calls them without one, and three f32 steps give the JAX
    loop's losses."""
    jx, port = stateless
    assert jx[kind].shape == port[f"{kind}/losses"].shape == (3,)
    assert np.all(np.isfinite(port[f"{kind}/losses"]))
    np.testing.assert_allclose(port[f"{kind}/losses"], jx[kind], rtol=1e-4)
