"""The port's tied autoencoder against the JAX package's, on the CPU.

* ``TiedAE``'s forward with the JAX weights for kernel sizes (3, 5, 7),
  (7, 5, 3) and the even (4,), causal and not, one case with a
  non-negative latent, ``independence_reg=0.25`` (magspec_io frames, n_fft
  64: 33 bins): the output within rtol 1e-5 and atol 1e-5 of its largest
  value, the independence term within 1e-5;
* the weight maps both ways: ``tiedae_params_to_jax`` of the loaded
  state_dict gives back JAX's tree exactly;
* the independence term is dropped by ``IOSpec.loss_fn``'s zip in both
  packages: with ``independence_reg=0.25`` and with None the port's
  gradients are equal bit for bit, and equal JAX's within 1e-5;
* banks both ways: a bank the port writes is read by JAX's ``Checkpoint``
  (its network config and parameter tree), and a JAX bank by the port's
  ``Checkpoint(...).network``, each forward within 1e-5 of the other
  package's;
* ``TrainARMLoop`` trains a ``TiedAE`` monitored by ``EncodeDecodeLoop``
  (``OUTPUT_TRAINING="wav"``) and writes ``epoch=1.ckpt`` and a wav, as
  ``tests/test_tied_autoencoder.py:35-69``;
* ``beta_schedule``'s values within 1e-12, and five steps of the Adam
  whose beta1 follows it against optax's ``inject_hyperparams`` Adam within
  1e-6.

JAX runs in this process (its applies jitted), the port in one subprocess
(``torch_port_worker.py tied_ae``).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk

from tests.torch_port_harness import flatten, start_port

TOL = 1e-5
N_FFT, HOP = 64, 16
CASES = {
    "k357": dict(kernel_sizes=(3, 5, 7), dims=(32, 16, 8)),
    "k357_causal": dict(kernel_sizes=(3, 5, 7), dims=(32, 16, 8), causal_pad=True),
    "k753": dict(kernel_sizes=(7, 5, 3), dims=(32, 16, 8)),
    "k753_causal": dict(kernel_sizes=(7, 5, 3), dims=(32, 16, 8), causal_pad=True),
    "k4": dict(kernel_sizes=(4,), dims=(16,)),
    "k4_causal": dict(kernel_sizes=(4,), dims=(16,), causal_pad=True),
    "k35_nonneg": dict(kernel_sizes=(3, 5), dims=(16, 8), non_negative_latent=True),
}


def _io():
    return mmk.IOSpec.magspec_io(mmk.IOSpec.MagSpecIOConfig(sr=16000, n_fft=N_FFT,
                                                            hop_length=HOP))


def _net(reg=0.25, **kw):
    return mmk.TiedAE.from_config(mmk.TiedAE.Config(io_spec=_io(), independence_reg=reg, **kw))


def _params(net, rng, x):
    """Random parameters of ``net``'s shapes, drawn with numpy."""
    shapes = jax.eval_shape(lambda: net.module.init(
        {"params": jax.random.PRNGKey(0)}, (jnp.asarray(x),), None, True))["params"]
    def draw(s):  # LeCun's scale: outputs of the order of the inputs
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _apply(net):
    return jax.jit(lambda p, x: net.module.apply({"params": p}, (x,), None, True)[0])


def _wav(path, sr=16000, seconds=2.0):
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    y = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.random.default_rng(2).standard_normal(t.size)
    wavfile.write(path, sr, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tied_ae"))
    rng = np.random.default_rng(11)
    x = np.abs(rng.standard_normal((2, 12, 1 + N_FFT // 2))).astype(np.float32)
    target = np.abs(rng.standard_normal((2, 12, 1 + N_FFT // 2))).astype(np.float32)
    inp = {"x": x, "target": target, "work": np.array(work)}
    jx, nets, params = {}, {}, {}
    for tag, kw in CASES.items():
        nets[tag] = _net(**kw)
        params[tag] = _params(nets[tag], rng, x)
        jx[f"{tag}/params"] = flatten(params[tag])
        inp.update(flatten(params[tag], f"ae/{tag}/params/"))
        inp[f"ae/{tag}/yaml"] = np.array(nets[tag].config.serialize())
    # a JAX bank for the port
    bank_net = _net(**CASES["k753"])
    bank_net.params = jax.tree_util.tree_map(jnp.asarray, _params(bank_net, rng, x))
    mmk.Checkpoint(id="jax_ae", epoch=1, root_dir=work).create(network=bank_net)
    nets["bank"], params["bank"] = bank_net, bank_net.params
    # the loss gradient with and without the independence term
    grad_params = _params(_net(**CASES["k357"]), rng, x)
    inp.update(flatten(grad_params, "grad/params/"))
    regs = {"reg": _net(reg=0.25, **CASES["k357"]), "none": _net(reg=None, **CASES["k357"])}
    for reg, net in regs.items():
        inp[f"grad/{reg}/yaml"] = np.array(net.config.serialize())
    inp["bank/yaml"] = np.array(_net(**CASES["k357"]).config.serialize())
    wav = os.path.join(work, "a.wav")
    _wav(wav)
    inp["wav"] = np.array(wav)
    w0 = rng.standard_normal(6).astype(np.float32)
    adam_grads = rng.standard_normal((5, 6)).astype(np.float32)
    inp["adam/w0"], inp["adam/grads"] = w0, adam_grads
    run = start_port("tied_ae", inp, work)  # the port runs while JAX computes

    @jax.jit
    def forwards_and_grads(params, grad_params, x, target):
        # one compile for every case: eager flax ops compile one by one
        out = {tag: net.module.apply({"params": params[tag]}, (x,), None, True)[0]
               for tag, net in nets.items()}
        for reg, net in regs.items():
            def loss(p, net=net):
                outputs, _ = net.module.apply({"params": p}, (x,), None, True)
                return net.config.io_spec.loss_fn(outputs, (target,))["loss"]

            out[f"grad/{reg}"] = jax.value_and_grad(loss)(grad_params)
        return out

    res = forwards_and_grads(params, grad_params, jnp.asarray(x), jnp.asarray(target))
    for tag in CASES:
        jx[f"{tag}/y"], jx[f"{tag}/indp"] = np.asarray(res[tag][0]), np.asarray(res[tag][1])
    jx["bank/jax_y"] = np.asarray(res["bank"][0])
    for reg in regs:
        value_, grads = res[f"grad/{reg}"]
        jx[f"grad/{reg}/loss"], jx[f"grad/{reg}/d"] = np.asarray(value_), flatten(grads)
    # beta_schedule and optax's Adam with b1 injected a step
    from mimikit_tpu.loops.beta_scheduler import adam_with_beta_schedule, beta_schedule

    sched = beta_schedule(max_beta=0.9, total_steps=100, pct_start=0.3)
    jx["beta/values"] = np.array([sched(k) for k in range(101)])
    tx, schedule_fn = adam_with_beta_schedule(1e-2, max_beta=0.9, total_steps=10)
    w = {"w": jnp.asarray(w0)}
    state = tx.init(w)
    for k in range(5):
        state.hyperparams.update({n: jnp.asarray(v) for n, v in schedule_fn(k).items()})
        updates, state = tx.update({"w": jnp.asarray(adam_grads[k])}, state, w)
        w = jax.tree_util.tree_map(lambda p, u: p + u, w, updates)
        jx[f"adam/w{k + 1}"] = np.asarray(w["w"])
    port = run.result()
    # the port's bank, opened by JAX: its config and parameter tree as JAX's
    # Checkpoint reads them (its .network would first init the net eagerly, ~5 s)
    ck = mmk.Checkpoint(id="port_ae", epoch=1, root_dir=work)
    cfg = ck.network_config
    cfg.io_spec.bind_to(ck.dataset_config)
    back = cfg.owner_class.from_config(cfg)
    back.params = jax.tree_util.tree_map(jnp.asarray, ck.state_dict)
    jx["bank/port_y"] = np.asarray(_apply(back)(back.params, jnp.asarray(x))[0])
    jx["bank/port_type"] = type(back).__name__
    return jx, port


@pytest.mark.parametrize("tag", list(CASES))
def test_forward_matches_jax(case, tag):
    jx, port = case
    got, want = port[f"ae/{tag}/y"], jx[f"{tag}/y"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()))
    np.testing.assert_allclose(port[f"ae/{tag}/indp"], jx[f"{tag}/indp"], rtol=TOL, atol=TOL)
    assert float(jx[f"{tag}/indp"]) > 0


def test_even_kernel_lengthens_the_sequence(case):
    """An even kernel pads k // 2 on both sides: each convolution and each
    transposed one adds a frame, in both packages."""
    jx, port = case
    assert port["ae/k4/y"].shape[1] == jx["k4/y"].shape[1] == 12 + 2
    assert port["ae/k4_causal/y"].shape[1] == 12 + 1 + 1


@pytest.mark.parametrize("tag", list(CASES))
def test_weights_both_ways(case, tag):
    jx, port = case
    want = jx[f"{tag}/params"]
    got = {k[len(f"ae/{tag}/back/"):]: v for k, v in port.items()
           if k.startswith(f"ae/{tag}/back/")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_independence_term_is_dropped_from_the_loss(case):
    """``IOSpec.loss_fn`` zips the one target with ``(y, indp)``: the term is
    computed (non-zero) but reaches neither package's loss nor gradient."""
    jx, port = case
    assert float(port["grad/reg/indp"]) > 0 and float(port["grad/none/indp"]) == 0
    np.testing.assert_array_equal(port["grad/reg/loss"], port["grad/none/loss"])
    keys = [k for k in port if k.startswith("grad/reg/d/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(port[k], port[k.replace("/reg/", "/none/")], err_msg=k)
    np.testing.assert_allclose(jx["grad/reg/loss"], jx["grad/none/loss"], rtol=0, atol=0)


def test_gradient_matches_jax(case):
    jx, port = case
    np.testing.assert_allclose(port["grad/reg/loss"], jx["grad/reg/loss"], rtol=TOL, atol=TOL)
    names = {"kernels.0": "w0", "kernels.1": "w1", "kernels.2": "w2",
             "input_modules.0.0.weight": "input_modules_0/core/Dense_0/kernel",
             "output_modules.0.0.weight": "output_modules_0/core/Dense_0/kernel"}
    for ours, theirs in names.items():
        got = port[f"grad/reg/d/{ours}"]
        want = jx["grad/reg/d"][theirs]
        got = got.transpose(2, 1, 0) if ours.startswith("kernels") else got.T
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=ours)


@pytest.mark.parametrize("way", ["jax", "port"])
def test_bank_opened_by_the_other_package(case, way):
    """``jax``: a JAX bank opened by the port; ``port``: the port's bank
    opened by JAX.  Each forward within 1e-5 of the writer's."""
    jx, port = case
    if way == "jax":
        assert str(port["bank/jax_type"]) == "TiedAE"
        np.testing.assert_allclose(port["bank/jax_y"], jx["bank/jax_y"], rtol=TOL, atol=TOL)
    else:
        assert jx["bank/port_type"] == "TiedAE"
        np.testing.assert_allclose(jx["bank/port_y"], port["bank/port_y"], rtol=TOL, atol=TOL)


def test_train_loop_monitors_with_encode_decode_loop(case):
    _, port = case
    assert list(port["train/callbacks"]) == ["MMKCheckpoint", "GenerateCallback"]
    assert str(port["train/monitor"]) == "EncodeDecodeLoop"
    assert "epoch=1.ckpt" in set(port["train/files"])
    assert ".wav" in {os.path.splitext(o)[-1] for o in port["train/outputs"]}
    assert np.isfinite(port["train/losses"]).all() and len(port["train/losses"]) == 1


def test_beta_schedule_values(case):
    jx, port = case
    np.testing.assert_allclose(port["beta/values"], jx["beta/values"], rtol=1e-12, atol=1e-12)
    assert int(np.argmax(port["beta/values"])) == 30


@pytest.mark.parametrize("step", range(1, 6))
def test_beta_scheduled_adam_matches_optax(case, step):
    jx, port = case
    assert str(port["adam/type"]) == "Adam"
    np.testing.assert_allclose(port[f"adam/w{step}"], jx[f"adam/w{step}"], rtol=1e-6, atol=1e-6)
