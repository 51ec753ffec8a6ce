"""Weight norm in the port (``modules/weight_norm.py``) against flax's
``nn.WeightNorm``, and the main path's recipe net on the CPU.

* the effective weight and its gradients: a ``WeightNormDense`` against
  ``nn.WeightNorm(nn.Dense)`` and the port's weight-normed LSTM step against
  ``nn.WeightNorm(nn.OptimizedLSTMCell)``, at three seeds each, with random
  scales: outputs and the gradients of x (and the carry), the bias, ``_g``
  (flax's scale) and ``_v`` (flax's kernel), within 1e-5;
* ``mimikit_tpu/demos/srnn.py``'s net at a small width (its eight tiers,
  frame sizes (256, 128, 64, 32, 16, 8, 4, 8), ``weight_norm=True``,
  compression 0.5, a Mish head with no hidden layer, ``min_temperature``
  1e-3; hidden and head width 16), the JAX weights with random scales
  carried by ``weights.py``: the state_dict's names and the map back; the
  forward's logits within 1e-5; the first step's gradients of every ``_g``
  and ``_v`` against JAX's scale and kernel gradients (``rtol=1e-3, atol=1e-5
  * max|g|``, as ``tests/test_torch_train.py``); three ``TrainARMLoop`` steps
  from the same weights, losses per step within ``rtol=1e-4`` (the same
  file's tolerance); the decode kernel's gate admits the net (JAX's
  refuses it and runs its scan);
* the banks both ways: the JAX loop's ``epoch=3.ckpt`` opens in the port and
  decodes the argmax tokens JAX decodes from the same parameters (the
  plain twin of K1 and of K2, chunked); the port loop's ``epoch=3.ckpt``
  opens in ``mimikit_tpu`` with the port's final parameters, its scales and
  kernels under flax's names.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py weight_norm``).
"""
import os

import numpy as np
import pytest
from scipy.io import wavfile

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk

from tests.torch_port_harness import flatten, run_port

SR, H = 16000, 16
FS = (256, 128, 64, 32, 16, 8, 4, 8)
SEEDS = (0, 1, 2)
DENSE = dict(B=3, D=5, O=7)
CELL = dict(B=3, H=6)
N_STEPS = 64
TRAIN = dict(batch_size=2, batch_length=512, tbptt_chunk_length=2048, max_epochs=3,
             limit_train_batches=1, MONITOR_TRAINING=False, every_n_epochs=1,
             trainer_kwargs={"data_seed": 5})
TOL = dict(rtol=1e-5, atol=1e-5)


def _random_scales(tree, rng):
    """``tree`` with every weight-norm scale drawn from U(0.5, 1.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            scales = k.startswith("WeightNorm_") or k.startswith("cells_")
            out[k] = ({s: rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
                       for s, x in v.items()} if scales else _random_scales(v, rng))
        else:
            out[k] = np.asarray(v)
    return out


def _wn_cases(rng):
    """flax's WeightNorm on a Dense and on an OptimizedLSTMCell at each seed:
    the inputs and parameters (port side) and JAX's outputs and gradients."""
    import flax.linen as nn

    # wrapped inside a parent, as in the nets: the kernels under the layer's
    # name, the scales in a sibling WeightNorm_0
    class Dense(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.WeightNorm(nn.Dense(DENSE["O"]))(x)

    class Cell(nn.Module):
        @nn.compact
        def __call__(self, carry, x):
            return nn.WeightNorm(nn.OptimizedLSTMCell(CELL["H"], name="l0"))(carry, x)

    inp, jx = {}, {}
    for seed in SEEDS:
        # a Dense
        p = f"dense/{seed}/"
        layer = Dense()
        x = rng.standard_normal((DENSE["B"], DENSE["D"])).astype(np.float32)
        gy = rng.standard_normal((DENSE["B"], DENSE["O"])).astype(np.float32)
        params = _random_scales(jax.device_get(
            layer.init(jax.random.PRNGKey(seed), x)["params"]), rng)
        params["Dense_0"]["bias"] = rng.standard_normal(DENSE["O"]).astype(np.float32)

        def loss(params, x):
            y = layer.apply({"params": params}, x)
            return (y * gy).sum(), y

        (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
        scale = params["WeightNorm_0"]["Dense_0/kernel/scale"]
        inp.update({p + "x": x, p + "gy": gy, p + "g": scale,
                    p + "v": params["Dense_0"]["kernel"].T, p + "b": params["Dense_0"]["bias"]})
        jx.update({p + "y": np.asarray(y), p + "grad_x": np.asarray(gx),
                   p + "grad_g": np.asarray(gp["WeightNorm_0"]["Dense_0/kernel/scale"]),
                   p + "grad_v": np.asarray(gp["Dense_0"]["kernel"]).T,
                   p + "grad_b": np.asarray(gp["Dense_0"]["bias"])})
        # an OptimizedLSTMCell (flax's carry is (c, h))
        p = f"cell/{seed}/"
        B, Hc = CELL["B"], CELL["H"]
        cell = Cell()
        f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
        x, c, h, gc, gh = f(B, Hc), f(B, Hc), f(B, Hc), f(B, Hc), f(B, Hc)
        params = _random_scales(jax.device_get(
            cell.init(jax.random.PRNGKey(seed), (c, h), x)["params"]), rng)
        for g in "ifgo":
            params["l0"][f"h{g}"]["bias"] = f(Hc) * 0.5

        def loss(params, x, c, h):
            (c2, h2), _ = cell.apply({"params": params}, (c, h), x)
            return (c2 * gc).sum() + (h2 * gh).sum(), (c2, h2)

        (_, (c2, h2)), (gp, gx, gc0, gh0) = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True)(params, x, c, h)
        coll = "WeightNorm_0"
        inp.update({p + "x": x, p + "c": c, p + "h": h, p + "gc": gc, p + "gh": gh})
        for q in "ih":
            inp[f"{p}v_{q}"] = np.concatenate([params["l0"][f"{q}{g}"]["kernel"].T for g in "ifgo"])
            inp[f"{p}g_{q}"] = np.concatenate([params[coll][f"l0/{q}{g}/kernel/scale"]
                                               for g in "ifgo"])
            jx[f"{p}grad_v_{q}"] = np.concatenate(
                [np.asarray(gp["l0"][f"{q}{g}"]["kernel"]).T for g in "ifgo"])
            jx[f"{p}grad_g_{q}"] = np.concatenate(
                [np.asarray(gp[coll][f"l0/{q}{g}/kernel/scale"]) for g in "ifgo"])
        inp[p + "b"] = np.concatenate([params["l0"][f"h{g}"]["bias"] for g in "ifgo"])
        jx.update({p + "c2": np.asarray(c2), p + "h2": np.asarray(h2), p + "grad_x": np.asarray(gx),
                   p + "grad_c": np.asarray(gc0), p + "grad_h": np.asarray(gh0),
                   p + "grad_b": np.concatenate([np.asarray(gp["l0"][f"h{g}"]["bias"])
                                                 for g in "ifgo"])})
    return inp, jx


def _wav(path):
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    y = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(SR)
    wavfile.write(path, SR, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from mimikit_tpu.ops.pallas_decode import supports_pallas_decode

    work = str(tmp_path_factory.mktemp("weight_norm"))
    rng = np.random.default_rng(19)
    inp, jx = _wn_cases(rng)

    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    io = mmk.IOSpec.mulaw_io(
        mmk.IOSpec.MuLawIOConfig(sr=SR, compression=0.5, mlp_dim=H, n_mlp_layers=0,
                                 min_temperature=1e-3),
        extractor=ds.extractors[0])
    net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(
        rnn_class="lstm", n_rnn=1, frame_sizes=FS, hidden_dim=H, weight_norm=True, io_spec=io))
    net.seed(0)
    net.init_params()
    params0 = _random_scales(jax.device_get(net.params), rng)
    net.params = jax.tree_util.tree_map(jnp.asarray, params0)
    jx["kernel_gate"] = bool(supports_pallas_decode(net))
    cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, "jax_tr"), **TRAIN)

    # the forward and the first step's gradients on the loop's first batch
    inputs, targets = next(iter(mmk.TrainARMLoop.get_dataloader(db, net, cfg)))
    key = jax.random.PRNGKey(0)

    @jax.jit
    def step(p):
        def loss(p):
            outputs, _ = net.module.apply({"params": p}, inputs, None, True,
                                          rngs={"dropout": key, "sample": key})
            return io.loss_fn(outputs, targets)["loss"], outputs[0]

        return jax.value_and_grad(loss, has_aux=True)(p)

    (_, logits), grads = step(net.params)
    jx["logits"] = np.asarray(logits)
    jx["grads0"] = flatten(jax.device_get(grads))

    loop = mmk.TrainARMLoop.from_config(cfg, db, net)
    logged = []
    log_output = loop.metrics.log_output
    loop.metrics.log_output = lambda d: logged.append(dict(d)) or log_output(d)
    loop.run()
    jx["losses"] = np.array([d["loss"] for d in logged])
    prompt = np.random.default_rng(1).integers(0, 256, (2, 2 * FS[0])).astype(np.int32)
    jx["tokens"] = np.asarray(net.generate((prompt,), n_steps=N_STEPS, temperature=None)[0])
    db.close()  # the port opens the same file
    inp.update({
        "work": np.array(work), "wav": np.array(wav), "jax_h5": np.array(ds.filename),
        "net_yaml": np.array(net.config.serialize()), "train_yaml": np.array(cfg.serialize()),
        "jax_bank_root": np.array(cfg.root_dir), "jax_bank_id": np.array(loop.hash_),
        "prompt": prompt, "n_steps": np.array(N_STEPS), "first_in": np.asarray(inputs[0]),
        "first_tgt": np.asarray(targets[0]), **flatten(params0, "params0/"),
    })
    jx["params"] = flatten(jax.device_get(net.params))
    return jx, run_port("weight_norm", inp, work)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["y", "grad_x", "grad_g", "grad_v", "grad_b"])
def test_weight_norm_dense_matches_flax(case, seed, name):
    jx, port = case
    k = f"dense/{seed}/{name}"
    np.testing.assert_allclose(port[k], jx[k], **TOL, err_msg=k)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["c2", "h2", "grad_x", "grad_c", "grad_h", "grad_b",
                                  "grad_g_i", "grad_v_i", "grad_g_h", "grad_v_h"])
def test_weight_norm_lstm_cell_matches_flax(case, seed, name):
    """Each of the cell's eight gate kernels normalised per unit is each row
    of the port's packed i|f|g|o matrices."""
    jx, port = case
    k = f"cell/{seed}/{name}"
    np.testing.assert_allclose(port[k], jx[k], **TOL, err_msg=k)


def test_recipe_net_state_dict_names(case):
    """``_g`` (out,) and ``_v`` in torch's layout where JAX wraps a layer
    (the upper tiers' input denses, the LSTMs, the up-samplers, the head),
    the bottom tier's conv plain; the map to flax's tree and back is exact."""
    _, port = case
    keys = set(port["state_dict_keys"].tolist())
    n = len(FS) - 1
    for i in range(n):
        for w in (f"tiers.{i}.input_module.heads.0.2.weight", f"tiers.{i}.up_sampler.fc.weight",
                  f"tiers.{i}.rnn.weight_ih_l0", f"tiers.{i}.rnn.weight_hh_l0"):
            assert {w + "_g", w + "_v"} <= keys and w not in keys, w
    for k in (0, 2):
        w = f"output_modules.0.estimator.0.fc.{k}.weight"
        assert {w + "_g", w + "_v"} <= keys and w not in keys, w
    assert f"tiers.{n}.input_module.heads.0.2.2.cv.weight" in keys
    assert not any(k.endswith(("_g", "_v")) and k.startswith(f"tiers.{n}.") for k in keys)
    assert bool(port["round_trip"])


def test_recipe_net_gates(case):
    """The port's decode gate admits the weight-normed net (it decodes the
    effective weights); JAX's refuses it (``pallas_decode.py:77``)."""
    jx, port = case
    assert bool(port["kernel_gate"]) and not jx["kernel_gate"]


def test_recipe_net_forward_matches_jax(case):
    jx, port = case
    assert port["logits"].shape == jx["logits"].shape
    np.testing.assert_allclose(port["logits"], jx["logits"], **TOL)


def test_recipe_net_first_step_gradients_match_jax(case):
    """Every gradient, ``_g`` against JAX's scale and ``_v`` against its
    kernel among them."""
    jx, port = case
    assert any("WeightNorm_" in k for k in jx["grads0"]) and any(
        "cells_" in k for k in jx["grads0"])
    assert set(jx["grads0"]) == {k[len("grads0/"):] for k in port if k.startswith("grads0/")}
    for k, g in jx["grads0"].items():
        np.testing.assert_allclose(port[f"grads0/{k}"], g, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(g).max()), err_msg=k)


def test_recipe_net_losses_per_step_match_jax_loop(case):
    jx, port = case
    assert jx["losses"].shape == port["losses"].shape == (3,)
    np.testing.assert_allclose(port["losses"], jx["losses"], rtol=1e-4)


def test_jax_bank_of_the_recipe_net_decodes_the_same_argmax_tokens(case):
    """JAX's ``epoch=3.ckpt`` in the port: its parameters are the JAX loop's
    final ones, and the port decodes JAX's argmax tokens from them (at B=2
    through the plain twins of ``decode_single`` and of ``decode_chunk``)."""
    jx, port = case
    for k, v in jx["params"].items():
        np.testing.assert_array_equal(port[f"jax_bank_params/{k}"], v, err_msg=k)
    assert len(set(jx["tokens"][:, 2 * FS[0]:].ravel().tolist())) > 4  # a varied decode
    for how in ("single", "chunked"):
        np.testing.assert_array_equal(port[f"jax_bank_tokens/{how}"], jx["tokens"], err_msg=how)


def test_port_bank_of_the_recipe_net_opens_in_jax(case):
    _, port = case
    bank = mmk.Checkpoint(id=str(port["port_bank_id"]), epoch=3,
                          root_dir=str(port["port_bank_root"]))
    net = bank.network
    assert net.config.weight_norm and tuple(net.config.frame_sizes) == FS
    params = flatten(jax.device_get(net.params))
    assert set(params) == {k[len("params/"):] for k in port if k.startswith("params/")}
    for k, v in params.items():
        np.testing.assert_array_equal(v, port[f"params/{k}"], err_msg=k)
