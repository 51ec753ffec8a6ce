"""The port's Seq2SeqLSTMNetwork and FreqNet against the JAX package, on
the CPU (model_dim 16, n_fft 64, hop_length 16: 33 bins).

* ``EncoderLSTM`` for every down-sampling mode (``edge_sum``, ``edge_mean``,
  ``sum``, ``mean``, ``linear_resample``) and under ``ref_compat`` (the
  reference's adjacent-pair direction sum), bidirectional layers with
  residuals (two for ``edge_sum`` and ``ref_compat``, one for the other
  modes), 33 bins in: the code frame and both directions' final (h, c);
  ``DecoderLSTM`` for ``repeat``, ``linear_resample`` and ``interp``
  (``jax.image.resize`` against ``F.interpolate``, at hop 2, 4 and 8) and
  under ``ref_compat`` (the carry seeding every layer), from a non-zero
  encoder carry;
* the demo's structure (``edge_sum``/``repeat``, 2 + 2 layers, residuals)
  as one net: its train forward and the gradients of ``sum(y * ct)`` with
  respect to the input and every parameter (the encoder's through the
  decoder's seeded carry), at B=8 (the "cluster" route: on the CPU the
  fused layer's plain versions); its block-autoregressive ``generate``
  against JAX's scan (frames are deterministic: no argmax);
* three ``TrainARMLoop`` steps of that net and of FreqNet (``WaveNet`` on
  frames, groups 8) from the same weights on the JAX-written store, the
  reconstruction loss (``MeanL1Prop``), losses per step ``rtol=1e-4`` (as
  the stateless nets in ``tests/test_torch_train.py``);
* the weight maps: ``seq2seq_state_dict_from_jax`` then
  ``seq2seq_params_to_jax`` gives the tree back; a ``ref_compat`` net's
  state_dict through ``mimikit_tpu/migrate.py:seq2seq_params_from_state_dict``
  gives its JAX parameters; a bank written by the port reloads in the port
  with the same state_dict and holds the JAX tree;
* FreqNet's train forward, and its frame ``generate`` against JAX's
  ``WaveNet.generate`` on frames (its scan decoder); ``supports_kernel_decode``
  refuses FreqNet without a warning.

Tolerance: values within ``rtol=1e-5`` and ``atol=1e-5 * max|JAX|`` (f32
summed in another order).  JAX runs in this process with one jitted apply
a configuration and parameters drawn with ``jax.eval_shape`` and numpy; the
port in one subprocess (``torch_port_worker.py seq2seq``).
"""
import json
import os

import numpy as np
import pytest
from scipy.io import wavfile

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk
from mimikit_tpu.migrate import seq2seq_params_from_state_dict
from mimikit_tpu.networks.s2s_lstm import DecoderLSTM, EncoderLSTM

from tests.torch_port_harness import flatten, run_port

SR, N_FFT, HOP_LENGTH = 16000, 64, 16
F_BINS, D, HOP, B = 1 + N_FFT // 2, 16, 4, 8
STD = 0.2
RTOL = 1e-5
# the variants: two layers where the layer count matters (the residuals from the second
# layer on, ref_compat's carry seeding every decoder layer), one for the re-samplings
ENCODERS = {m: dict(downsampling=m, num_layers=1) for m in ("edge_mean", "sum", "mean",
                                                           "linear_resample")}
ENCODERS["edge_sum"] = dict(downsampling="edge_sum", num_layers=2)
ENCODERS["edge_sum_ref_compat"] = dict(downsampling="edge_sum", num_layers=2, ref_compat=True)
DECODERS = {"repeat": dict(upsampling="repeat", num_layers=2),
            "linear_resample": dict(upsampling="linear_resample", num_layers=1),
            "interp_hop2": dict(upsampling="interp", hop=2, num_layers=1),
            "interp_hop4": dict(upsampling="interp", num_layers=1),
            "interp_hop8": dict(upsampling="interp", hop=8, num_layers=1),
            "repeat_ref_compat": dict(upsampling="repeat", num_layers=2, ref_compat=True)}
DEMO = dict(enc_downsampling="edge_sum", enc_n_lstm=2, enc_apply_residuals=True,
            dec_upsampling="repeat", dec_n_lstm=2, dec_apply_residuals=True)
TRAIN = dict(batch_size=4, max_epochs=3, limit_train_batches=1, MONITOR_TRAINING=False,
             CHECKPOINT_TRAINING=False, every_n_epochs=1, trainer_kwargs={"data_seed": 5})
FREQNET = dict(kernel_sizes=(2,), blocks=(3,), dims_dilated=(32,), apply_residuals=False,
               residuals_dim=None, skips_dim=None, groups=8, pad_side=0,
               use_fast_generate=False)
N_GEN = 10
# a gradient of each kind, each its own case (all of them: the test after)
GRAD_NAMES = ["grad_x", "enc/lstm0/fwd/l0/ii/kernel", "enc/lstm0/bwd/l0/hg/kernel",
              "enc/lstm1/fwd/l0/ho/bias", "enc/fc_out/kernel", "dec/lstm0/bwd/l0/if/kernel",
              "dec/lstm1/fwd/l0/hi/kernel", "output_heads_0/core/Dense_0/kernel"]


def close(got, want, name=""):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(1e-30, float(np.abs(want).max())), err_msg=name)


def _draw(shapes, rng):
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape) * STD, jnp.float32), shapes)


def _wav(path):
    t = np.arange(SR) / SR
    rng = np.random.default_rng(0)
    y = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(SR)
    wavfile.write(path, SR, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))


def _net(cls, io, seed, length, **kw):
    """A net of ``cls`` on ``io``, its parameters drawn from a numpy seed."""
    net = cls.from_config(cls.Config(io_spec=io, **kw))
    net.seed(0)
    x = jnp.zeros((1, length, F_BINS), jnp.float32)
    shapes = jax.eval_shape(
        lambda k: net.module.init({"params": k, "dropout": k, "sample": k}, (x,), None, True),
        jax.random.PRNGKey(0))["params"]
    net.params = _draw(shapes, np.random.default_rng(seed))
    return net


def _modes(rng, inp):
    """Every encoder and decoder variant, applied in one jitted function."""
    mods, params, args = {}, {}, {}
    for tag, kw in ENCODERS.items():
        kw = dict(input_dim=F_BINS, output_dim=D, hop=HOP, apply_residuals=True, **kw)
        mods[f"enc/{tag}"] = EncoderLSTM(**kw)
        x = np.abs(rng.standard_normal((3, HOP, F_BINS))).astype(np.float32)
        args[f"enc/{tag}"] = (x,)
        inp[f"enc/{tag}/kw"], inp[f"enc/{tag}/x"] = np.array(json.dumps(kw)), x
    for tag, kw in DECODERS.items():
        kw = {"model_dim": D, "hop": HOP, "apply_residuals": True, **kw}
        mods[f"dec/{tag}"] = DecoderLSTM(**kw)
        x = rng.standard_normal((3, 1, D)).astype(np.float32)
        h0, c0 = (rng.standard_normal((2, 3, D)).astype(np.float32) * 0.5 for _ in range(2))
        args[f"dec/{tag}"] = (x, (h0, c0))
        inp.update({f"dec/{tag}/kw": np.array(json.dumps(kw)), f"dec/{tag}/x": x,
                    f"dec/{tag}/h0": h0, f"dec/{tag}/c0": c0})
    for key, m in mods.items():
        shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), *args[key])["params"]
        params[key] = _draw(shapes, rng)
        inp.update(flatten(jax.device_get(params[key]), f"{key}/params/"))

    @jax.jit
    def run(params, args):
        return {k: m.apply({"params": params[k]}, *args[k]) for k, m in mods.items()}

    out = {}
    for key, res in run(params, args).items():
        if key.startswith("enc/"):
            y, (h, c) = res
            out[f"{key}/y"], out[f"{key}/h"], out[f"{key}/c"] = map(np.asarray, (y, h, c))
        else:
            out[f"{key}/y"] = np.asarray(res)
    return out


def _losses(loop):
    logged = []
    log_output = loop.metrics.log_output
    loop.metrics.log_output = lambda d: logged.append(dict(d)) or log_output(d)
    loop.run()
    return np.array([d["loss"] for d in logged])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("seq2seq"))
    rng = np.random.default_rng(20)
    inp = {"work": np.array(work)}
    jx = _modes(rng, inp)
    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    io = mmk.IOSpec.magspec_io(
        mmk.IOSpec.MagSpecIOConfig(sr=SR, n_fft=N_FFT, hop_length=HOP_LENGTH,
                                   activation="Identity"), extractor=ds.extractors[0])
    # the demo's structure: forward and gradients, generate
    net = _net(mmk.Seq2SeqLSTMNetwork, io, 1, HOP, model_dim=D, hop=HOP, **DEMO)
    x = np.abs(rng.standard_normal((B, HOP, F_BINS))).astype(np.float32)
    ct = rng.standard_normal((B, HOP, F_BINS)).astype(np.float32)

    def loss(p, x):
        y = net.module.apply({"params": p}, (x,), None, True)[0][0]
        return (y * ct).sum(), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        net.params, jnp.asarray(x))
    jx.update({"net/y": np.asarray(y), "net/grad_x": np.asarray(gx)})
    jx.update(flatten(jax.device_get(gp), "net/grad/"))
    prompt = np.abs(rng.standard_normal((2, 6, F_BINS))).astype(np.float32)
    jx["net/generate"] = np.asarray(net.generate((prompt,), N_GEN)[0])
    jx["net/params"] = flatten(jax.device_get(net.params))
    inp.update({"net/yaml": np.array(net.config.serialize()), "net/x": x, "net/ct": ct,
                "net/prompt": prompt, "net/n_steps": np.array(N_GEN)})
    inp.update(flatten(jax.device_get(net.params), "net/params/"))
    # a ref_compat net (its state_dict goes through migrate)
    rc = _net(mmk.Seq2SeqLSTMNetwork, io, 2, HOP, model_dim=D, hop=HOP, ref_compat=True,
              enc_downsampling="linear_resample", dec_upsampling="linear_resample")
    inp["rc/yaml"] = np.array(rc.config.serialize())
    inp.update(flatten(jax.device_get(rc.params), "rc/params/"))
    jx["rc/params"] = flatten(jax.device_get(rc.params))
    jx["rc/net"] = rc
    # three TrainARMLoop steps of each net
    for kind, cls, length, kw in (("seq2seq", mmk.Seq2SeqLSTMNetwork, HOP,
                                   dict(model_dim=D, hop=HOP, **DEMO)),
                                  ("freqnet", mmk.WaveNet, 12, FREQNET)):
        n = _net(cls, io, 3, length, **kw)
        cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, f"jax_{kind}"),
                                 batch_length=length, **TRAIN)
        inp[f"{kind}/yaml"] = np.array(n.config.serialize())
        inp[f"{kind}/train_yaml"] = np.array(cfg.serialize())
        inp.update(flatten(jax.device_get(n.params), f"{kind}/params/"))
        jx[f"{kind}/losses"] = _losses(mmk.TrainARMLoop.from_config(cfg, db, n))
    db.close()
    inp.update({"wav": np.array(wav), "jax_h5": np.array(ds.filename)})
    # FreqNet: train forward and frame generate
    fq = _net(mmk.WaveNet, io, 4, 12, **FREQNET)
    xf = np.abs(rng.standard_normal((2, 12, F_BINS))).astype(np.float32)
    jx["fq/y"] = np.asarray(jax.jit(
        lambda p, x: fq.module.apply({"params": p}, (x,), None, True)[0][0])(fq.params, xf))
    fprompt = np.abs(rng.standard_normal((2, 10, F_BINS))).astype(np.float32)
    jx["fq/generate"] = np.asarray(fq.generate((fprompt,), 6)[0])
    inp.update({"fq/yaml": np.array(fq.config.serialize()), "fq/x": xf, "fq/prompt": fprompt,
                "fq/n_steps": np.array(6)})
    inp.update(flatten(jax.device_get(fq.params), "fq/params/"))
    return jx, run_port("seq2seq", inp, work)


@pytest.mark.parametrize("tag", list(ENCODERS))
@pytest.mark.parametrize("what", ["y", "h", "c"])
def test_encoder_matches_jax(case, tag, what):
    jx, port = case
    key = f"enc/{tag}/{what}"
    assert port[key].shape == jx[key].shape
    close(port[key], jx[key], key)


@pytest.mark.parametrize("tag", list(DECODERS))
def test_decoder_matches_jax(case, tag):
    jx, port = case
    key = f"dec/{tag}/y"
    assert port[key].shape == jx[key].shape
    close(port[key], jx[key], key)


def test_net_takes_the_fused_layer(case):
    """At B=8, hop 4, model_dim 16 each of the 8 LSTM directions takes the
    "cluster" route: on the CPU the fused layer's plain versions, with their
    written-out backward (dh0, dc0 included)."""
    _, port = case
    assert port["net/routes"].tolist() == ["cluster"] * 8


def test_net_forward_matches_jax(case):
    jx, port = case
    close(port["net/y"], jx["net/y"])


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_net_gradients_match_jax(case, name):
    """The input's and the parameters' gradients: the encoder's reach the
    loss only through the decoder's first layer's seeded carry."""
    jx, port = case
    key = f"net/{name}" if name == "grad_x" else f"net/grad/{name}"
    close(port[key], jx[key], key)


def test_every_net_gradient_matches_jax(case):
    jx, port = case
    names = [k for k in jx if k.startswith("net/grad/")]
    assert len(names) == len([k for k in port if k.startswith("net/grad/")]) > 40
    for key in names:
        close(port[key], jx[key], key)


def test_generate_matches_jax_scan(case):
    jx, port = case
    assert port["net/generate"].shape == (2, 6 + N_GEN, F_BINS)
    close(port["net/generate"], jx["net/generate"])


@pytest.mark.parametrize("kind", ["seq2seq", "freqnet"])
def test_train_loop_losses_match_jax(case, kind):
    jx, port = case
    assert jx[f"{kind}/losses"].shape == port[f"{kind}/losses"].shape == (3,)
    assert np.all(np.isfinite(port[f"{kind}/losses"]))
    np.testing.assert_allclose(port[f"{kind}/losses"], jx[f"{kind}/losses"], rtol=1e-4)


def test_weight_maps_round_trip(case):
    jx, port = case
    back = {k[len("roundtrip/"):]: v for k, v in port.items() if k.startswith("roundtrip/")}
    assert back.keys() == jx["net/params"].keys()
    for k, v in jx["net/params"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_ref_compat_state_dict_migrates_to_its_params(case):
    """The port's names are the reference's: a ref_compat net's state_dict
    goes through the JAX package's migrate to the parameters it came from."""
    jx, port = case
    sd = {k[len("rc/sd/"):]: v for k, v in port.items() if k.startswith("rc/sd/")}
    params = flatten(jax.device_get(seq2seq_params_from_state_dict(jx["rc/net"], sd)))
    assert params.keys() == jx["rc/params"].keys()
    for k, v in jx["rc/params"].items():
        np.testing.assert_allclose(params[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


def test_bank_reloads_and_holds_the_jax_tree(case):
    jx, port = case
    assert bool(port["bank/equal"])
    path = str(port["bank/path"])
    ck = mmk.Checkpoint(*mmk.Checkpoint.get_id_and_epoch(path),
                        root_dir=os.path.dirname(os.path.dirname(path)))
    tree = flatten(ck.state_dict)
    assert tree.keys() == jx["net/params"].keys()
    for k, v in jx["net/params"].items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)


def test_freqnet_forward_matches_jax(case):
    jx, port = case
    assert port["fq/y"].shape == (2, 12 - 8 + 1, F_BINS)
    close(port["fq/y"], jx["fq/y"])


def test_freqnet_generate_matches_jax(case):
    """Frames decoded on the plain step loop: the JAX scan decoder's."""
    jx, port = case
    assert port["fq/generate"].shape == (2, 16, F_BINS)
    close(port["fq/generate"], jx["fq/generate"])


def test_kernel_gate_refuses_freqnet_silently(case):
    _, port = case
    assert not bool(port["fq/in_gate"])
