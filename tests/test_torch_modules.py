"""The port's modules against their JAX counterparts, on the CPU.

JAX computes in this process; the port runs once for the whole module in a
subprocess (``torch_port_worker.py modules``) that builds its SampleRNN from
the YAML ``mimikit_tpu`` wrote and loads the JAX weights through
``samplernn_state_dict_from_jax``.  Tolerances: mu-law bit-exact on the
numpy path and on the integer outputs, 1e-6 on the float torch path; f32
modules ``atol=rtol=1e-5`` (summation order differs between XLA and torch).
"""
import numpy as np
import pytest
from scipy.io import wavfile

import jax
import mimikit_tpu as mmk
from mimikit_tpu.migrate import samplernn_params_from_state_dict
from mimikit_tpu.modules.activations import _mish

from tests.torch_port_harness import flatten, run_port

FRAME_SIZES = (8, 4, 2)
H, Q, B = 16, 32, 3


def _net():
    io = mmk.IOSpec.mulaw_io(
        mmk.IOSpec.MuLawIOConfig(q_levels=Q, mlp_dim=H, n_mlp_layers=1)
    )
    net = mmk.SampleRNN.from_config(
        mmk.SampleRNN.Config(frame_sizes=FRAME_SIZES, hidden_dim=H, io_spec=io)
    )
    net.seed(0)
    net.init_params(batch_size=1)
    return net


def _apply(net, fn, *args):
    return np.asarray(net.module.apply({"params": net.params}, *args, method=fn))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(7)
    net = _net()
    inp = {
        "yaml": np.array(net.config.serialize()),
        "mulaw_x": np.clip(rng.standard_normal(4000).astype(np.float32) * 0.5, -1, 1),
        "mulaw_tokens": rng.integers(0, 256, 4000).astype(np.int64),
        "mish_x": (rng.standard_normal(1000) * 4).astype(np.float32),
        "mlp_x": rng.standard_normal((B, 5, H)).astype(np.float32),
    }
    inp.update(flatten(jax.device_get(net.params), "params/"))
    inp["signal_x"] = (rng.standard_normal((2, 500)) * 3).astype(np.float32)
    wav = tmp_path_factory.mktemp("wav") / "tone.wav"
    tone = 0.5 * np.sin(2 * np.pi * 440 * np.arange(4000) / 16000)
    wavfile.write(str(wav), 16000, (tone * 32767).astype(np.int16))
    inp["wav_path"] = np.array(str(wav))
    jx = {}
    for i, f in enumerate(FRAME_SIZES):
        x = rng.integers(0, Q, (B, 3 * f)).astype(np.int32)
        inp[f"tier_in_{i}_x"] = x
        jx[f"tier_in_{i}"] = _apply(net, lambda m, x, i=i: m.tier_inputs[i]((x,)), x)
    for i in range(len(FRAME_SIZES) - 1):
        x, c, h = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(3))
        inp.update({f"rnn_{i}_x": x, f"rnn_{i}_c": c, f"rnn_{i}_h": h})
        y, ((c2, h2),) = net.module.apply(
            {"params": net.params}, x, ((c, h),),
            method=lambda m, x, carry, i=i: m.rnns[i].step(x, carry),
        )
        jx[f"rnn_{i}_y"], jx[f"rnn_{i}_c2"], jx[f"rnn_{i}_h2"] = map(np.asarray, (y, c2, h2))
        ux = rng.standard_normal((B, 1, H)).astype(np.float32)
        inp[f"up_{i}_x"] = ux
        jx[f"up_{i}"] = _apply(net, lambda m, x, i=i: m.upsamplers[i](x), ux)
    jx["mlp"] = _apply(net, lambda m, x: m.outputs[0](x, train=True), inp["mlp_x"])
    jx["head_argmax"] = _apply(
        net, lambda m, x: m.outputs[0](x, train=False, temperature=None), inp["mlp_x"]
    )
    port = run_port("modules", inp, str(tmp_path_factory.mktemp("port_modules")))
    return net, inp, jx, port


def test_mulaw_compress_numpy_is_bit_exact(case):
    _, inp, _, port = case
    ref = mmk.MuLawCompress(256, 0.7)(inp["mulaw_x"])
    assert np.array_equal(port["mulaw_compress_np"], np.asarray(ref))


def test_mulaw_compress_torch_matches_jax_path(case):
    _, inp, _, port = case
    ref = mmk.MuLawCompress(256, 0.7)(jax.numpy.asarray(inp["mulaw_x"]))
    assert np.array_equal(port["mulaw_compress_torch"], np.asarray(ref))


def test_mulaw_expand_numpy_is_bit_exact(case):
    _, inp, _, port = case
    ref = mmk.MuLawExpand(256, 0.7)(inp["mulaw_tokens"])
    assert np.array_equal(port["mulaw_expand_np"], np.asarray(ref))


def test_mulaw_expand_torch_matches_jax_path(case):
    _, inp, _, port = case
    ref = mmk.MuLawExpand(256, 0.7)(jax.numpy.asarray(inp["mulaw_tokens"]))
    np.testing.assert_allclose(port["mulaw_expand_torch"], np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", ["np", "torch"])
def test_normalize_matches_jax(case, path):
    _, inp, _, port = case
    ref = mmk.Normalize()(inp["signal_x"])
    assert np.array_equal(port[f"normalize_{path}"], np.asarray(ref))


@pytest.mark.parametrize("path", ["np", "torch"])
def test_remove_dc_matches_jax_numpy_path(case, path):
    _, inp, _, port = case
    ref = mmk.RemoveDC()(inp["signal_x"])
    assert np.array_equal(port[f"remove_dc_{path}"], np.asarray(ref))


def test_file_to_signal_reads_wav_like_jax(case):
    _, inp, _, port = case
    ref = mmk.FileToSignal(16000)(str(inp["wav_path"]))
    assert np.array_equal(port["file_to_signal"], np.asarray(ref))


def test_mish_matches_jax(case):
    _, inp, _, port = case
    ref = np.asarray(_mish(jax.numpy.asarray(inp["mish_x"])))
    np.testing.assert_allclose(port["mish"], ref, rtol=1e-5, atol=1e-5)


def test_mlp_head_with_learned_temperature_matches_jax(case):
    _, _, jx, port = case
    np.testing.assert_allclose(port["mlp"], jx["mlp"], rtol=1e-5, atol=1e-5)


def test_output_wrapper_argmax_matches_jax(case):
    """Eval mode: the head's CategoricalSampler without temperature is argmax."""
    _, _, jx, port = case
    assert np.array_equal(port["head_argmax"], jx["head_argmax"])


@pytest.mark.parametrize("tier", range(len(FRAME_SIZES)))
def test_tier_input_module_matches_jax(case, tier):
    _, _, jx, port = case
    key = f"tier_in_{tier}"
    assert port[key].shape == jx[key].shape
    np.testing.assert_allclose(port[key], jx[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tier", range(len(FRAME_SIZES) - 1))
@pytest.mark.parametrize("what", ["y", "c2", "h2"])
def test_lstm_step_matches_flax_cell(case, tier, what):
    _, _, jx, port = case
    key = f"rnn_{tier}_{what}"
    np.testing.assert_allclose(port[key], jx[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tier", range(len(FRAME_SIZES) - 1))
def test_linear_upsampler_matches_jax(case, tier):
    _, _, jx, port = case
    key = f"up_{tier}"
    assert port[key].shape == jx[key].shape
    np.testing.assert_allclose(port[key], jx[key], rtol=1e-5, atol=1e-5)


def test_jax_yaml_builds_the_reference_state_dict_names(case):
    """The JAX YAML loads unchanged and builds a net whose state_dict keys are
    exactly what ``migrate.samplernn_params_from_state_dict`` maps."""
    _, _, _, port = case
    keys = set(port["state_dict_keys"].tolist())
    assert keys == {k[len("sd/"):] for k in port if k.startswith("sd/")}
    assert "tiers.0.input_module.heads.0.2.weight" in keys
    assert "tiers.2.input_module.heads.0.2.2.cv.weight" in keys
    assert "tiers.1.rnn.weight_ih_l0" in keys
    assert "output_modules.0.estimator.0.fc.4.weight" in keys


def test_weights_round_trip_through_migrate(case):
    """JAX params -> port state_dict -> migrate -> JAX params, exactly."""
    net, _, _, port = case
    sd = {k[len("sd/"):]: v for k, v in port.items() if k.startswith("sd/")}
    fresh = _net()
    fresh.seed(1)
    fresh.init_params(batch_size=1)
    back = samplernn_params_from_state_dict(fresh, sd)
    a, b = flatten(jax.device_get(net.params)), flatten(jax.device_get(back))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
