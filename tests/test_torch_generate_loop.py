"""The port's ``GenerateLoopV2`` against the JAX package's, on the CPU.

* For SampleRNN, WaveNet, SimpleTransformer and JukeBox, with the same
  weights, over one JAX-written dataset at fixed prompt positions
  (``prompts_position_sec``), argmax: the loops' tokens are equal, and the
  outputs the targets' inverse transforms give (mu-law expanded audio)
  agree to ``atol=1e-6``.  The port's loop decodes through the net's
  ``generate`` (on the CPU the kernels' plain twins; JAX's scan decoders
  with ``MMK_PALLAS_DECODE=0``) and puts the net back in training mode
  after a run.
* SampleRNN's stepwise loop (``_stepwise``: ``before_generate``, one
  ``generate_step`` a sample, ``after_generate``) is token-identical to
  JAX's host loop, with a prompt of a multiple of rf samples and with one
  that is not (the warm-up drops the first ``prompt_length % rf``), and to
  the port's own ``generate`` for the former.
* A net whose ``generate`` does not take a sampler parameter decodes
  through the stepwise loop with the same warning as JAX's, once a loop.
* A two-input, two-target ARM whose step writes one step of the first
  buffer and three of the second (the counterpart of
  ``tests/test_utils.py:TestARM`` with multi-step ``until`` writes, 13 steps:
  the last write truncated) fills the same buffers in both loops.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py generate_loop``).
"""
import os
import warnings

import numpy as np
import pytest
from scipy.io import wavfile

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk

from tests import test_utils as tu
from tests.torch_port_harness import flatten, run_port

SR, Q, H = 16000, 32, 16
KINDS = ("samplernn", "wavenet", "transformer", "jukebox")
# the whole decodes: three prompts in batches of two (the last of one); the
# stepwise loop (JAX's host loop takes ~0.7 s a step): one batch of two, 8 steps
LOOP = dict(output_sec=0.003, prompt_sec=0.004, positions=(0.1, 0.3, 0.5), batch_size=2)
STEP = dict(output_sec=0.0005, prompt_sec=0.001, positions=(0.2, 0.4))
OFFSET_PROMPT_SEC = 0.0012  # 19 samples: 3 past a multiple of rf
UNTIL_STEPS = 13


def _io(ds, emb):
    return mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
        q_levels=Q, mlp_dim=H, input_module_type="embedding" if emb else "framed_linear"),
        extractor=ds.extractors[0])


def _jax_net(kind, ds):
    """A small JAX net of ``kind`` bound to ``ds``, with parameters drawn
    from a numpy seed (N(0, 0.3) around SampleRNN's initialisation, N(0,
    0.1) elsewhere; norm scales 1 + that) so the argmax decodes vary."""
    if kind == "samplernn":
        net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(
            frame_sizes=(8, 4, 2), hidden_dim=H, io_spec=_io(ds, False)))
        net.seed(0)
        net.init_params(batch_size=1)
        rng = np.random.default_rng(4)
        net.params = jax.tree_util.tree_map(
            lambda l: l + jnp.asarray(rng.standard_normal(l.shape) * 0.3, l.dtype), net.params)
        return net
    if kind == "wavenet":
        net = mmk.WaveNet.from_config(mmk.WaveNet.Config(
            io_spec=_io(ds, True), blocks=(3,), dims_dilated=(H,), skips_dim=H,
            residuals_dim=H, pad_side=0))
        length = net.rf + 1
    elif kind == "transformer":
        net = mmk.SimpleTransformer.from_config(mmk.SimpleTransformer.Config(
            io_spec=_io(ds, True), model_dim=32, n_heads=4, feedforward_dim=64, num_layers=2,
            rf=16, input_dropout=0.0))
        length = 16
    else:
        net = mmk.JukeBox.from_config(mmk.JukeBox.Config(
            io_spec=_io(ds, False), frame_sizes=(8, 4, 2), model_dim=32, n_heads=4,
            feedforward_dim=64, num_layers=2, rf=16, input_dropout=0.0))
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


def _config(loop=LOOP, **kw):
    return mmk.GenerateLoopV2.Config(
        output_duration_sec=loop["output_sec"], prompts_length_sec=loop["prompt_sec"],
        prompts_position_sec=loop["positions"], parameters=dict(temperature=None),
        batch_size=LOOP["batch_size"], display_waveform=False, **kw)


def _outputs(loop):
    return np.concatenate([np.asarray(o[0]) for o in loop.run()], 0)


class _UntilARM(tu.TestARM):
    """``TestARM`` whose step writes one step of the first buffer and three
    of the second."""

    def before_generate(self, prompts, batch_index):
        self.calls = 0

    def generate_step(self, inputs, *, t=0, **parameters):
        self.calls += 1
        x0, x1 = (np.asarray(x) for x in inputs)
        return x0[:, -1:] * 0.5 + t, np.concatenate([x1[:, -1:] + k for k in range(3)], 1) % 256


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("generate_loop"))
    wav = os.path.join(work, "a.wav")
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    y = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.2 * rng.standard_normal(SR)
    wavfile.write(wav, SR, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    inp = {"wav": np.array(wav), "jax_h5": np.array(ds.filename), "sr": np.array(SR),
           **{k: np.array(v) for k, v in LOOP.items()},
           **{f"step_{k}": np.array(v) for k, v in STEP.items()},
           "offset_prompt_sec": np.array(OFFSET_PROMPT_SEC), "until_steps": np.array(UNTIL_STEPS)}
    jx = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMK_PALLAS_DECODE", "0")
        for kind in KINDS:
            net = _jax_net(kind, ds)
            inp[f"{kind}/yaml"] = np.array(net.config.serialize())
            inp.update(flatten(jax.device_get(net.params), f"{kind}/params/"))
            loop = mmk.GenerateLoopV2.from_config(_config(yield_inversed_outputs=False), db, net)
            jx[f"{kind}/n_steps"] = loop.n_steps
            jx[f"{kind}/tokens"] = _outputs(loop)
            jx[f"{kind}/audio"] = _outputs(mmk.GenerateLoopV2.from_config(_config(), db, net))
        srnn = _jax_net("samplernn", ds)
        for tag, sec in (("aligned", STEP["prompt_sec"]), ("offset", OFFSET_PROMPT_SEC)):
            loop = mmk.GenerateLoopV2.from_config(
                _config({**STEP, "prompt_sec": sec}, yield_inversed_outputs=False), db, srnn)
            batch = next(iter(loop.dataloader))
            idx, batch = np.asarray(batch[0]).reshape(-1), batch[1:]
            jx[f"stepwise/{tag}"] = np.asarray(
                loop._stepwise(batch, idx, {"temperature": None})[0])
        gen = srnn.generate
        srnn.generate = lambda prompts, n_steps: gen(prompts, n_steps)
        loop = mmk.GenerateLoopV2.from_config(_config(STEP, yield_inversed_outputs=False), db,
                                              srnn)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _outputs(loop)
        jx["warned/messages"] = [str(w.message) for w in caught]
    rng = np.random.default_rng(5)
    inp["until_x0"] = rng.standard_normal((2, 10)).astype(np.float32)
    inp["until_x1"] = rng.integers(0, 256, (2, 10)).astype(np.int32)
    arm = _UntilARM(_UntilARM.Config(io_spec=None))
    loop = mmk.GenerateLoopV2(mmk.GenerateLoopV2.Config(), arm, UNTIL_STEPS, dataloader=None)
    jx["until/x0"], jx["until/x1"] = (np.asarray(x) for x in loop._stepwise(
        (inp["until_x0"], inp["until_x1"]), np.arange(2), {}))
    jx["until/calls"] = arm.calls
    db.close()
    return jx, run_port("generate_loop", inp, work)


@pytest.mark.parametrize("kind", KINDS)
def test_argmax_tokens_equal_jax_loop(case, kind):
    jx, port = case
    assert int(port[f"{kind}/n_steps"]) == jx[f"{kind}/n_steps"] == int(SR * LOOP["output_sec"])
    tokens = port[f"{kind}/tokens"]
    assert tokens.shape == (len(LOOP["positions"]),
                            int(SR * LOOP["prompt_sec"]) + jx[f"{kind}/n_steps"])
    np.testing.assert_array_equal(tokens, jx[f"{kind}/tokens"])


@pytest.mark.parametrize("kind", KINDS)
def test_inverted_outputs_agree_with_jax_loop(case, kind):
    jx, port = case
    assert port[f"{kind}/audio"].dtype == np.float32
    np.testing.assert_allclose(port[f"{kind}/audio"], jx[f"{kind}/audio"], atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_loop_restores_training_mode(case, kind):
    _, port = case
    assert bool(port[f"{kind}/training_restored"])


def test_samplernn_decodes_vary(case):
    jx, _ = case
    gen = jx["samplernn/tokens"][:, int(SR * LOOP["prompt_sec"]):]
    assert len(set(gen.ravel().tolist())) > 1, "degenerate decode"


@pytest.mark.parametrize("tag", ("aligned", "offset"))
def test_stepwise_loop_equals_jax_host_loop(case, tag):
    jx, port = case
    np.testing.assert_array_equal(port[f"stepwise/{tag}"], jx[f"stepwise/{tag}"])


def test_stepwise_loop_equals_the_ports_generate(case):
    _, port = case
    np.testing.assert_array_equal(port["stepwise/aligned"], port["stepwise/aligned/generate"])


def test_generate_without_the_parameter_warns_and_steps(case):
    jx, port = case
    msgs = [str(m) for m in port["warned/messages"] if "per-step reference loop" in str(m)]
    want = [m for m in jx["warned/messages"] if "per-step reference loop" in m]
    assert len(msgs) == len(want) == 1
    assert msgs == want
    np.testing.assert_array_equal(port["warned/tokens"], port["warned/generate"])


@pytest.mark.parametrize("buf", ("x0", "x1"))
def test_until_writes_fill_the_buffers_as_jax(case, buf):
    jx, port = case
    got = port[f"until/{buf}"]
    assert got.shape == jx[f"until/{buf}"].shape == (2, 10 + UNTIL_STEPS)
    assert got.dtype == jx[f"until/{buf}"].dtype
    np.testing.assert_array_equal(got, jx[f"until/{buf}"])
    assert int(port["until/calls"]) == jx["until/calls"] == -(-UNTIL_STEPS // 3)
    assert bool(port["until/done"])
