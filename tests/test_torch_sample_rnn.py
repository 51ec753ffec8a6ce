"""The port's SampleRNN decode against the JAX package, on the CPU.

On the CPU the decode kernel's wrappers run its plain PyTorch twin, so this
holds the twin — and with it the arithmetic the CUDA kernel is checked
against on the card — to the JAX reference:

* teacher-forced logits equal the JAX train-mode forward's (``atol=1e-5``,
  ``rtol=1e-5``: f32 summation order differs between XLA and torch);
* argmax tokens of ``SampleRNN.generate`` are identical to the JAX scan
  decoder (``MMK_PALLAS_DECODE=0``) and to the Pallas kernels in interpret
  mode — K1 (``make_samplernn_pallas_decoder``) and K2
  (``make_samplernn_pallas_chunked``, forced as ``test_pallas_decode.py``
  forces it) — through both port wrappers and across chunk boundaries;
* the port's chunked streams equal one long decode, argmax and sampled.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py sample_rnn``).  Weights are jittered (as
``test_pallas_decode._jitter_params`` does) so the argmax trajectories are
not constant.
"""
import numpy as np
import pytest

import jax
import mimikit_tpu as mmk
from mimikit_tpu.ops.pallas_decode import supports_pallas_decode

from tests.torch_port_harness import flatten, run_port

H, Q, B, N_STEPS, T_FWD = 16, 32, 2, 60, 64
# (frame_sizes, n_mlp_layers): the three kernel-scope configurations of
# test_pallas_decode.py, and one outside the kernel's scope (a 3-hidden-layer
# head) that the port decodes with its plain step loop
CONFIGS = {
    "fs842": ((8, 4, 2), 0),
    "fs44": ((4, 4), 0),
    "fs1644": ((16, 4, 4), 1),
    "fs842_deep_head": ((8, 4, 2), 3),
}
IN_GATE = [k for k in CONFIGS if CONFIGS[k][1] <= 2]


def _net(frame_sizes, n_mlp_layers):
    io = mmk.IOSpec.mulaw_io(
        mmk.IOSpec.MuLawIOConfig(q_levels=Q, mlp_dim=H, n_mlp_layers=n_mlp_layers)
    )
    net = mmk.SampleRNN.from_config(
        mmk.SampleRNN.Config(frame_sizes=frame_sizes, hidden_dim=H, io_spec=io)
    )
    net.seed(0)
    net.init_params(batch_size=1)
    leaves, tree = jax.tree_util.tree_flatten(net.params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    net.params = jax.tree_util.tree_unflatten(
        tree, [l + jax.random.normal(k, l.shape) * 0.3 for l, k in zip(leaves, keys)]
    )
    return net


def _tokens(net, prompt):
    return np.asarray(net.generate((prompt,), n_steps=N_STEPS, temperature=None)[0])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(11)
    inp = {"n_steps": np.array(N_STEPS)}
    jx = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, (fs, n_mlp) in CONFIGS.items():
            net = _net(fs, n_mlp)
            prompt = rng.integers(0, Q, (B, 2 * fs[0])).astype(np.int32)
            seq = rng.integers(0, Q, (B, fs[0] + T_FWD)).astype(np.int32)
            p = f"cfg_{tag}/"
            inp.update({p + "yaml": np.array(net.config.serialize()),
                        p + "prompt": prompt, p + "seq": seq})
            inp.update(flatten(jax.device_get(net.params), p + "params/"))
            (logits,), _ = net.module.apply({"params": net.params}, (seq,), None, True)
            jx[p + "forward"] = np.asarray(logits)
            jx[p + "in_gate"] = supports_pallas_decode(net)
            mp.setenv("MMK_PALLAS_DECODE", "0")
            jx[p + "scan"] = _tokens(net, prompt)
            if tag in IN_GATE:
                mp.setenv("MMK_PALLAS_DECODE", "1")
                assert net._pallas_mode(B, prompt.shape[1], N_STEPS) == "single"
                jx[p + "k1"] = _tokens(net, prompt)
                net._PALLAS_CHUNK = 16  # several chunks over the decode
                mp.setattr(type(net), "_pallas_mode", lambda self, b, pt, n: "chunked")
                jx[p + "k2"] = _tokens(net, prompt)
                mp.undo()
    port = run_port("sample_rnn", inp, str(tmp_path_factory.mktemp("port_srnn")))
    return inp, jx, port


@pytest.mark.parametrize("cfg", CONFIGS)
def test_kernel_scope_gate_matches_jax(case, cfg):
    _, jx, port = case
    p = f"cfg_{cfg}/"
    assert bool(port[p + "in_gate"]) == bool(jx[p + "in_gate"]) == (cfg in IN_GATE)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_forward_logits_match_jax(case, cfg):
    _, jx, port = case
    p = f"cfg_{cfg}/"
    assert port[p + "forward"].shape == jx[p + "forward"].shape == (B, T_FWD, Q)
    np.testing.assert_allclose(port[p + "forward"], jx[p + "forward"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_teacher_forced_decode_logits_match_jax_forward(case, cfg):
    _, jx, port = case
    p = f"cfg_{cfg}/"
    assert port[p + "tf_logits"].shape == (B, T_FWD, Q)
    np.testing.assert_allclose(port[p + "tf_logits"], jx[p + "forward"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_argmax_generate_matches_jax_scan(case, cfg):
    inp, jx, port = case
    p = f"cfg_{cfg}/"
    out = port[p + "generate"]
    assert out.shape == (B, 2 * CONFIGS[cfg][0][0] + N_STEPS)
    assert len(set(out[0, inp[p + "prompt"].shape[1]:].tolist())) > 1, "degenerate decode"
    assert np.array_equal(out, jx[p + "scan"])


@pytest.mark.parametrize("cfg", IN_GATE)
def test_argmax_generate_matches_pallas_single_interpret(case, cfg):
    _, jx, port = case
    p = f"cfg_{cfg}/"
    assert np.array_equal(port[p + "generate"], jx[p + "k1"])


@pytest.mark.parametrize("cfg", IN_GATE)
def test_chunked_generate_matches_pallas_chunked_interpret(case, cfg):
    _, jx, port = case
    p = f"cfg_{cfg}/"
    assert np.array_equal(port[p + "generate_chunked"], jx[p + "k2"])


@pytest.mark.parametrize("cfg", CONFIGS)
def test_chunked_generate_matches_jax_scan(case, cfg):
    _, jx, port = case
    p = f"cfg_{cfg}/"
    assert np.array_equal(port[p + "generate_chunked"], jx[p + "scan"])


@pytest.mark.parametrize("cfg", CONFIGS)
def test_argmax_stream_equals_one_long_decode(case, cfg):
    inp, jx, port = case
    p = f"cfg_{cfg}/"
    prior_t = inp[p + "prompt"].shape[1]
    stream = port[p + "stream"]
    assert stream.shape == (B, (N_STEPS // 7) * 7)
    assert np.array_equal(stream, jx[p + "scan"][:, prior_t : prior_t + stream.shape[1]])


@pytest.mark.parametrize("cfg", CONFIGS)
def test_sampled_stream_equals_one_sampled_decode(case, cfg):
    """Noise is keyed by absolute step: a 9-step stream draws exactly what
    one ``generate`` call with the same seed draws."""
    inp, _, port = case
    p = f"cfg_{cfg}/"
    prior_t = inp[p + "prompt"].shape[1]
    sampled, stream = port[p + "sampled"], port[p + "sampled_stream"]
    assert sampled.min() >= 0 and sampled.max() < Q
    assert np.array_equal(stream, sampled[:, prior_t : prior_t + stream.shape[1]])


@pytest.mark.parametrize("cfg", CONFIGS)
def test_stream_audio_is_mulaw_expanded_tokens(case, cfg):
    inp, _, port = case
    p = f"cfg_{cfg}/"
    prior_t = inp[p + "prompt"].shape[1]
    toks = port[p + "sampled"][:, prior_t : prior_t + 9]
    ref = np.asarray(mmk.MuLawExpand(Q)(toks))
    np.testing.assert_allclose(port[p + "audio"], ref, rtol=0, atol=1e-6)
