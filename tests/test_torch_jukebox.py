"""The port's JukeBox against the JAX package, on the CPU.

On the CPU the tier-pyramid kernel's wrapper runs its plain PyTorch twin, so
this holds the twin — and with it the arithmetic the CUDA kernel is checked
against on the card — to the JAX reference:

* train-mode logits of whole nets (Mish and ReLU layers, frames (8, 4, 2)
  and (8, 2), ``with_layer_norm`` and ``norm_first``) equal JAX's within
  ``atol=1e-5``, ``rtol=1e-5`` (f32 summed in another order);
* argmax ``generate`` tokens equal the JAX window scan (``MMK_PALLAS_DECODE=0``)
  and K8 (``make_jukebox_pallas_decoder``) in interpret mode at B = 1, 2 and
  4, for a short prompt (zero-padded to the window) and a long one; a net
  outside the kernel's scope goes through the window re-feed; the stepwise
  ``generate_step`` with its one-token shift gives the same tokens;
* streams: the K8 stream (window carried) equals one long decode and JAX's
  fused stream; the re-feed stream re-feeds the whole window (rf 12 rounds up
  to a window of 16) and equals one long decode and JAX's stream; sampled
  decodes reproduce from a seed and do not depend on the chunking;
* the gate, the weight maps, the checkpoint banks and the config YAML agree
  with the JAX package.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py jukebox``).  Weights are drawn from a numpy seed with
a spread that keeps the argmax trajectories varied.
"""
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk
from mimikit_tpu.migrate import transformer_params_from_state_dict
from mimikit_tpu.ops.pallas_decode import supports_pallas_jukebox

from tests.torch_port_harness import flatten, run_port

Q, N_STEPS = 32, 24
WEIGHT_STD = 0.25
NETS = {
    "f842": dict(),
    "f82": dict(frame_sizes=(8, 2)),
    "f842_relu": dict(layer_activation="ReLU"),
    "f842_fln": dict(with_layer_norm=True, seed=11),
    "f842_pre": dict(norm_first=True, std=0.15, seed=10),
}
IN_GATE = ["f842", "f82", "f842_relu"]
# nets the gate refuses that are not decoded here
REFUSED = {"dropout": dict(dropout=0.1), "notemp": dict(min_temperature=None)}
# the batch sizes JAX decodes each net at with its window scan, and with K8
SCAN_B = {"f842": (1, 2, 4), "f82": (1,), "f842_relu": (1,), "f842_fln": (2,), "f842_pre": (2,)}
K8_B = {"f842": (1, 2, 4), "f82": (1,), "f842_relu": (1,)}
SHORT = ["f842", "f82", "f842_pre"]
RF12 = dict(rf=12, num_layers=1)  # tests/test_streaming.py:226-252


def _draw(shapes, seed: int, std: float = WEIGHT_STD):
    """Parameters of ``shapes`` from a numpy seed: norm scales 1 + N(0, std),
    N(0, std) for the rest (the default init jittered, as
    ``test_pallas_decode.py:244-255`` jitters it).  A pre-norm stack carries
    its residual unnormed, so a wider spread there amplifies the f32
    summation-order differences past 1e-5."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = rng.standard_normal(s.shape) * std + ("scale" in jax.tree_util.keystr(path))
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _net(spec, seed: int = 7):
    spec = dict(spec)
    std, seed = spec.pop("std", WEIGHT_STD), spec.pop("seed", seed)
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
        q_levels=Q, mlp_dim=16, n_mlp_layers=1,
        min_temperature=spec.pop("min_temperature", 1e-4)))
    cfg = dict(frame_sizes=(8, 4, 2), model_dim=32, n_heads=4, feedforward_dim=64, num_layers=2,
               rf=16, input_dropout=0.0)
    cfg.update(spec)
    net = mmk.JukeBox.from_config(mmk.JukeBox.Config(io_spec=io, **cfg))
    net.seed(0)
    shapes = jax.eval_shape(
        lambda k: net.module.init({"params": k, "dropout": k, "sample": k},
                                  (jnp.zeros((1, net._window_len()), jnp.int32),), None, True),
        jax.random.PRNGKey(0))["params"]
    net.params = _draw(shapes, seed, std)
    return net


def _forward(net, seq):
    fn = jax.jit(lambda p, x: net.module.apply({"params": p}, (x,), None, True,
                                               rngs={"sample": jax.random.PRNGKey(0)})[0][0])
    return np.asarray(fn(net.params, seq))


def _generate(net, prompt, n=N_STEPS):
    return np.asarray(net.generate((prompt,), n_steps=n, temperature=None,
                                   rng=jax.random.PRNGKey(1))[0])


def _chunks(it, n):
    return np.concatenate([np.asarray(c) for c in itertools.islice(it, n)], axis=1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(31)
    inp = {"n_steps": np.array(N_STEPS)}
    jx, nets = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, spec in NETS.items():
            net = nets[tag] = _net(spec)
            W = net._window_len()
            p = f"net_{tag}/"
            seq = rng.integers(0, Q, (2, 2 * W)).astype(np.int32)
            prompts = {B: rng.integers(0, Q, (B, W)).astype(np.int32) for B in (1, 2, 4)}
            short = rng.integers(0, Q, (1, W // 2)).astype(np.int32)
            long = rng.integers(0, Q, (2, W + 5)).astype(np.int32)
            inp.update({p + "yaml": np.array(net.config.serialize()), p + "seq": seq,
                        p + "short": short, p + "long": long})
            inp.update({f"{p}prompt{B}": x for B, x in prompts.items()})
            inp.update(flatten(jax.device_get(net.params), p + "params/"))
            jx[p + "forward"] = _forward(net, seq)
            jx[p + "in_gate"] = supports_pallas_jukebox(net)
            mp.setenv("MMK_PALLAS_DECODE", "0")
            for B in SCAN_B[tag]:
                jx[f"{p}scan_b{B}"] = _generate(net, prompts[B])
            if tag in SHORT:
                jx[p + "short"] = _generate(net, short)
            if tag == "f842":
                jx[p + "long"] = _generate(net, long)
            mp.setenv("MMK_PALLAS_DECODE", "1")  # K8 in interpret mode
            for B in K8_B.get(tag, ()):
                assert net._use_pallas_decode(B, W, N_STEPS, argmax=True)
                jx[f"{p}k8_b{B}"] = _generate(net, prompts[B])
            if tag == "f842":  # JAX's fused stream, the window carried (test_streaming.py:255-290)
                for B in (1, 2):
                    jx[f"{p}fused_stream_b{B}"] = _chunks(
                        net.stream((prompts[B],), 8, temperature=None, rng=jax.random.PRNGKey(11)), 3)
        mp.setenv("MMK_PALLAS_DECODE", "0")
        for tag, spec in REFUSED.items():
            jx[f"refused_{tag}/in_gate"] = supports_pallas_jukebox(_net(spec))
            inp[f"refused_{tag}/yaml"] = np.array(_net(spec).config.serialize())
        wide = _net(dict(rf=512))  # standard, but its frames outgrow the kernel's shared memory
        jx["wide/in_gate"] = supports_pallas_jukebox(wide)
        inp["wide/yaml"] = np.array(wide.config.serialize())
        rc = _net(dict(ref_compat=True))
        jx["refused_ref_compat/in_gate"] = supports_pallas_jukebox(rc)
        inp["refused_ref_compat/yaml"] = np.array(rc.config.serialize())
        # the re-feed stream over a window longer than rf + 1
        net12 = nets["rf12"] = _net(RF12)
        assert net12._window_len() > net12.rf + 1
        p12 = rng.integers(0, Q, (2, 24)).astype(np.int32)
        inp.update({"rf12/yaml": np.array(net12.config.serialize()), "rf12/prompt": p12})
        inp.update(flatten(jax.device_get(net12.params), "rf12/params/"))
        mp.delenv("MMK_PALLAS_DECODE")
        assert not net12._use_pallas_decode(2, 24, 8, argmax=True)
        jx["rf12/stream"] = _chunks(mmk.stream_tokens(net12, (p12,), 8, temperature=None), 4)
        jx["rf12/long"] = _generate(net12, p12, 32)[:, 24:]
        mp.setenv("MMK_PALLAS_DECODE", "0")
        # a bank written by the JAX package, for the port to load
        root = str(tmp_path_factory.mktemp("jb_banks"))
        mmk.Checkpoint(id="jb_jax", epoch=1, root_dir=root).create(network=nets["f842"])
        inp["bank_root"] = np.array(root)
        port = run_port("jukebox", inp, str(tmp_path_factory.mktemp("port_jb")))
        # the port's bank of the same weights, loaded and decoded by JAX
        loaded = mmk.Checkpoint(id="jb_port", epoch=1, root_dir=root).network
        jx["bank/port_type"] = type(loaded).__name__
        jx["bank/port_tokens"] = _generate(loaded, inp["net_f842/prompt1"])
    return inp, jx, port, nets


@pytest.mark.parametrize("net", NETS)
def test_forward_logits_match_jax(case, net):
    inp, jx, port, nets = case
    p = f"net_{net}/"
    W = nets[net]._window_len()
    assert port[p + "forward"].shape == jx[p + "forward"].shape == (2, 2 * W - 8, Q)
    np.testing.assert_allclose(port[p + "forward"], jx[p + "forward"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("net", NETS)
def test_eval_forward_ignores_the_last_token(case, net):
    """The eval forward reads tokens[:-1] only (PARITY.md #6)."""
    _, _, port, _ = case
    p = f"net_{net}/"
    assert port[p + "eval"].shape == (2, 1)
    assert np.array_equal(port[p + "eval"], port[p + "eval_last_changed"])


@pytest.mark.parametrize("net", NETS)
def test_kernel_scope_gate_matches_jax(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert bool(port[p + "in_gate"]) == bool(jx[p + "in_gate"]) == (net in IN_GATE)


@pytest.mark.parametrize("tag", [*REFUSED, "ref_compat"])
def test_gate_refuses_what_jax_refuses(case, tag):
    _, jx, port, _ = case
    assert not jx[f"refused_{tag}/in_gate"]
    assert not bool(port[f"refused_{tag}/in_gate"])


def test_gate_warns_where_only_the_kernel_limits_refuse(case):
    """A standard net beyond the kernel's limits (a window of 512): JAX's
    gate admits it; the port's refuses it, with a warning that it decodes
    through the window re-feed."""
    _, jx, port, _ = case
    assert jx["wide/in_gate"]
    assert not bool(port["wide/in_gate"])
    msgs = port["wide/warnings"].tolist()
    assert len(msgs) == 1 and "window re-feed" in msgs[0], msgs


@pytest.mark.parametrize("what", ["ref_compat", "weight_norm", "embedding"])
def test_unported_variants_raise(case, what):
    _, _, port, _ = case
    assert str(port[f"unported/{what}"]).startswith("NotImplementedError"), port[f"unported/{what}"]


@pytest.mark.parametrize("net,B", [(n, B) for n, bs in SCAN_B.items() for B in bs])
def test_argmax_generate_matches_jax_scan(case, net, B):
    """K8's twin in the scope, the window re-feed outside it."""
    _, jx, port, nets = case
    p = f"net_{net}/"
    W = nets[net]._window_len()
    out = port[f"{p}generate_b{B}"]
    assert out.shape == (B, W + N_STEPS)
    assert len(set(out[0, W:].tolist())) > 1, "degenerate decode"
    assert np.array_equal(out, jx[f"{p}scan_b{B}"])


@pytest.mark.parametrize("net,B", [(n, B) for n, bs in K8_B.items() for B in bs])
def test_argmax_generate_matches_k8_interpret(case, net, B):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[f"{p}generate_b{B}"], jx[f"{p}k8_b{B}"])


@pytest.mark.parametrize("net", SHORT)
def test_short_prompt_is_padded_like_jax(case, net):
    """A prompt of W/2 tokens is left-padded with zeros to the window, then
    stripped (``transformers.py:1160-1165``): through K8's twin in the
    scope, the window re-feed outside it."""
    inp, jx, port, nets = case
    p = f"net_{net}/"
    out = port[p + "short"]
    assert out.shape == (1, nets[net]._window_len() // 2 + N_STEPS)
    assert np.array_equal(out, jx[p + "short"])


def test_long_prompt_matches_jax_scan(case):
    _, jx, port, _ = case
    assert np.array_equal(port["net_f842/long"], jx["net_f842/long"])


@pytest.mark.parametrize("net", IN_GATE)
def test_window_route_gives_the_kernel_tokens(case, net):
    """The window re-feed (lead 1) of an in-scope net equals K8's twin."""
    _, _, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + "window_loop_b2"], port[p + "generate_b2"])


@pytest.mark.parametrize("net", IN_GATE)
def test_cpu_generate_launches_no_kernel(case, net):
    _, _, port, _ = case
    assert int(port[f"net_{net}/launches_on_cpu"]) == 0


@pytest.mark.parametrize("net", NETS)
def test_generate_step_shift_matches_fast_decode(case, net):
    """``generate_step`` on the lead-0 window [t - W, t) predicts t
    (``test_transformers.py:248-272``)."""
    _, _, port, nets = case
    p = f"net_{net}/"
    W = nets[net]._window_len()
    assert np.array_equal(port[p + "generate_step"], port[p + "generate_b2"][:, W : W + 8])


@pytest.mark.parametrize("B", [1, 2])
def test_k8_stream_equals_long_decode_and_jax_fused_stream(case, B):
    """Three chunks of 8, the (B, W) window carried from one K8 launch to the
    next: one long decode, and JAX's fused stream."""
    _, jx, port, nets = case
    W = nets["f842"]._window_len()
    got = port[f"net_f842/stream_b{B}"]
    assert got.shape == (B, 24)
    assert np.array_equal(got, port[f"net_f842/generate_b{B}"][:, W:])
    assert np.array_equal(got, jx[f"net_f842/fused_stream_b{B}"])


@pytest.mark.parametrize("net", [n for n in NETS if n not in IN_GATE])
def test_refeed_stream_equals_long_decode(case, net):
    _, _, port, nets = case
    p = f"net_{net}/"
    W = nets[net]._window_len()
    assert np.array_equal(port[p + "stream_b2"], port[p + "generate_b2"][:, W:])


def test_refeed_stream_reads_the_whole_window(case):
    """rf 12, frames (8, 4, 2): the window is 16 tokens, so re-feeding rf + 1
    would zero-pad history one long decode reads."""
    _, jx, port, _ = case
    got = port["rf12/refeed"]
    assert got.shape == (2, 32)
    assert np.array_equal(got, jx["rf12/long"])
    assert np.array_equal(got, jx["rf12/stream"])


def test_refeed_stream_of_rf_plus_one_parts_from_long_decode(case):
    """The case is not vacuous: the old rf + 1 re-feed gives other tokens."""
    _, jx, port, _ = case
    assert not np.array_equal(port["rf12/refeed_rf1"], jx["rf12/long"])


@pytest.mark.parametrize("net", IN_GATE)
def test_sampled_generate_reproduces_from_its_seed(case, net):
    _, _, port, _ = case
    p = f"net_{net}/"
    a = port[p + "sampled_a"]
    assert a.min() >= 0 and a.max() < Q
    assert np.array_equal(a, port[p + "sampled_b"])


@pytest.mark.parametrize("net", IN_GATE)
def test_sampled_stream_is_chunk_invariant_and_equals_generate(case, net):
    """Noise is keyed by absolute position: any chunking draws the tokens
    of one long sampled decode with the same seed."""
    _, _, port, nets = case
    p = f"net_{net}/"
    W = nets[net]._window_len()
    a, b = port[p + "sampled_c7"], port[p + "sampled_c9"]
    assert np.array_equal(b[:, :21], a)
    assert np.array_equal(a, port[p + "sampled_a"][:, W : W + 21])


@pytest.mark.parametrize("net", NETS)
def test_state_dict_names_are_pytorch_mimikit_names(case, net):
    _, _, port, _ = case
    keys = set(port[f"net_{net}/state_dict_keys"].tolist())
    for name in ("tiers.0.model.layers.1.self_attn.in_proj_weight",
                 "tiers.0.model.layers.0.multihead_attn.out_proj.bias",
                 "tiers.0.input_module.heads.0.2.weight", "tiers.0.up_sampler.fc.weight",
                 "output_modules.0.estimator.0.fc.0.weight"):
        assert name in keys
    n = len(NETS[net].get("frame_sizes", (8, 4, 2)))
    assert f"tiers.{n - 1}.input_module.heads.0.2.2.cv.weight" in keys
    assert not any(k.endswith("pe.pe") for k in keys)


@pytest.mark.parametrize("net", NETS)
def test_weights_round_trip_bit_for_bit(case, net):
    """JAX -> port -> JAX returns every parameter unchanged."""
    _, _, port, nets = case
    p = f"net_{net}/back/"
    want = flatten(jax.device_get(nets[net].params))
    got = {k[len(p):]: v for k, v in port.items() if k.startswith(p)}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("net", NETS)
def test_migrate_reads_the_port_state_dict(case, net):
    """``migrate.transformer_params_from_state_dict`` rebuilds the JAX tree
    from the port's state_dict."""
    _, _, port, nets = case
    p = f"net_{net}/sd/"
    sd_ = {k[len(p):]: v for k, v in port.items() if k.startswith(p)}
    fresh = _net({**NETS[net], "seed": 1})  # another tree of the same shapes
    rebuilt = flatten(jax.device_get(transformer_params_from_state_dict(fresh, sd_)))
    want = flatten(jax.device_get(nets[net].params))
    assert sorted(rebuilt) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(rebuilt[k], v), k


@pytest.mark.parametrize("net", NETS)
def test_jax_config_yaml_loads_unchanged(case, net):
    inp, _, port, _ = case
    p = f"net_{net}/"
    assert str(port[p + "yaml_back"]) == str(inp[p + "yaml"])


def test_jax_bank_loads_in_the_port(case):
    _, jx, port, _ = case
    assert str(port["bank/jax_type"]) == "JukeBox"
    assert np.array_equal(port["bank/jax_tokens"], jx["net_f842/scan_b1"])


def test_port_bank_loads_in_jax(case):
    _, jx, _, _ = case
    assert jx["bank/port_type"] == "JukeBox"
    assert np.array_equal(jx["bank/port_tokens"], jx["net_f842/scan_b1"])
