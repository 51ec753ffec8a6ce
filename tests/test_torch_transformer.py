"""The port's SimpleTransformer against the JAX package, on the CPU.

On the CPU the decode kernels' wrappers run their plain PyTorch twins, so
this holds the twins — and with them the arithmetic the CUDA kernels are
checked against on the card — to the JAX reference:

* train-mode and eval logits of whole nets (``with_layer_norm`` on and off,
  2 and 4 heads, a head with a hidden layer, a head without temperature)
  and pre-norm decoder stacks equal JAX's within ``atol=1e-5``,
  ``rtol=1e-5`` (f32 summed in another order);
* argmax ``generate`` tokens equal the JAX window scan
  (``MMK_PALLAS_DECODE=0``) through each route — K6's twin at B=1 and B=2
  for nets in the kernels' scope (one ``decode_window`` call), the batched
  window route outside it, past ``_K6_MAX_BATCH`` streams and called
  directly at B=2, the KV-cached decoder for a short prompt —
  and, for nets in the kernels' scope, K6
  (``make_transformer_pallas_decoder``) in interpret mode at B=1 and, through
  the ``decode_window`` wrapper, at B=2;
* ``MMK_DECODE_KV=1`` streams equal the JAX KV-ring oracle scan (B=1 and 2)
  and K7 (``make_transformer_kv_ring_pallas``) in interpret mode (d=128,
  chunks of 7, so 64-step kernel calls over 70 tokens, the state carried),
  are chunk-invariant, and start with the window decoder's prediction;
* sampled decodes reproduce from a seed, a re-feed stream builds K6's
  weight pack once; the gate, the weight maps and the checkpoint banks agree
  with the JAX package, and the gate admits transformer8l at rf 512 and warns
  where only the kernels' limits refuse a net.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py transformer``).  Weights are drawn from a numpy seed
with a spread that keeps the argmax trajectories varied.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk
from mimikit_tpu.migrate import transformer_params_from_state_dict
from mimikit_tpu.networks.transformers import DecoderStack
from mimikit_tpu.ops.pallas_decode import supports_pallas_transformer

from tests.torch_port_harness import flatten, run_port

Q, RF, N_STEPS = 32, 16, 24
WIDE_B = 33  # one stream more than SimpleTransformer._K6_MAX_BATCH
WEIGHT_STD = 0.25
NETS = {
    "h4": dict(model_dim=32, n_heads=4),
    "h2_fln_mlp1": dict(model_dim=32, n_heads=2, with_layer_norm=True, n_mlp=1),
    "h4_notemp": dict(model_dim=32, n_heads=4, min_temperature=None),
    "d128": dict(model_dim=128, n_heads=4, std=WEIGHT_STD / 2),
}
IN_GATE = ["h4", "h2_fln_mlp1", "d128"]
K6_NETS = ["h4", "h2_fln_mlp1"]
ORACLE_NETS = ["h4", "h2_fln_mlp1"]  # the KV oracle scan; d128 runs K7 in interpret mode
STACKS = {"pre_h2": (32, 2, 64, 2, False), "pre_h4_fln": (32, 4, 64, 2, True)}
# (d, ff, layers, rf), 8 heads, q 256: transformer8l's widths at the rf 512 of
# benchmarks/bench_train.py:331-335, and a net twice as wide
GATE_NETS = {"long": (256, 1024, 8, 512), "wide": (512, 2048, 1, 64)}


def _draw(shapes, seed: int, std: float = WEIGHT_STD):
    """Parameters of ``shapes`` from a numpy seed: N(0, 1) embeddings, norm
    scales 1 + N(0, std), N(0, std) for the rest (the default init jittered,
    as ``test_pallas_decode.py:244-255`` jitters it).  A wider spread (or the
    same spread at d=128) amplifies the f32 summation-order differences past
    1e-5."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        key = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape)
        if "embedding" in key:
            return jnp.asarray(x, jnp.float32)
        return jnp.asarray(x * std + ("scale" in key), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _net(spec, seed: int = 7):
    spec = dict(spec)
    std = spec.pop("std", WEIGHT_STD)
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
        q_levels=Q, mlp_dim=16, n_mlp_layers=spec.pop("n_mlp", 0),
        min_temperature=spec.pop("min_temperature", 1e-4), input_module_type="embedding"))
    net = mmk.SimpleTransformer.from_config(mmk.SimpleTransformer.Config(
        io_spec=io, feedforward_dim=64, num_layers=2, rf=RF, input_dropout=0.0, **spec))
    net.seed(0)
    shapes = jax.eval_shape(
        lambda k: net.module.init({"params": k, "dropout": k, "sample": k},
                                  (jnp.zeros((1, RF), jnp.int32),), None, True),
        jax.random.PRNGKey(0))["params"]
    net.params = _draw(shapes, seed, std)
    return net


def _apply(net, seq, train: bool):
    fn = jax.jit(lambda p, x: net.module.apply({"params": p}, (x,), None, train,
                                               rngs={"sample": jax.random.PRNGKey(0)})[0][0])
    return np.asarray(fn(net.params, seq))


def _generate(net, prompt):
    return np.asarray(net.generate((prompt,), n_steps=N_STEPS, temperature=None,
                                   rng=jax.random.PRNGKey(1))[0])


def _kv_stream(net, prompt):
    s = net.stream((prompt,), 7, temperature=None, rng=jax.random.PRNGKey(5))
    return np.concatenate([np.asarray(next(s)) for _ in range(10)], axis=1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(21)
    inp = {"n_steps": np.array(N_STEPS)}
    jx, nets = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, spec in NETS.items():
            net = nets[tag] = _net(spec)
            p = f"net_{tag}/"
            seq = rng.integers(0, Q, (2, RF + 4)).astype(np.int32)
            p1 = rng.integers(0, Q, (1, RF + 4)).astype(np.int32)
            p2 = rng.integers(0, Q, (2, RF + 4)).astype(np.int32)
            short = rng.integers(0, Q, (2, 5)).astype(np.int32)
            kvp = rng.integers(0, Q, (2, RF)).astype(np.int32)
            wide_b = np.random.default_rng(33).integers(0, Q, (WIDE_B, RF + 4)).astype(np.int32)
            inp.update({p + "yaml": np.array(net.config.serialize()), p + "seq": seq,
                        p + "prompt1": p1, p + "prompt2": p2, p + "short": short,
                        p + "kv_prompt": kvp, p + "prompt_wide_b": wide_b})
            inp.update(flatten(jax.device_get(net.params), p + "params/"))
            jx[p + "forward"] = _apply(net, seq, True)
            jx[p + "eval"] = _apply(net, seq, False)
            jx[p + "in_gate"] = supports_pallas_transformer(net)
            mp.setenv("MMK_PALLAS_DECODE", "0")
            mp.delenv("MMK_DECODE_KV", raising=False)
            jx[p + "scan_b1"] = _generate(net, p1)
            jx[p + "scan_b2"] = _generate(net, p2)
            jx[p + "scan_wide_b"] = _generate(net, wide_b)
            jx[p + "short"] = _generate(net, short)
            if tag in K6_NETS:
                mp.setenv("MMK_PALLAS_DECODE", "1")
                assert net._use_pallas_decode(1, p1.shape[1], N_STEPS, argmax=True)
                jx[p + "k6_b1"] = _generate(net, p1)
                jx[p + "k6_b2"] = np.asarray(net._pallas_generate(
                    (p2,), N_STEPS, None, jax.random.PRNGKey(1))[0])
            if tag in ORACLE_NETS:
                mp.setenv("MMK_PALLAS_DECODE", "0")
                mp.setenv("MMK_DECODE_KV", "1")
                assert not net._use_pallas_kv(2, True)
                jx[p + "kv_b1"] = _kv_stream(net, kvp[:1])
                jx[p + "kv_b2"] = _kv_stream(net, kvp)
            if tag == "d128":
                mp.setenv("MMK_PALLAS_DECODE", "1")
                mp.setenv("MMK_DECODE_KV", "1")
                assert net._use_pallas_kv(2, True)
                jx[p + "kv_b2"] = _kv_stream(net, kvp)
        mp.delenv("MMK_DECODE_KV", raising=False)
        mp.setenv("MMK_PALLAS_DECODE", "0")
        for tag, (d, nh, ff, L, fln) in STACKS.items():
            p = f"stack_{tag}/"
            stack = DecoderStack(d, nh, ff, L, norm_first=True, with_layer_norm=fln)
            x = rng.standard_normal((2, 12, d)).astype(np.float32)
            shapes = jax.eval_shape(lambda k: stack.init(k, x), jax.random.PRNGKey(0))["params"]
            params = _draw(shapes, seed=len(jx))
            jx[p + "y"] = np.asarray(jax.jit(stack.apply)({"params": params}, x))
            inp.update({p + "dims": np.array([d, nh, ff, L, int(fln)]), p + "x": x})
            inp.update(flatten(jax.device_get(params), p + "params/"))
        for tag, (d, ff, L, rf) in GATE_NETS.items():
            io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
                q_levels=256, mlp_dim=128, input_module_type="embedding"))
            cfg = mmk.SimpleTransformer.Config(io_spec=io, model_dim=d, n_heads=8,
                                               feedforward_dim=ff, num_layers=L, rf=rf,
                                               input_dropout=0.0)
            inp[f"{tag}/yaml"] = np.array(cfg.serialize())
            jx[f"{tag}/in_gate"] = supports_pallas_transformer(
                mmk.SimpleTransformer.from_config(cfg))
        srnn = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(
            frame_sizes=(8, 4, 2), hidden_dim=16,
            io_spec=mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=32, mlp_dim=16))))
        jx["srnn_in_gate"] = supports_pallas_transformer(srnn)
        inp["srnn_yaml"] = np.array(srnn.config.serialize())
        # a bank written by the JAX package, for the port to load
        root = str(tmp_path_factory.mktemp("tf_banks"))
        mmk.Checkpoint(id="tf_jax", epoch=1, root_dir=root).create(network=nets["h4"])
        inp["bank_root"] = np.array(root)
        port = run_port("transformer", inp, str(tmp_path_factory.mktemp("port_tf")))
        # the port's bank of the same weights, loaded and decoded by JAX
        loaded = mmk.Checkpoint(id="tf_port", epoch=1, root_dir=root).network
        jx["bank/port_type"] = type(loaded).__name__
        jx["bank/port_tokens"] = _generate(loaded, inp["net_h4/prompt1"])
    return inp, jx, port, nets


@pytest.mark.parametrize("net", NETS)
def test_forward_logits_match_jax(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert port[p + "forward"].shape == jx[p + "forward"].shape == (2, RF + 4, Q)
    np.testing.assert_allclose(port[p + "forward"], jx[p + "forward"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("net", NETS)
def test_eval_forward_matches_jax(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert port[p + "eval"].shape == (2, 1)
    assert np.array_equal(port[p + "eval"], jx[p + "eval"])


@pytest.mark.parametrize("stack", STACKS)
def test_pre_norm_stack_matches_jax(case, stack):
    _, jx, port, _ = case
    p = f"stack_{stack}/"
    np.testing.assert_allclose(port[p + "y"], jx[p + "y"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("net", NETS)
def test_kernel_scope_gate_matches_jax(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert bool(port[p + "in_gate"]) == bool(jx[p + "in_gate"]) == (net in IN_GATE)


def test_gate_admits_transformer8l_at_rf_512(case):
    """Attention stages its keys a tile at a time, so rf does not bound the
    kernels: transformer8l's widths at rf 512 stay in their scope."""
    _, jx, port, _ = case
    assert jx["long/in_gate"] and bool(port["long/in_gate"])
    assert port["long/warnings"].size == 0


def test_gate_warns_where_only_the_kernel_limits_refuse(case):
    """At d 512 with 8 heads the JAX gate admits the net; the port's refuses
    it (its largest task's weight slice outgrows a block's shared memory),
    with a warning that it decodes through the window route."""
    _, jx, port, _ = case
    assert jx["wide/in_gate"]
    assert not bool(port["wide/in_gate"])
    msgs = port["wide/warnings"].tolist()
    assert len(msgs) == 1 and "outside the transformer decode kernels' limits" in msgs[0]


def test_gate_refuses_a_samplernn(case):
    _, jx, port, _ = case
    assert not bool(port["srnn_in_gate"]) and not jx["srnn_in_gate"]


@pytest.mark.parametrize("net", NETS)
def test_argmax_generate_b1_matches_jax_scan(case, net):
    """B=1: K6's twin in the scope, the window route outside it."""
    inp, jx, port, _ = case
    p = f"net_{net}/"
    out = port[p + "generate_b1"]
    assert out.shape == (1, RF + 4 + N_STEPS)
    assert len(set(out[0, RF + 4:].tolist())) > 1, "degenerate decode"
    assert np.array_equal(out, jx[p + "scan_b1"])


@pytest.mark.parametrize("net", NETS)
def test_batched_window_route_b2_matches_jax_scan(case, net):
    """The batched window route (``_window_loop``, called directly: a net in
    the kernels' scope sends B=2 to K6) at B=2."""
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + "window_route_b2"], jx[p + "scan_b2"])


@pytest.mark.parametrize("net", IN_GATE)
def test_in_gate_generate_b2_goes_through_decode_window(case, net):
    """A net in the kernels' scope sends B > 1 to K6's route (on the CPU
    its plain twin): B=2 makes one ``decode_window`` call and gives the JAX
    scan's argmax tokens."""
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert int(port[p + "generate_b2_window_calls"]) == 1
    assert np.array_equal(port[p + "generate_b2"], jx[p + "scan_b2"])


@pytest.mark.parametrize("net", IN_GATE)
def test_in_gate_generate_above_the_k6_limit_takes_the_window_route(case, net):
    """Past ``SimpleTransformer._K6_MAX_BATCH`` streams (K6 grows with each
    stream, the window route barely) ``generate`` takes the batched window
    route: no ``decode_window`` call, the JAX scan's argmax tokens."""
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert int(port["k6_max_batch"]) == WIDE_B - 1
    assert int(port[p + "generate_wide_b_window_calls"]) == 0
    assert np.array_equal(port[p + "generate_wide_b"], jx[p + "scan_wide_b"])


@pytest.mark.parametrize("net", IN_GATE)
def test_refeed_stream_builds_one_weight_pack(case, net):
    """A re-feed stream of three chunks (four ``generate`` calls: the read is
    one chunk behind) builds K6's weight pack once."""
    _, _, port, _ = case
    assert int(port[f"net_{net}/refeed_packs"]) == 1


@pytest.mark.parametrize("net", K6_NETS)
def test_argmax_generate_b1_matches_k6_interpret(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + "generate_b1"], jx[p + "k6_b1"])


@pytest.mark.parametrize("net", K6_NETS)
def test_window_wrapper_b2_matches_k6_interpret(case, net):
    inp, jx, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + "window_b2"], jx[p + "k6_b2"][:, RF + 4:])


@pytest.mark.parametrize("net", IN_GATE)
def test_cpu_generate_launches_no_kernel(case, net):
    _, _, port, _ = case
    assert int(port[f"net_{net}/launches_on_cpu"]) == 0


@pytest.mark.parametrize("net", NETS)
def test_short_prompt_matches_jax_kv_cache_decoder(case, net):
    """A prompt shorter than rf takes the incremental decoder, which attends
    over the whole history (past rf as the decode goes on)."""
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert port[p + "short"].shape == (2, 5 + N_STEPS)
    assert np.array_equal(port[p + "short"], jx[p + "short"])


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("net", ORACLE_NETS)
def test_kv_stream_matches_jax_oracle(case, net, B):
    _, jx, port, _ = case
    p = f"net_{net}/"
    got = port[f"{p}kv_b{B}_c7"]
    assert got.shape == (B, 70)
    assert len(set(got[0].tolist())) > 1, "degenerate decode"
    assert np.array_equal(got, jx[f"{p}kv_b{B}"])


def test_kv_stream_matches_k7_interpret(case):
    """d=128, B=2: ten chunks of 7 are two 64-step kernel calls, the ring
    state carried from the first to the second."""
    _, jx, port, _ = case
    got = port["net_d128/kv_b2_c7"]
    assert len(set(got[0].tolist())) > 1, "degenerate decode"
    assert np.array_equal(got, jx["net_d128/kv_b2"])


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("net", IN_GATE)
def test_kv_stream_is_chunk_invariant(case, net, B):
    _, _, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[f"{p}kv_b{B}_c9"][:, :70], port[f"{p}kv_b{B}_c7"])


@pytest.mark.parametrize("net", IN_GATE)
def test_kv_stream_starts_with_the_window_prediction(case, net):
    """From an rf-long prompt the KV ring's first prediction sees the window
    decoder's attention set and PE (test_streaming.py:158-170)."""
    _, _, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[f"{p}kv_b2_c7"][:, 0], port[p + "window_first"])


@pytest.mark.parametrize("net", IN_GATE)
def test_sampled_kv_stream_is_chunk_invariant(case, net):
    """Noise is keyed by absolute step: any chunking draws the same tokens."""
    _, _, port, _ = case
    p = f"net_{net}/"
    a, b = port[p + "kv_sampled_c7"], port[p + "kv_sampled_c9"]
    assert a.min() >= 0 and a.max() < Q
    assert np.array_equal(b[:, :70], a)


@pytest.mark.parametrize("net", IN_GATE)
def test_sampled_generate_reproduces_from_its_seed(case, net):
    _, _, port, _ = case
    p = f"net_{net}/"
    a = port[p + "sampled_a"]
    assert a.min() >= 0 and a.max() < Q
    assert np.array_equal(a, port[p + "sampled_b"])


@pytest.mark.parametrize("net", IN_GATE)
def test_refeed_stream_equals_chunked_generates(case, net):
    _, _, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + "refeed"], port[p + "refeed_generates"])


@pytest.mark.parametrize("net", NETS)
def test_state_dict_names_are_torch_decoder_layer_names(case, net):
    _, _, port, _ = case
    keys = set(port[f"net_{net}/state_dict_keys"].tolist())
    for name in ("model.layers.1.self_attn.in_proj_weight",
                 "model.layers.0.multihead_attn.out_proj.bias",
                 "model.layers.1.linear2.weight", "model.layers.0.norm3.bias",
                 "input_module.heads.0.0.weight", "output_modules.0.estimator.0.fc.0.weight"):
        assert name in keys
    assert ("model.norm.weight" in keys) == NETS[net].get("with_layer_norm", False)
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
    fresh = _net(NETS[net], seed=1)  # another tree of the same shapes
    rebuilt = flatten(jax.device_get(transformer_params_from_state_dict(fresh, sd_)))
    want = flatten(jax.device_get(nets[net].params))
    assert sorted(rebuilt) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(rebuilt[k], v), k


def test_jax_bank_loads_in_the_port(case):
    _, jx, port, _ = case
    assert str(port["bank/jax_type"]) == "SimpleTransformer"
    assert np.array_equal(port["bank/jax_tokens"], jx["net_h4/scan_b1"])


def test_port_bank_loads_in_jax(case):
    _, jx, _, _ = case
    assert jx["bank/port_type"] == "SimpleTransformer"
    assert np.array_equal(jx["bank/port_tokens"], jx["net_h4/scan_b1"])
