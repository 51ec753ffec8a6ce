"""The port's WaveNet against the JAX package, on the CPU.

On the CPU the decode kernel's wrappers run its plain PyTorch twin, so this
holds the twin — and with it the arithmetic the CUDA kernel is checked
against on the card — to the JAX reference:

* every ``WNLayer`` branch (gate on/off, 1x1 inputs, skips, residuals
  none/equal/unequal, ``pad_side`` 0/1/-1, affine residuals, groups) and the
  train-mode logits of whole nets equal JAX's within ``atol=1e-5``,
  ``rtol=1e-5`` (f32 summation order differs between XLA and torch);
* argmax tokens of ``WaveNet.generate`` equal the JAX scan decoder
  (``MMK_PALLAS_DECODE=0``) and, for nets in the kernel's scope, K4
  (``make_wavenet_pallas_decoder``) and K5 (``make_wavenet_pallas_chunked``,
  forced as ``test_pallas_decode.py`` forces it, several chunks and a
  partial last one) in interpret mode, through both port wrappers;
* streams equal one long decode; the gate, the weight maps and the
  checkpoint banks agree with the JAX package.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py wavenet``).  Weights are drawn from a numpy seed
with a spread (``WEIGHT_STD``) that keeps the argmax trajectories varied.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk
from mimikit_tpu.migrate import wavenet_params_from_state_dict
from mimikit_tpu.networks.wavenet import WNLayer
from mimikit_tpu.ops.pallas_decode import supports_pallas_wavenet

from tests.torch_port_harness import flatten, run_port

D, Q, B, N_STEPS = 16, 32, 2, 40
WEIGHT_STD = 0.25
# full nets: the kernel's scope (the first four) and nets outside it
NETS = {
    "b3": dict(blocks=(3,)),
    "b22": dict(blocks=(2, 2)),
    "b4": dict(blocks=(4,)),
    "b3_pad1_mlp1": dict(blocks=(3,), pad_side=1, n_mlp=1),
    "b3_tied": dict(blocks=(3,), tie_io_weights=True),
    "b3_noskip": dict(blocks=(3,), skips_dim=None),
    "b3_ungated": dict(blocks=(3,), act_g=None),
    "k3": dict(blocks=(2,), kernel_sizes=(3,)),
    "b22_rev_lw": dict(blocks=(2, 2), reverse_layer_order=True, layerwise_inputs=True),
    "b3_affine": dict(blocks=(3,), with_affine_residuals=True),
}
IN_GATE = ["b3", "b22", "b4", "b3_pad1_mlp1"]
K4_NETS, SHORT_NETS, STEP_NETS = ["b3", "b22"], ["b3", "b22"], ["b3", "b22_rev_lw"]
# K5 nets and the VMEM ring budget that forces their rings: b22's (d <= 2)
# all stay in VMEM; b4's d = 4, 8 rings go to HBM (DMA-streamed)
K5_NETS = {"b22": None, "b4": 4 * B * D * 3 + 1}
MIGRATABLE = [k for k in NETS if not NETS[k].get("with_affine_residuals")]
# WNLayer cases (dims_dilated (16,)): (kwargs, whether skips are fed in)
LAYERS = {
    "gate_skips_pad0": (dict(skips_dim=34, pad_side=0), True),
    "gate_res_equal_pad1_1x1": (dict(input_dim=7, residuals_dim=7, pad_side=1, dims_1x1=(8, 2)), False),
    "gate_res_unequal_pad0_1x1": (dict(input_dim=7, residuals_dim=5, skips_dim=34, pad_side=0,
                                       dims_1x1=(8, 2)), True),
    "ungated_pad1": (dict(act_g=None, pad_side=1), False),
    "ungated_res_pad0_1x1": (dict(act_g=None, residuals_dim=7, skips_dim=34, pad_side=0,
                                  dims_1x1=(8, 2)), True),
    "gate_res_pad_left": (dict(residuals_dim=7, skips_dim=34, pad_side=-1), True),
    "gate_affine_1x1": (dict(input_dim=7, residuals_dim=7, skips_dim=34, pad_side=0,
                             dims_1x1=(8, 2), with_affine_residuals=True), True),
    "ungated_affine_1x1": (dict(act_g=None, input_dim=7, residuals_dim=7, pad_side=1,
                                dims_1x1=(7,), with_affine_residuals=True), False),
    "gate_k3_dilation2": (dict(kernel_size=3, dilation=2, residuals_dim=16, skips_dim=8,
                               pad_side=0), True),
    "ungated_pad_left_res_unequal": (dict(act_g=None, input_dim=7, residuals_dim=5,
                                          pad_side=-1), False),
    "gate_groups2": (dict(input_dim=8, groups=2, residuals_dim=8, skips_dim=8, pad_side=1), False),
    "mish_gate_pad0": (dict(act_f="Mish", skips_dim=8, pad_side=0), True),
}
RF_BLOCKS = [(3,), (1, 1, 1, 1, 1, 1, 1), (2, 2, 1), (1, 2, 2), (1, 1, 1, 1, 2)]


def _io():
    return mmk.IOSpec.mulaw_io(
        mmk.IOSpec.MuLawIOConfig(q_levels=Q, mlp_dim=D, n_mlp_layers=0,
                                 input_module_type="embedding")
    )


def _random_params(init, *args, seed: int):
    """Parameters of ``init``'s shapes drawn from a numpy seed: N(0, 1)
    embeddings, N(0, WEIGHT_STD) for the rest (the shapes by
    ``jax.eval_shape``: compiling flax's init would dominate the module's
    time)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        std = 1.0 if "embedding" in jax.tree_util.keystr(path) else WEIGHT_STD
        return jnp.asarray(rng.standard_normal(s.shape) * std, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _net(spec, seed: int = 7):
    spec = dict(spec)
    n_mlp = spec.pop("n_mlp", 0)
    io = mmk.IOSpec.mulaw_io(
        mmk.IOSpec.MuLawIOConfig(q_levels=Q, mlp_dim=D, n_mlp_layers=n_mlp,
                                 input_module_type="embedding")
    )
    kw = dict(io_spec=io, dims_dilated=(D,), skips_dim=D, residuals_dim=D, pad_side=0)
    kw.update(spec)
    net = mmk.WaveNet.from_config(mmk.WaveNet.Config(**kw))
    net.seed(0)
    init = lambda key, x: net.module.init({"params": key, "dropout": key, "sample": key},  # noqa: E731
                                          x, None, True)
    net.params = _random_params(init, (jnp.zeros((1, net.rf + 1), jnp.int32),), seed=seed)
    return net


def _apply(net, seq, train: bool):
    """Train-mode logits or eval-mode argmax samples, jitted."""
    fn = jax.jit(lambda p, x: net.module.apply({"params": p}, (x,), None, train,
                                               rngs={"sample": jax.random.PRNGKey(0)})[0][0])
    return np.asarray(fn(net.params, seq))


def _tokens(net, prompt):
    return np.asarray(net.generate((prompt,), n_steps=N_STEPS, temperature=None)[0])


def _force_k5(mp, budget):
    """K5 in 16-step chunks (as test_pallas_decode.py:151-186 forces it)."""
    mp.setenv("MMK_PALLAS_DECODE", "1")
    if budget is not None:
        mp.setattr(mmk.WaveNet, "_CHUNK_VMEM_RING_BUDGET", budget)
    mp.setattr(mmk.WaveNet, "_PALLAS_CHUNK", 16)
    mp.setattr(mmk.WaveNet, "_PALLAS_CHUNK_MIN", 2)
    mp.setattr(mmk.WaveNet, "_PALLAS_CHUNKED_MIN_B", 2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(13)
    inp = {"n_steps": np.array(N_STEPS)}
    jx, nets = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMK_DECODE_UNROLL", "1")
        for tag, spec in NETS.items():
            net = nets[tag] = _net(spec)
            rf = net.rf
            p = f"net_{tag}/"
            prompt = rng.integers(0, Q, (B, rf + 3)).astype(np.int32)
            short = rng.integers(0, Q, (B, rf // 2 + 1)).astype(np.int32)
            seq = rng.integers(0, Q, (B, rf + 12)).astype(np.int32)
            inp.update({p + "yaml": np.array(net.config.serialize()), p + "prompt": prompt,
                        p + "short_prompt": short, p + "seq": seq})
            inp.update(flatten(jax.device_get(net.params), p + "params/"))
            jx[p + "forward"] = _apply(net, seq, True)
            jx[p + "eval"] = _apply(net, seq, False)
            jx[p + "in_gate"] = supports_pallas_wavenet(net)
            if tag in STEP_NETS:
                net.eval().before_generate((prompt,), 0)
                steps = [net.generate_step((prompt[:, : k + 1],), t=k + 1)
                         for k in range(rf, rf + 4)]
                jx[p + "generate_step"] = np.stack([np.asarray(s[0]) for s in steps], 1)
                net.after_generate(steps[-1], 0)
            mp.setenv("MMK_PALLAS_DECODE", "0")
            jx[p + "scan"] = _tokens(net, prompt)
            if tag in SHORT_NETS:
                jx[p + "short_scan"] = np.asarray(
                    net.generate((short,), n_steps=N_STEPS, temperature=None)[0])
            if tag in K4_NETS:
                mp.setenv("MMK_PALLAS_DECODE", "1")
                assert net._pallas_mode(B, prompt.shape[1], N_STEPS) == "single"
                jx[p + "k4"] = _tokens(net, prompt)
            if tag in K5_NETS:
                with pytest.MonkeyPatch.context() as mp5:
                    _force_k5(mp5, K5_NETS[tag])
                    assert net._pallas_mode(B, prompt.shape[1], N_STEPS) == "chunked"
                    jx[p + "k5"] = _tokens(net, prompt)
        for tag, (kw, feed) in LAYERS.items():
            p = f"layer_{tag}/"
            layer = WNLayer(**kw)
            in_dim = layer._dims()[0]
            x = rng.standard_normal((B, 8, in_dim)).astype(np.float32)
            ins_1x1 = tuple(rng.standard_normal((B, 8, d)).astype(np.float32)
                            for d in kw.get("dims_1x1", ()))
            skips = rng.standard_normal((B, 8, kw["skips_dim"])).astype(np.float32) if feed else None
            variables = {"params": _random_params(layer.init, (x,), ins_1x1, skips, seed=len(jx))}
            y, sk = jax.jit(layer.apply)(variables, (x,), ins_1x1, skips)
            inp.update({p + "kwargs": np.array(json.dumps(kw)), p + "x": x})
            inp.update({f"{p}x1x1_{i}": c for i, c in enumerate(ins_1x1)})
            if feed:
                inp[p + "skips"] = skips
            inp.update(flatten(jax.device_get(variables["params"]), p + "params/"))
            jx[p + "y"] = np.asarray(y)
            if sk is not None:
                jx[p + "skips"] = np.asarray(sk)
        inp["rf_blocks"] = np.array([list(b) + [0] * (7 - len(b)) for b in RF_BLOCKS])
        for blocks in RF_BLOCKS:
            jx[f"rf/{blocks}"] = mmk.WaveNet.from_config(
                mmk.WaveNet.Config(io_spec=_io(), blocks=blocks, dims_dilated=(16,))).rf
        # a bank written by the JAX package, for the port to load
        root = str(tmp_path_factory.mktemp("wn_banks"))
        mmk.Checkpoint(id="wn_jax", epoch=1, root_dir=root).create(network=nets["b3"])
        inp["bank_root"] = np.array(root)
        port = run_port("wavenet", inp, str(tmp_path_factory.mktemp("port_wn")))
        # the port's bank of the same weights, loaded and decoded by JAX
        mp.setenv("MMK_PALLAS_DECODE", "0")
        loaded = mmk.Checkpoint(id="wn_port", epoch=1, root_dir=root).network
        jx["bank/port_type"] = type(loaded).__name__
        jx["bank/port_tokens"] = _tokens(loaded, inp["net_b3/prompt"])
    return inp, jx, port, nets


@pytest.mark.parametrize("layer", LAYERS)
def test_wnlayer_branch_matches_jax(case, layer):
    _, jx, port, _ = case
    p = f"layer_{layer}/"
    assert port[p + "y"].shape == jx[p + "y"].shape
    np.testing.assert_allclose(port[p + "y"], jx[p + "y"], rtol=1e-5, atol=1e-5)
    assert (p + "skips" in port) == (p + "skips" in jx)
    if p + "skips" in jx:
        np.testing.assert_allclose(port[p + "skips"], jx[p + "skips"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", range(len(RF_BLOCKS)))
def test_rf_and_below_rf_contract(case, k):
    """rf as test_wavenet.py:232-256 computes it; an rf-long input gives one
    output, rf + 1 two, and rf - 1 raises."""
    _, jx, port, _ = case
    rf, n_rf, n_rf1, below = port["rf"][k]
    assert int(rf) == jx[f"rf/{RF_BLOCKS[k]}"] == 8
    assert (int(n_rf), int(n_rf1), below) == (1, 2, "RuntimeError")


@pytest.mark.parametrize("net", NETS)
def test_kernel_scope_gate_matches_jax(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert bool(port[p + "in_gate"]) == bool(jx[p + "in_gate"]) == (net in IN_GATE)


@pytest.mark.parametrize("net", NETS)
def test_forward_logits_match_jax(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert port[p + "forward"].shape == jx[p + "forward"].shape
    assert port[p + "forward"].shape[-1] == Q
    np.testing.assert_allclose(port[p + "forward"], jx[p + "forward"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("net", NETS)
def test_eval_forward_matches_jax(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert port[p + "eval"].shape == (B, 1)
    assert np.array_equal(port[p + "eval"], jx[p + "eval"])


@pytest.mark.parametrize("net", STEP_NETS)
def test_generate_step_matches_jax(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + "generate_step"], jx[p + "generate_step"])


@pytest.mark.parametrize("net", NETS)
def test_argmax_generate_matches_jax_scan(case, net):
    inp, jx, port, _ = case
    p = f"net_{net}/"
    out = port[p + "generate"]
    prior_t = inp[p + "prompt"].shape[1]
    assert out.shape == (B, prior_t + N_STEPS)
    assert len(set(out[0, prior_t:].tolist())) > 1, "degenerate decode"
    assert np.array_equal(out, jx[p + "scan"])


@pytest.mark.parametrize("net", NETS)
def test_chunked_generate_matches_jax_scan(case, net):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + "generate_chunked"], jx[p + "scan"])


@pytest.mark.parametrize("wrapper", ["generate", "generate_chunked"])
@pytest.mark.parametrize("net", K4_NETS)
def test_argmax_generate_matches_pallas_single_interpret(case, net, wrapper):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + wrapper], jx[p + "k4"])


@pytest.mark.parametrize("wrapper", ["generate", "generate_chunked"])
@pytest.mark.parametrize("net", K5_NETS)
def test_argmax_generate_matches_pallas_chunked_interpret(case, net, wrapper):
    _, jx, port, _ = case
    p = f"net_{net}/"
    assert np.array_equal(port[p + wrapper], jx[p + "k5"])


@pytest.mark.parametrize("net", SHORT_NETS)
def test_short_prompt_matches_jax_scan(case, net):
    """A prompt shorter than rf + 1 takes the plain step loop, zero-padded
    on the left as the JAX scan decoder pads it."""
    inp, jx, port, nets = case
    p = f"net_{net}/"
    assert inp[p + "short_prompt"].shape[1] < nets[net].rf + 1
    assert np.array_equal(port[p + "short"], jx[p + "short_scan"])


@pytest.mark.parametrize("net", NETS)
def test_argmax_stream_equals_one_long_decode(case, net):
    inp, jx, port, _ = case
    p = f"net_{net}/"
    prior_t = inp[p + "prompt"].shape[1]
    stream = port[p + "stream"]
    assert stream.shape == (B, (N_STEPS // 7) * 7)
    assert np.array_equal(stream, jx[p + "scan"][:, prior_t : prior_t + stream.shape[1]])


@pytest.mark.parametrize("chunk", [9, 13])
@pytest.mark.parametrize("net", IN_GATE)
def test_sampled_stream_equals_one_sampled_decode(case, net, chunk):
    """Noise is keyed by absolute step: a stream draws exactly what one
    ``generate`` call with the same seed draws, whatever the chunk."""
    inp, _, port, _ = case
    p = f"net_{net}/"
    prior_t = inp[p + "prompt"].shape[1]
    sampled, stream = port[p + "sampled"], port[f"{p}sampled_stream_{chunk}"]
    assert sampled.min() >= 0 and sampled.max() < Q
    assert stream.shape == (B, (N_STEPS // chunk) * chunk)
    assert np.array_equal(stream, sampled[:, prior_t : prior_t + stream.shape[1]])


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


@pytest.mark.parametrize("net", MIGRATABLE)
def test_migrate_reads_the_port_state_dict(case, net):
    """``migrate.wavenet_params_from_state_dict`` rebuilds the JAX tree from
    the port's state_dict (the ROADMAP's way of carrying weights over)."""
    _, _, port, nets = case
    p = f"net_{net}/sd/"
    sd_ = {k[len(p):]: v for k, v in port.items() if k.startswith(p)}
    fresh = _net(NETS[net], seed=1)  # another tree of the same shapes
    rebuilt = flatten(jax.device_get(wavenet_params_from_state_dict(fresh, sd_)))
    want = flatten(jax.device_get(nets[net].params))
    assert sorted(rebuilt) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(rebuilt[k], v), k


def test_jax_bank_loads_in_the_port(case):
    _, jx, port, _ = case
    assert str(port["bank/jax_type"]) == "WaveNet"
    assert np.array_equal(port["bank/jax_tokens"], jx["net_b3/scan"])


def test_port_bank_loads_in_jax(case):
    _, jx, _, _ = case
    assert jx["bank/port_type"] == "WaveNet"
    assert np.array_equal(jx["bank/port_tokens"], jx["net_b3/scan"])
