"""The port's bf16 training path against the JAX package's, on the CPU.

``trainer_kwargs={"param_dtype": "bfloat16"}`` keeps f32 master weights and
runs SampleRNN's forward and backward in bf16, its LSTM tiers through the
bf16-stream fused LSTM layer (K3a/K3b on bf16 streams; on the CPU their
plain twins).  Held to the JAX package, whose side runs in one subprocess
(this file run as a script) with XLA's excess precision off (``XLA_PER_OP``:
every bf16 op rounds, as the Pallas kernels' ``.astype(bf16)`` asks) and
``MMK_FUSED_LSTM=1`` (the Pallas LSTM in interpret mode), as
``tests/test_torch_bf16_decode.py`` runs it; the port runs in another
(``torch_port_worker.py bf16_train``):

* the layer: the port's bf16 ``fused_lstm_layer`` against
  ``pallas_lstm.fused_lstm_layer`` on the same bf16 inputs, at
  ``tests/test_torch_fused_lstm.py``'s four (T, B, H) cases: the three
  outputs and the six gradients (random cotangents on the three outputs, and
  on h_all only).  Tolerance: every tensor within ``ULPS`` = 1 bf16 ulp of
  its scale (the ulp of max|JAX|, 2^(floor(log2 max) - 7)), and at most
  ``SHARE`` = 5 % of a case's elements different at all.  Both sides round
  the same values at the same points (h and dz to bf16 once, c and the gates
  where stored, the products' results once), so most elements are equal; an
  f32 sum taken in another order flips a bf16 rounding now and then, and a
  flipped h feeds the later steps (when this was written: 0.05 % of one
  case's h_all-only gradients differed, by less than 0.01 ulp of their
  scale; at other input seeds, up to 0.5 ulp and 5 % of one tensor).  A
  control — the same layer with kernels that leave h and dz unrounded (the
  f32 plain versions on the bf16 values, outputs rounded where stored) —
  differs in 26-44 % of each case's elements, by up to 1 ulp, and must fail;
* SampleRNN's train forward under the policy gives bf16 at every float
  output and carry (no promotion leak; JAX's ``tests/test_precision.py:69-89``);
* three steps of ``TrainARMLoop`` under ``param_dtype="bfloat16"`` from the
  JAX weights and data_seed: each step's loss closer to JAX's bf16 loop than
  a tenth of JAX's own bf16-to-f32 gap at that step (a port that silently
  trained in f32 would sit at that whole gap; when this was written the
  first two steps' losses were equal and the third 2.4 % of the gap away),
  and the master parameters and optimizer state f32;
* three steps of WaveNet (``tests/test_torch_train.py``'s stateless net,
  the same data) under ``param_dtype="bfloat16"``: each step's loss closer
  to JAX's bf16 loop than a tenth of JAX's bf16-to-f32 gap, the bound
  SampleRNN's test holds.  The port rounds the conv's product before its
  bias, as flax's ``nn.Conv`` does, and its bf16 backward follows JAX's
  rules (``modules/rounding.py``): when this was written the three steps sat
  at 0, 0.003 and 0 of the gap.  A control, the conv's bias back inside the
  product (the port before that fix), must miss the bound;
* SimpleTransformer and JukeBox the same way (when this was written
  0.0013, 0.0022, 0 and 0, 0.006, 0.0036 of the gap).  Their layer norm's
  rsqrt is XLA's CPU rsqrt (``modules/xla_cpu_rsqrt``) and its f32 row sums
  of 32 XLA's two 8-lane registers halved (``rounding._row_sum``).  Three
  controls must miss the bound: the bf16 softmax differentiated by
  PyTorch's autograd, the layer norm with ``torch.rsqrt``, and (JukeBox)
  a row's 16 partial sums added in order;
* cross-entropy of bf16 logits at |x| ~ 1e5 (past 2^15, where one bf16 ulp
  exceeds f32's exp underflow range): finite and equal to the f64 value of
  the same logits on the host (``rtol=1e-6``; JAX's case is
  ``tests/test_io_modules.py::test_cross_entropy_finite_at_huge_logits_and_grads_flow``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_port_harness import ROOT, flatten, run_port

XLA_PER_OP = "--xla_allow_excess_precision=false"
CASES = {"t12b4h16": (12, 4, 16), "t7b2h8": (7, 2, 8), "t32b8h16": (32, 8, 16),
         "t67b3h8": (67, 3, 8)}
D = 8
OUTS = ("h_all", "h_T", "c_T")
GRADS = ("dx", "dWi", "dWh", "db", "dh0", "dc0")
ULPS, SHARE = 1.0, 0.05
SR, Q, H, FS = 16000, 32, 16, (8, 4, 2)
# the stateless nets whose bf16 loop the port follows
STATELESS_BF16 = ("wavenet", "transformer", "jukebox")
# the nets with a bf16 softmax and layer norm (the controls below)
TRANSFORMERS = ("transformer", "jukebox")
TRAIN = dict(batch_size=4, batch_length=64, tbptt_chunk_length=256, max_epochs=3,
             limit_train_batches=1, MONITOR_TRAINING=False, every_n_epochs=1,
             CHECKPOINT_TRAINING=False)


def _layer_inputs(T, B, H, seed):
    """Layer inputs and cotangents from a numpy seed, rounded to bf16 values."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    d = dict(x=f(T, B, D), Wi=f(D, 4 * H, sc=D ** -0.5), Wh=f(H, 4 * H, sc=H ** -0.5),
             b=f(4 * H, sc=0.1), h0=f(B, H, sc=0.3), c0=f(B, H, sc=0.3),
             dh_all=f(T, B, H), dh_T=f(B, H), dc_T=f(B, H))
    return {k: v.astype(ml_dtypes.bfloat16).astype(np.float32) for k, v in d.items()}


def _wav(path):
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    y = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(SR)
    wavfile.write(path, SR, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))


def _jax_side(path: str, work: str) -> None:
    """JAX's bf16 layer on the four cases and its f32 and bf16 loops, saved
    to ``path`` with their inputs and the initial weights."""
    import jax
    import jax.numpy as jnp

    import mimikit_tpu as mmk
    from mimikit_tpu.ops.pallas_lstm import fused_lstm_layer

    inp = {"work": np.array(work)}
    for i, (tag, (T, B, Hc)) in enumerate(CASES.items()):
        d = _layer_inputs(T, B, Hc, seed=i)
        p = f"layer/{tag}/"
        inp.update({p + k: v for k, v in d.items()})
        args = tuple(jnp.asarray(d[k], jnp.bfloat16) for k in ("x", "Wi", "Wh", "b", "h0", "c0"))
        out, vjp = jax.vjp(lambda *a: fused_lstm_layer(*a, interpret=True), *args)
        for n, v in zip(OUTS, out):
            inp[f"jax/{tag}/{n}"] = np.asarray(v.astype(jnp.float32))
        cts = tuple(jnp.asarray(d[k], jnp.bfloat16) for k in ("dh_all", "dh_T", "dc_T"))
        for n, g in zip(GRADS, vjp(cts)):
            inp[f"jax/{tag}/grad_{n}"] = np.asarray(g.astype(jnp.float32))
        only_h = (cts[0], jnp.zeros_like(cts[1]), jnp.zeros_like(cts[2]))
        for n, g in zip(GRADS, vjp(only_h)):
            inp[f"jax/{tag}/grad_h_only_{n}"] = np.asarray(g.astype(jnp.float32))

    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=Q, mlp_dim=H),
                             extractor=ds.extractors[0])
    net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(frame_sizes=FS, hidden_dim=H, io_spec=io))
    net.seed(0)
    net.init_params()
    params0 = jax.device_get(net.params)
    inp.update(flatten(params0, "params0/"))
    inp["net_yaml"] = np.array(net.config.serialize())
    for dtype in ("float32", "bfloat16"):
        net.params = params0
        cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, f"jax_{dtype}"), **TRAIN,
                                 trainer_kwargs={"data_seed": 5, "param_dtype": dtype})
        loop = mmk.TrainARMLoop.from_config(cfg, db, net)
        logged = []
        log_output = loop.metrics.log_output
        loop.metrics.log_output = lambda d, f=log_output: logged.append(dict(d)) or f(d)
        loop.run()
        db = ds.get(mode="r")
        inp[f"jax_losses/{dtype}"] = np.array([d["loss"] for d in logged])
        if dtype == "bfloat16":
            inp["train_yaml"] = np.array(cfg.serialize())
    inp.update(wav=np.array(wav), jax_h5=np.array(ds.filename))
    db.close()
    rng = np.random.default_rng(7)
    inp["ce_logits"] = (rng.standard_normal((64, 256)) * 3e4).astype(np.float32)
    inp["ce_targets"] = rng.integers(0, 256, (64,)).astype(np.int64)
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's side in a subprocess with bf16 rounded at every op, then the
    port's."""
    tmp = str(tmp_path_factory.mktemp("bf16_train"))
    path = os.path.join(tmp, "jax.npz")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", MMK_FUSED_LSTM="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + XLA_PER_OP).strip())
    res = subprocess.run([sys.executable, os.path.abspath(__file__), path, tmp],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(path, allow_pickle=False) as f:
        inp = dict(f)
    return inp, run_port("bf16_train", inp, tmp)


def _jax_stateless(path: str, work: str, kinds=STATELESS_BF16) -> None:
    """The f32 and bf16 loops of ``tests/test_torch_train.py``'s stateless
    nets ``kinds`` (the same weights and data), saved to ``path``."""
    from tests.test_torch_train import _stateless_net

    import jax
    import mimikit_tpu as mmk
    from tests.torch_port_harness import flatten

    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    inp = {"work": np.array(work), "wav": np.array(wav), "jax_h5": np.array(ds.filename)}
    for kind in kinds:
        net = _stateless_net(kind, ds)
        params0 = jax.device_get(net.params)
        inp.update(flatten(params0, f"{kind}/params0/"))
        inp[f"{kind}/net_yaml"] = np.array(net.config.serialize())
        for dtype in ("float32", "bfloat16"):
            net.params = params0
            cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, f"jax_{kind}_{dtype}"), **TRAIN,
                                     trainer_kwargs={"data_seed": 5, "param_dtype": dtype})
            loop = mmk.TrainARMLoop.from_config(cfg, db, net)
            logged = []
            log_output = loop.metrics.log_output
            loop.metrics.log_output = lambda d, f=log_output: logged.append(dict(d)) or f(d)
            loop.run()
            db = ds.get(mode="r")
            inp[f"{kind}/jax_losses/{dtype}"] = np.array([d["loss"] for d in logged])
            if dtype == "bfloat16":
                inp[f"{kind}/train_yaml"] = np.array(cfg.serialize())
    db.close()
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def stateless(tmp_path_factory):
    """The stateless nets' JAX loops in a subprocess with bf16 rounded at
    every op, then the port's bf16 loop and its control."""
    tmp = str(tmp_path_factory.mktemp("bf16_stateless"))
    path = os.path.join(tmp, "jax.npz")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + XLA_PER_OP).strip())
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "stateless", path, tmp],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(path, allow_pickle=False) as f:
        inp = dict(f)
    return inp, run_port("bf16_train_stateless", inp, tmp)


def _check(inp, port, who, tag, names):
    """Raise unless each named tensor of ``who`` lies within ULPS of the
    JAX tensor's scale and at most SHARE of the case's elements differ."""
    differ = total = 0
    for n in names:
        ref, got = inp[f"jax/{tag}/{n}"], port[f"{who}/{tag}/{n}"]
        assert got.shape == ref.shape, n
        scale = float(np.abs(ref).max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        gap = float(np.abs(got - ref).max()) / ulp
        assert gap <= ULPS, f"{n}: {gap:.3f} bf16 ulps of its scale"
        differ += int((got != ref).sum())
        total += ref.size
    assert differ <= SHARE * total, f"{differ / total:.2%} of the elements differ"


CHECKS = {"outputs_and_grads": OUTS + tuple(f"grad_{n}" for n in GRADS),
          "h_all_cotangent_only": tuple(f"grad_h_only_{n}" for n in GRADS)}


@pytest.mark.parametrize("tag", CASES)
@pytest.mark.parametrize("check", CHECKS)
def test_bf16_layer_matches_pallas_interpret(case, tag, check):
    inp, port = case
    _check(inp, port, "layer", tag, CHECKS[check])


@pytest.mark.parametrize("tag", CASES)
def test_control_without_h_and_dz_rounding_fails(case, tag):
    """The control leaves the recurrent product's h and the backward's dz
    unrounded: the check above must refuse it."""
    inp, port = case
    with pytest.raises(AssertionError):
        _check(inp, port, "control", tag, CHECKS["outputs_and_grads"])


def test_samplernn_bf16_train_forward_has_no_promotion_leak(case):
    _, port = case
    dtypes = port["forward_dtypes"].tolist()
    assert len(dtypes) == 1 + 2 * (len(FS) - 1)  # the logits, (c, h) of each LSTM tier
    assert set(dtypes) == {"torch.bfloat16"}, dtypes


def test_bf16_losses_per_step_follow_jax_bf16_loop(case):
    inp, port = case
    j16, j32, got = inp["jax_losses/bfloat16"], inp["jax_losses/float32"], port["losses"]
    assert got.shape == j16.shape == j32.shape == (3,)
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got - j16) < 0.1 * np.abs(j16 - j32)), (got, j16, j32)


def _follows(inp, got, kind, steps=3):
    j16, j32 = inp[f"{kind}/jax_losses/bfloat16"], inp[f"{kind}/jax_losses/float32"]
    assert got.shape == j16.shape == j32.shape == (3,)
    assert np.all(np.isfinite(got))
    got, j16, j32 = got[:steps], j16[:steps], j32[:steps]
    assert np.all(np.abs(got - j16) < 0.1 * np.abs(j16 - j32)), (got, j16, j32)


@pytest.mark.parametrize("kind", STATELESS_BF16)
def test_stateless_bf16_losses_per_step_follow_jax_bf16_loop(stateless, kind):
    inp, port = stateless
    _follows(inp, port[f"{kind}/losses"], kind)


@pytest.mark.parametrize("kind", ("wavenet",))
def test_control_with_the_bias_inside_the_product_fails(stateless, kind):
    """The control adds each conv's bias inside the product (one rounding
    for both, ``nn.Conv1d``'s): the check above must refuse it."""
    inp, port = stateless
    with pytest.raises(AssertionError):
        _follows(inp, port[f"{kind}/control_losses"], kind)


@pytest.mark.parametrize("kind", TRANSFORMERS)
def test_control_with_pytorchs_softmax_gradient_fails(stateless, kind):
    """The control differentiates the bf16 softmax with PyTorch's autograd
    (the port before JAX's transpose was given to it): the three-step check
    must refuse it."""
    inp, port = stateless
    with pytest.raises(AssertionError):
        _follows(inp, port[f"{kind}/control_losses"], kind)


@pytest.mark.parametrize("kind", TRANSFORMERS)
def test_control_with_torchs_rsqrt_fails(stateless, kind):
    """The layer norm with ``torch.rsqrt`` (the port before XLA's CPU rsqrt
    was given to it): the three-step check must refuse it."""
    inp, port = stateless
    with pytest.raises(AssertionError):
        _follows(inp, port[f"{kind}/rsqrt_control_losses"], kind)


def test_control_with_row_partial_sums_added_in_order_fails(stateless):
    """JukeBox's layer norm with a row's 16 partial sums added in order (the
    port's row sum before XLA's two registers were read off its fused
    step): the three-step check must refuse it."""
    inp, port = stateless
    with pytest.raises(AssertionError):
        _follows(inp, port["jukebox/row_sum_control_losses"], "jukebox")


def test_master_parameters_and_optimizer_state_stay_f32(case):
    _, port = case
    assert port["master_dtypes"].tolist() == ["torch.float32"]


def test_cross_entropy_of_huge_bf16_logits_is_finite_and_exact(case):
    inp, port = case
    import ml_dtypes

    x = inp["ce_logits"].astype(ml_dtypes.bfloat16).astype(np.float64)
    assert np.abs(x).max() >= 2 ** 15
    m = x.max(-1, keepdims=True)
    lse = m[:, 0] + np.log(np.exp(x - m).sum(-1))
    want = float(np.mean(lse - x[np.arange(x.shape[0]), inp["ce_targets"]]))
    got = float(port["ce_huge"])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "stateless":
        _jax_stateless(sys.argv[2], sys.argv[3], *(sys.argv[4:5] and [sys.argv[4].split(",")]))
    else:
        _jax_side(sys.argv[1], sys.argv[2])
