"""The port's spectral functionals and modules against the JAX package, on
the CPU.

* ``STFT`` at ``center`` True and False and ``alignment`` "end" and "start"
  ("pol" coordinates), ``ISTFT``, ``MagSpec``: the torch path against
  ``jax_func`` and the numpy path against the JAX package's numpy path;
* Griffin-Lim: three iterations from the same ``init_phase`` (the port's
  ``_griffinlim_torch`` against ``dsp._griffinlim_impl`` under jax.numpy),
  and ``GLA.np_func`` (seeded numpy phase) against the JAX package's; the
  seeded torch functional agrees only in distribution (its phase is drawn
  by a ``torch.Generator``, not ``jax.random``), so it is held to the
  shape and to finite values;
* ``LinearIO`` and ``ChunkedLinearIO`` (one and three chunks, ``Abs`` and
  no activation) with JAX's weights; ``MeanL1Prop`` and its gradient, with
  target slices above and below the unit sum;
* ``IOSpec.magspec_io``: the JAX-written YAML read back by the port, its
  objective's criterion, and its batches: the port's ``DeviceBatcher`` (CPU
  tensors) on the JAX-written store against JAX's loader, the same
  ``data_seed``.

Tolerances: the FFT paths (STFT, ISTFT, MagSpec, GLA, the batches) within
rtol 1e-5 and atol 1e-5 * max|x|; the rest within 1e-6.  Sizes: n_fft 64,
hop_length 16.  JAX runs in this process; the port in one subprocess
(``torch_port_worker.py spectral``).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk
from mimikit_tpu.features import dsp

from tests.torch_port_harness import run_port

N_FFT, HOP, SR = 64, 16, 16000
GLA_ITERS = 3
FFT_RTOL, FFT_ATOL = 1e-5, 1e-5  # atol scaled by max|x|
TOL = 1e-6
IO_CASES = {
    "linear": ("LinearIO", dict(), 12, 9),
    "chunked1_abs": ("ChunkedLinearIO", dict(n_chunks=1, activation="Abs"), 33, 16),
    "chunked3": ("ChunkedLinearIO", dict(n_chunks=3), 16, 33),
    "chunked3_abs": ("ChunkedLinearIO", dict(n_chunks=3, activation="Abs"), 16, 33),
}
TRAIN = dict(batch_size=4, max_epochs=1, MONITOR_TRAINING=False, CHECKPOINT_TRAINING=False,
             trainer_kwargs={"data_seed": 5})


def fft_close(got, want, name=""):
    np.testing.assert_allclose(got, want, rtol=FFT_RTOL,
                               atol=FFT_ATOL * float(np.abs(want).max()), err_msg=name)


def _wav(path, seconds=1.0):
    from scipy.io import wavfile

    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(11)
    y = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 587 * t)
    y = y + 0.05 * rng.standard_normal(t.size)
    wavfile.write(path, SR, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))


def _io_module(kind, kw, in_dim, out_dim):
    kw = dict(kw)
    act = kw.pop("activation", None)
    if act is not None:
        kw["activation"] = mmk.ActivationConfig(act=act)
    cfg = getattr(mmk, kind)(**kw)
    yaml = cfg.serialize()
    return yaml, cfg.set(in_dim=in_dim, out_dim=out_dim).module()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spectral"))
    rng = np.random.default_rng(7)
    y = rng.standard_normal((3, 1003)).astype(np.float32)
    jx, inp = {}, {"signal": y, "n_fft": np.array(N_FFT), "hop": np.array(HOP)}
    for center in (True, False):
        for al in ("end", "start"):
            f = mmk.STFT(N_FFT, HOP, "pol", center, "hann", alignment=al)
            jx[f"stft/{center}/{al}/torch"] = np.asarray(f.jax_func(jnp.asarray(y)))
            jx[f"stft/{center}/{al}/np"] = f.np_func(y)
    pol = jx["stft/True/end/np"]
    inp["pol"] = pol
    for center in (True, False):
        f = mmk.ISTFT(N_FFT, HOP, "pol", center, "hann")
        jx[f"istft/{center}/torch"] = np.asarray(f.jax_func(jnp.asarray(pol)))
        jx[f"istft/{center}/np"] = f.np_func(pol)
    m = mmk.MagSpec(N_FFT, HOP, center=False, window="hann")
    jx["magspec/torch"] = np.asarray(m.jax_func(jnp.asarray(y)))
    jx["magspec/np"] = m.np_func(y)
    mag = jx["magspec/np"]
    phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    inp["gla_mag"], inp["gla_phase"] = mag, phase
    gla = jax.jit(lambda a, p: dsp._griffinlim_impl(jnp, a, N_FFT, HOP, False, "hann",
                                                    GLA_ITERS, 0.99, p))
    jx["gla/torch"] = np.asarray(gla(jnp.asarray(mag), jnp.asarray(phase)))
    jx["gla/np"] = mmk.GLA(N_FFT, HOP, center=False, n_iter=GLA_ITERS).np_func(mag)
    for tag, (kind, kw, in_dim, out_dim) in IO_CASES.items():
        yaml, mod = _io_module(kind, kw, in_dim, out_dim)
        x = rng.standard_normal((2, 5, in_dim)).astype(np.float32)
        shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x)["params"]
        n_out = shapes["core"]["Dense_0"]["kernel"].shape[1]
        kernel = (rng.standard_normal((in_dim, n_out)) * in_dim ** -0.5).astype(np.float32)
        bias = (rng.standard_normal(n_out) * 0.1).astype(np.float32)
        params = {"core": {"Dense_0": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}}
        jx[f"io/{tag}/y"] = np.asarray(mod.apply({"params": params}, x))
        inp.update({f"io/{tag}/yaml": np.array(yaml), f"io/{tag}/in_dim": np.array(in_dim),
                    f"io/{tag}/out_dim": np.array(out_dim), f"io/{tag}/kernel": kernel,
                    f"io/{tag}/bias": bias, f"io/{tag}/x": x})
    crit = mmk.MeanL1Prop()
    loss_grad = jax.jit(jax.value_and_grad(lambda o, tg: crit(o, tg)))
    for tag, scale in (("big", 1.0), ("small", 0.01)):
        o = rng.standard_normal((4, 6, 33)).astype(np.float32)
        tg = (np.abs(rng.standard_normal((4, 6, 33))) * scale).astype(np.float32)
        tg[:, 2] *= 1e-3  # a slice far below the unit sum in both cases
        loss, grad = loss_grad(jnp.asarray(o), jnp.asarray(tg))
        jx[f"l1/{tag}/loss"], jx[f"l1/{tag}/grad"] = np.asarray(loss), np.asarray(grad)
        inp[f"l1/{tag}/output"], inp[f"l1/{tag}/target"] = o, tg
    # magspec_io's batches through each package's loader on one store
    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    io = mmk.IOSpec.magspec_io(mmk.IOSpec.MagSpecIOConfig(sr=SR, n_fft=N_FFT, hop_length=HOP),
                               extractor=ds.extractors[0])
    net = mmk.Seq2SeqLSTMNetwork.from_config(mmk.Seq2SeqLSTMNetwork.Config(
        io_spec=io, model_dim=16, hop=4))
    cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, "jax"), batch_length=4, **TRAIN)
    batches = []
    for k, (xs, ys) in enumerate(mmk.TrainARMLoop.get_dataloader(db, net, cfg)):
        if k == 3:
            break
        batches.append((np.asarray(xs[0]), np.asarray(ys[0])))
    jx["batches"] = batches
    db.close()
    inp.update({"io_yaml": np.array(io.serialize()), "wav": np.array(wav),
                "jax_h5": np.array(ds.filename), "net_yaml": np.array(net.config.serialize()),
                "train_yaml": np.array(cfg.serialize())})
    jx["io_yaml"] = io.serialize()
    return jx, run_port("spectral", inp, work)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("alignment", ["end", "start"])
@pytest.mark.parametrize("path", ["torch", "np"])
def test_stft_matches_jax(case, center, alignment, path):
    jx, port = case
    key = f"stft/{center}/{alignment}/{path}"
    assert port[key].shape == jx[key].shape
    fft_close(port[key][..., 0], jx[key][..., 0], "magnitude")
    # the angle where the magnitude is not negligible (an angle of ~0 is noise)
    mask = jx[key][..., 0] > 1e-3 * jx[key][..., 0].max()
    d = np.angle(np.exp(1j * (port[key][..., 1] - jx[key][..., 1])))
    assert np.abs(d[mask]).max() < 1e-4


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("path", ["torch", "np"])
def test_istft_matches_jax(case, center, path):
    jx, port = case
    fft_close(port[f"istft/{center}/{path}"], jx[f"istft/{center}/{path}"])


@pytest.mark.parametrize("path", ["torch", "np"])
def test_magspec_matches_jax(case, path):
    jx, port = case
    assert port[f"magspec/{path}"].shape == (3, 1 + (1003 - N_FFT) // HOP, 1 + N_FFT // 2)
    fft_close(port[f"magspec/{path}"], jx[f"magspec/{path}"])


@pytest.mark.parametrize("path", ["torch", "np"])
def test_griffin_lim_matches_jax_from_the_same_phase(case, path):
    """From one ``init_phase`` (torch) or one seeded numpy phase (np): the
    same three iterations, the same signal."""
    jx, port = case
    fft_close(port[f"gla/{path}"], jx[f"gla/{path}"])


def test_seeded_griffin_lim_is_finite_and_shaped(case):
    """The torch functional's own phase (a seeded torch.Generator) cannot be
    JAX's draw: its output is held to the shape and to finite values."""
    jx, port = case
    out = port["gla/functional"]
    assert out.shape == jx["gla/np"].shape and np.isfinite(out).all()


@pytest.mark.parametrize("tag", list(IO_CASES))
def test_io_module_matches_jax(case, tag):
    jx, port = case
    np.testing.assert_allclose(port[f"io/{tag}/y"], jx[f"io/{tag}/y"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tag", ["big", "small"])
@pytest.mark.parametrize("what", ["loss", "grad"])
def test_mean_l1_prop_matches_jax(case, tag, what):
    jx, port = case
    np.testing.assert_allclose(port[f"l1/{tag}/{what}"], jx[f"l1/{tag}/{what}"], rtol=TOL,
                               atol=TOL)


def test_magspec_io_yaml_and_criterion(case):
    jx, port = case
    assert str(port["io_yaml"]) == jx["io_yaml"]
    assert str(port["criterion"]) == "MeanL1Prop"


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("part", ["in", "tgt"])
def test_device_batcher_serves_jax_loader_frames(case, k, part):
    """The same data_seed: the port's DeviceBatcher (MagSpec's torch path on
    the gathered windows) serves JAX's frames."""
    jx, port = case
    assert str(port["loader"]) == "DeviceBatcher"
    want = jx["batches"][k][0 if part == "in" else 1]
    assert want.shape == (4, 4, 1 + N_FFT // 2)
    fft_close(port[f"batches/{k}/{part}"], want)
