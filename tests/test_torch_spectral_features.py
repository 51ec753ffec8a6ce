"""The port's mel, MFCC and chroma features against the JAX package's and
the goldens, on the CPU.

* ``dsp.mel_filterbank`` and ``dsp.dct_matrix`` against
  ``tests/goldens/filterbanks.npz`` with ``tests/test_filterbank_goldens.py``'s
  tolerances (mel rtol 1e-5 atol 1e-8, DCT rtol 1e-5 atol 1e-7, the full
  DCT basis orthonormal within 1e-4, the chroma filterbank rtol 1e-6), and
  the Slaney scale's anchors within 1e-12;
* ``MelSpec`` (Slaney and HTK, a band limit), ``MFCC`` (with and without
  the lifter, inputs reaching below the 1e-10 log floor) and ``Chroma``
  through their numpy and torch paths, against the JAX package's numpy
  path and ``jax_func``, within 1e-5 relative (atol 1e-5 of the largest
  value).

Inputs are drawn from a numpy seed at n_fft 256 (129 bins), sr 16 kHz.
JAX runs in this process, the port in one subprocess
(``torch_port_worker.py spectral_features``).
"""
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import mimikit_tpu as mmk

from tests.torch_port_harness import start_port

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "filterbanks.npz")
RTOL = 1e-5
SR, N_FFT = 16000, 256
# tag: (functional, kwargs, the input it takes)
FEATURES = {
    "mel": ("MelSpec", dict(n_mels=40, sr=SR, n_fft=N_FFT), "mag"),
    "mel_htk_band": ("MelSpec", dict(n_mels=24, fmin=100.0, fmax=6000.0, htk=True, sr=SR,
                                     n_fft=N_FFT), "mag"),
    "mfcc": ("MFCC", dict(n_mfcc=20), "mel_in"),
    "mfcc_lifter": ("MFCC", dict(n_mfcc=13, lifter=22), "mel_in"),
    "chroma": ("Chroma", dict(n_chroma=12, sr=SR, n_fft=N_FFT), "mag"),
}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spectral_features"))
    rng = np.random.default_rng(5)
    mag = np.abs(rng.standard_normal((2, 11, 1 + N_FFT // 2))).astype(np.float32)
    mel_in = (np.abs(rng.standard_normal((2, 11, 40))) * 3).astype(np.float32)
    mel_in[0, :3, :5] = 1e-12  # below the log floor
    inp = {"mag": mag, "mel_in": mel_in, "features": np.array(json.dumps(FEATURES))}
    run = start_port("spectral_features", inp, work)  # the port runs while JAX computes
    jx = {}
    for tag, (name, kw, src) in FEATURES.items():
        f = getattr(mmk, name)(**kw)
        jx[f"{tag}/np"] = np.asarray(f.np_func(inp[src]))
        jx[f"{tag}/torch"] = np.asarray(f.jax_func(jnp.asarray(inp[src])))
    return jx, run.result()


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.mark.parametrize("key", ["mel_16000_512_40", "mel_22050_2048_128"])
def test_mel_filterbank_matches_golden(case, goldens, key):
    _, port = case
    assert port[key].shape == goldens[key].shape
    np.testing.assert_allclose(port[key], goldens[key], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("key", ["dct_13_40", "dct_20_128"])
def test_dct_basis_matches_golden(case, goldens, key):
    _, port = case
    np.testing.assert_allclose(port[key], goldens[key], rtol=1e-5, atol=1e-7)


def test_dct_basis_is_orthonormal(case):
    _, port = case
    full = port["dct_full_40"]
    np.testing.assert_allclose(full @ full.T, np.eye(40), atol=1e-4)


def test_chroma_filterbank_matches_golden(case, goldens):
    _, port = case
    np.testing.assert_allclose(port["chroma_12_512"], goldens["chroma_12_512"], rtol=1e-6)


def test_slaney_scale_anchors(case):
    _, port = case
    np.testing.assert_allclose(port["mel_anchors"], [0.0, 15.0, 1.0, 42.0], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(float(port["hz_anchor"]), 6400.0, rtol=1e-12)


@pytest.mark.parametrize("tag", list(FEATURES))
@pytest.mark.parametrize("path", ["np", "torch"])
def test_feature_matches_jax(case, tag, path):
    jx, port = case
    got, want = port[f"{tag}/{path}"], jx[f"{tag}/{path}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))
