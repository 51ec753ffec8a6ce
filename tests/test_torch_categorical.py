"""The categorical sampler (K9's port) and the ``sampler_impl`` route, on the CPU.

On the CPU ``ops.categorical.categorical`` runs its plain PyTorch twin, the
Gumbel-argmax the CUDA kernel computes (the kernel itself is held to the
twin on the card by ``chip_smoke.py``):

* leading dims are kept, Q need not be a power of two, every index is a
  real class;
* a cold temperature gives the argmax; one seed gives one draw;
* many draws follow ``softmax(logits / t)`` (a chi-square test), as draws of
  JAX's ``jax.random.categorical`` do — JAX's Pallas sampler has no CPU
  path for its PRNG (``tests/test_ops.py:120-131``), so its distribution is
  the reference;
* ``CategoricalSampler(impl="pallas")`` reaches the sampler with a seed
  drawn from the caller's generator; a per-example temperature takes the
  plain route;
* ``mulaw_io(MuLawIOConfig(sampler_impl=...))`` writes the same objective
  params in both packages, and each package's YAML keeps ``impl`` in the
  other.

JAX runs in this process; the port in one subprocess
(``torch_port_worker.py categorical``).  The card cases (marked ``cuda``,
skipped without a card) hold the CUDA kernel to the plain twin in a
subprocess that imports no JAX: f32 logits at the decode path's 256 x 256
and the ragged 3 x 7 x 200 (Q = 200), logits past the kernel's fast
division (-inf, 1e-13, 1e13), bf16 and f16 logits, and strided views
read in place (rows apart by a stride, an offset that breaks the kernel's
four-logit loads): every drawn index within 1e-4 * max|score| of its row's
maximum under the twin's scores, one launch a call.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import stats

import jax
import mimikit_tpu as mmk

from tests.torch_port_harness import ROOT, run_port

CHI_Q, CHI_N, CHI_T = 8, 40000, 0.8


def _expected(logits, t):
    z = logits / t
    p = np.exp(z - z.max())
    return p / p.sum()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(5)
    sharp = rng.standard_normal((64, 100)).astype(np.float32)
    sharp[np.arange(64), rng.integers(0, 100, 64)] += 20.0  # a clear winner a row
    inp = {
        "ragged": rng.standard_normal((3, 7, 200)).astype(np.float32),
        "sharp": sharp,
        "chi_logits": rng.standard_normal((1, CHI_Q)).astype(np.float32),
        "chi_n": np.array(CHI_N),
        "chi_t": np.array(CHI_T),
    }
    jx = {}
    for impl in ("jax", "pallas"):
        io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(sampler_impl=impl))
        jx[f"io/{impl}/params"] = io.targets[0].objective.params
        inp[f"io/{impl}/yaml"] = np.array(io.serialize())
    port = run_port("categorical", inp, str(tmp_path_factory.mktemp("port_cat")))
    for impl in ("jax", "pallas"):
        back = mmk.Config.deserialize(str(port[f"io/{impl}/yaml"]), as_type=mmk.IOSpec)
        jx[f"io/{impl}/loaded_impl"] = back.targets[0].objective.get_sampler().impl
    logits = inp["chi_logits"][0]
    draws = jax.random.categorical(jax.random.PRNGKey(3), logits / CHI_T, shape=(CHI_N,))
    jx["chi_draws"] = np.asarray(draws)
    return inp, jx, port


def test_shapes_and_classes(case):
    inp, _, port = case
    out = port["ragged"]
    assert out.shape == inp["ragged"].shape[:-1] and out.dtype == np.int32
    assert out.min() >= 0 and out.max() < inp["ragged"].shape[-1]


def test_cold_temperature_is_argmax(case):
    inp, _, port = case
    assert np.array_equal(port["cold"], inp["sharp"].argmax(-1))


def test_same_seed_same_draw(case):
    _, _, port = case
    assert np.array_equal(port["same_a"], port["same_b"])
    assert not np.array_equal(port["same_a"], port["other"])


def test_no_kernel_launch_on_cpu_tensors(case):
    _, _, port = case
    assert int(port["launches"]) == 0


@pytest.mark.parametrize("who", ["port", "jax"])
def test_draws_follow_the_tempered_softmax(case, who):
    """Chi-square goodness of fit of CHI_N draws against softmax(l / t),
    rejected at p < 1e-4."""
    inp, jx, port = case
    draws = port["chi_draws"] if who == "port" else jx["chi_draws"]
    counts = np.bincount(draws.reshape(-1), minlength=CHI_Q)
    expected = _expected(inp["chi_logits"][0].astype(np.float64), CHI_T) * draws.size
    assert stats.chisquare(counts, expected).pvalue > 1e-4


def test_port_and_jax_draws_share_a_distribution(case):
    """Two-sample chi-square between the port's and JAX's draws."""
    _, jx, port = case
    a = np.bincount(port["chi_draws"].reshape(-1), minlength=CHI_Q)
    b = np.bincount(jx["chi_draws"], minlength=CHI_Q)
    assert stats.chi2_contingency(np.stack([a, b])).pvalue > 1e-4


def test_pallas_impl_reaches_the_sampler(case):
    """impl="pallas" with a scalar temperature draws ``categorical`` with a
    seed drawn from the caller's generator."""
    _, _, port = case
    assert np.array_equal(port["sampler_pallas"], port["sampler_pallas_ref"])


def test_per_example_temperature_takes_the_plain_route(case):
    inp, _, port = case
    out = port["sampler_tuple"]
    assert out.shape == inp["ragged"].shape[:1]
    assert out.min() >= 0 and out.max() < inp["ragged"].shape[-1]


@pytest.mark.parametrize("impl", ["jax", "pallas"])
def test_sampler_impl_objective_params_match_jax(case, impl):
    """The same MuLawIOConfig writes the same objective params in both
    packages: {} for "jax", {"sampler_impl": "pallas"} otherwise."""
    _, jx, port = case
    assert json.loads(str(port[f"io/{impl}/params"])) == jx[f"io/{impl}/params"]
    assert jx[f"io/{impl}/params"] == ({} if impl == "jax" else {"sampler_impl": "pallas"})


@pytest.mark.parametrize("impl", ["jax", "pallas"])
def test_sampler_impl_round_trips_between_packages(case, impl):
    _, jx, port = case
    assert str(port[f"io/{impl}/loaded_impl"]) == impl
    assert jx[f"io/{impl}/loaded_impl"] == impl


_CARD_CHECK = """
import torch
import chip_smoke as cs
from mimikit_tpu_torch.ops import categorical as cat
n = cat.categorical.launches
cs.check_categorical(torch, cat)
assert cat.categorical.launches == n + len(cs.CAT_SHAPES) + 1 + len(cs.CAT_VIEWS)
assert {v[1] for v in cs.CAT_VIEWS} >= {200} and {v[4] for v in cs.CAT_VIEWS} >= {"bfloat16"}
assert any(v[3] % 4 for v in cs.CAT_VIEWS)  # a view the kernel reads one logit at a time
print("ok")
"""


@pytest.mark.cuda
def test_kernel_matches_plain_twin_on_card():
    env = dict(os.environ, PYTHONPATH=ROOT)
    probe = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
                           capture_output=True, text=True, env=env)
    if probe.stdout.strip() != "True":
        pytest.skip("needs a CUDA device and nvcc (run on the card: python3 chip_smoke.py)")
    res = subprocess.run([sys.executable, "-c", _CARD_CHECK], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
