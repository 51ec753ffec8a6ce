"""The port's mu-law kernel pair (``ops/mulaw.py``, K10a/K10b) on the CPU.

On the CPU ``mulaw_compress`` and ``mulaw_expand`` run their plain PyTorch
twins, which spell the Pallas bodies' arithmetic
(``mimikit_tpu/ops/pallas_kernels.py:66-73,103-108``).  This holds them to
the JAX package's ``mulaw_compress``/``mulaw_expand`` run in interpret mode,
as ``tests/test_ops.py:72-84`` runs them: identical ints from compress and
floats within 1e-6 from expand, for q 256 and 32 and compression 1 and 0.5,
on clipped ``randn * 0.4``, on the exact values -1, 0 and 1, and on ragged
lengths.  A CPU tensor takes the plain twin and counts no launch; importing
the module imports no ``triton``.

JAX runs in this process; the port in one subprocess
(``torch_port_worker.py mulaw``).
"""
import numpy as np
import pytest

from mimikit_tpu.ops import pallas_kernels as pk

from tests.torch_port_harness import run_port

LEVELS = [(256, 1.0), (256, 0.5), (32, 1.0), (32, 0.5)]


def _inputs():
    rng = np.random.default_rng(17)
    return {
        "randn": np.clip(rng.standard_normal((4, 1000)) * 0.4, -1, 1).astype(np.float32),
        "exact": np.array([-1.0, 0.0, 1.0, -0.0, 0.5, -0.5], np.float32),
        "ragged": np.clip(rng.standard_normal(3001) * 0.4, -1, 1).astype(np.float32),
    }


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    inp, jx = {}, {}
    for name, x in _inputs().items():
        inp[f"x/{name}"] = x
        for q, c in LEVELS:
            key = f"{name}/{q}/{c}"
            jx[f"compress/{key}"] = np.asarray(pk.mulaw_compress(x, q, c, interpret=True))
    rng = np.random.default_rng(18)
    for q, c in LEVELS:
        for name, toks in (("all", np.arange(q, dtype=np.int32)),
                           ("ragged", rng.integers(0, q, 2049).astype(np.int32))):
            key = f"{name}/{q}/{c}"
            inp[f"q/{key}"] = toks
            jx[f"expand/{key}"] = np.asarray(pk.mulaw_expand(toks, q, c, interpret=True))
    port = run_port("mulaw", inp, str(tmp_path_factory.mktemp("port_mulaw")))
    return jx, port


@pytest.mark.parametrize("q,c", LEVELS)
@pytest.mark.parametrize("name", ["randn", "exact", "ragged"])
def test_compress_gives_jax_ints(case, name, q, c):
    jx, port = case
    key = f"compress/{name}/{q}/{c}"
    assert port[key].dtype == np.int32 and port[key].shape == jx[key].shape
    assert np.array_equal(port[key], jx[key])


@pytest.mark.parametrize("q,c", LEVELS)
@pytest.mark.parametrize("name", ["all", "ragged"])
def test_expand_matches_jax(case, name, q, c):
    jx, port = case
    key = f"expand/{name}/{q}/{c}"
    assert port[key].dtype == np.float32 and port[key].shape == jx[key].shape
    np.testing.assert_allclose(port[key], jx[key], rtol=0, atol=1e-6)


def test_exact_values_hit_the_ends_and_the_middle(case):
    _, port = case
    assert port["compress/exact/256/1.0"][:4].tolist() == [0, 128, 255, 128]


def test_cpu_tensors_take_the_plain_twins(case):
    _, port = case
    assert port["cpu/launches"].tolist() == [0, 0]
    assert bool(port["cpu/equal_plain"])


def test_import_loads_no_triton(case):
    _, port = case
    assert not bool(port["triton_loaded"])
