"""The port's CPU rsqrt against XLA's, bit for bit.

XLA's CPU backend lowers an f32 ``rsqrt`` to the x86 approximation
(``vrsqrtps``/``rsqrtss``) and two FMA Newton steps, and keeps the bare
approximation where x is not a positive normal number.  The port's bf16
layer norm on the CPU takes the same (``mimikit_tpu_torch/modules/
xla_cpu_rsqrt.py``, a C helper built with gcc at first use), so that
SimpleTransformer's bf16 steps follow JAX's (``tests/test_torch_bf16_train.py``).
Here ``jax.jit(jax.lax.rsqrt)`` runs in this process and the port in a
worker (``torch_port_worker.py xla_rsqrt``), on:

* 1M values drawn uniformly in [1e-4, 10] (the layer norm's var + eps lies
  there), and every 4099th f32 bit pattern (each exponent, both signs);
* the edges: zeros, subnormals, the smallest and largest normals,
  infinities, NaN and negatives;
* every prefix of the first 40 values, so that a value in the instruction's
  vector loop and in its scalar tail agree.

The results must be equal as bits (NaN where JAX's is NaN).  A control,
``torch.rsqrt``, must fail the same check (it differs in about a third of
the uniform values).
"""
import numpy as np
import pytest

from tests.torch_port_harness import run_port

N_PREFIX = 40
EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -1e-40, 1e-45, 1e-40, 1.1754942e-38,
                  1.1754944e-38, 3.4028235e38, 1e-5, 1.0, 4.0, 2.0 ** 126, 2.0 ** -126],
                 np.float32)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import jax

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-4, 10, 1_000_000).astype(np.float32),
                        np.arange(0, 2 ** 32, 4099, dtype=np.uint64).astype(np.uint32)
                        .view(np.float32)])
    rsqrt = jax.jit(jax.lax.rsqrt)
    jax_out = {"x": np.asarray(rsqrt(x)), "edges": np.asarray(rsqrt(EDGES))}
    port = run_port("xla_rsqrt", {"x": x, "edges": EDGES, "n_prefix": np.array(N_PREFIX)},
                    str(tmp_path_factory.mktemp("xla_rsqrt")))
    return x, jax_out, port


def _bit_equal(got, ref):
    nan = np.isnan(ref)
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), nan)
    differ = int((got[~nan].view(np.uint32) != ref[~nan].view(np.uint32)).sum())
    assert differ == 0, f"{differ} of {ref.size} values differ"


@pytest.mark.parametrize("which", ("x", "edges"))
def test_port_rsqrt_is_bit_equal_to_xla(case, which):
    _, jax_out, port = case
    _bit_equal(port[f"port/{which}"], jax_out[which])


def test_vector_loop_and_tail_agree(case):
    x, jax_out, port = case
    want = np.concatenate([jax_out["x"][:n] for n in range(1, N_PREFIX + 1)])
    _bit_equal(port["prefixes"], want)


def test_control_torch_rsqrt_fails(case):
    """``torch.rsqrt`` rounds otherwise: the check above must refuse it."""
    x, jax_out, port = case
    assert 1e6 <= x.size
    with pytest.raises(AssertionError):
        _bit_equal(port["torch/x"], jax_out["x"])


def test_rsqrt_takes_only_cpu_f32(case):
    """Below f32 the layer norm computes its statistics in f32 first; any
    other dtype is refused, not computed otherwise."""
    _, _, port = case
    assert bool(port["refuses_bf16"])
