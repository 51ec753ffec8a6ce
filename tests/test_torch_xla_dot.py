"""The port's products in XLA's CPU order against ``jax.lax.dot``.

Below f32 on CPU tensors the port computes the bf16 training path's
products (``modules/rounding.py``: ``matmul``, used by the dense layers and
the attention) in the order XLA's CPU dot sums their f32 terms, so that a
bf16 step rounds as JAX's does (``tests/test_torch_bf16_train.py`` holds the
loop to JAX's).  Here each product of the tests' SimpleTransformer and
JukeBox steps, in the orientation XLA's compiled step gives it (forward,
the input's cotangent with the weights read transposed, the weights'
cotangent, the attention's batched products and the key's cotangent with
its left operand read transposed), runs through ``jax.lax.dot_general`` in
f32 with XLA's excess precision off and through ``rounding.matmul`` on the
same bf16-valued operands from a numpy seed: bit-equal, every element.  The
port runs in a subprocess (``torch_port_worker.py xla_dot``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_port_harness import ROOT, run_port

# (batch, m, k, n, how): how "N" a @ b, "RT" a @ b with b stored transposed
# (the input's cotangent: the output's cotangent by the weights), "LT" a @ b
# with a stored transposed (the attention key's cotangent)
CASES = {
    "tf_fwd_qkv": ((), 256, 32, 32, "N"), "tf_fwd_ffn1": ((), 256, 32, 64, "N"),
    "tf_fwd_ffn2": ((), 256, 64, 32, "N"), "tf_fwd_head0": ((), 256, 32, 16, "N"),
    "tf_fwd_head1": ((), 256, 16, 33, "N"), "tf_dw_qkv": ((), 32, 256, 32, "N"),
    "tf_dw_ffn1": ((), 64, 256, 32, "N"), "tf_dw_ffn2": ((), 32, 256, 64, "N"),
    "tf_dw_head0": ((), 16, 256, 32, "N"), "tf_dw_head1": ((), 33, 256, 16, "N"),
    "tf_dx_ffn1": ((), 256, 64, 32, "RT"), "tf_dx_head1": ((), 256, 33, 16, "RT"),
    "tf_scores": ((4, 4), 64, 8, 64, "N"), "tf_mix_t": ((4, 4), 8, 64, 64, "N"),
    "tf_dkey": ((4, 4), 64, 64, 8, "LT"), "tf_dquery": ((4, 4), 64, 64, 8, "N"),
    "jb_fwd_tier0": ((), 32, 32, 32, "N"), "jb_fwd_tier1": ((), 64, 32, 32, "N"),
    "jb_fwd_up1": ((), 64, 32, 128, "N"), "jb_dw_up1": ((), 128, 64, 32, "N"),
    "jb_dw_tier0": ((), 64, 32, 32, "N"), "jb_dx_tier1": ((), 64, 64, 32, "RT"),
    "jb_dw_frame": ((), 32, 32, 8, "N"), "jb_dw_bottom": ((), 32, 256, 2, "N"),
    "jb_scores1": ((4, 4), 16, 8, 16, "N"), "jb_dkey0": ((4, 4), 8, 8, 8, "LT"),
}


def _operands(seed):
    import ml_dtypes

    rng = np.random.default_rng(seed)
    out = {}
    for i, (key, (batch, m, k, n, how)) in enumerate(CASES.items()):
        draw = lambda *s: rng.standard_normal(s).astype(ml_dtypes.bfloat16).astype(np.float32)  # noqa
        out[key + "/a"], out[key + "/b"] = draw(*batch, m, k), draw(*batch, k, n)
        out[key + "/lhs_t"] = np.array(how == "LT")
    return out


def _jax_side(path):
    """JAX's product of each case, its operands stored as XLA reads them."""
    import jax

    inp = _operands(0)
    for key, (batch, m, k, n, how) in CASES.items():
        a, b = inp[key + "/a"], inp[key + "/b"]
        nb = len(batch)
        bd = (tuple(range(nb)), tuple(range(nb)))
        if how == "LT":
            dims = (((nb,), (nb,)), bd)
            a = np.swapaxes(a, -1, -2).copy()
        elif how == "RT":
            dims = (((nb + 1,), (nb + 1,)), bd)
            b = np.swapaxes(b, -1, -2).copy()
        else:
            dims = (((nb + 1,), (nb,)), bd)
        f = jax.jit(lambda x, y, dims=dims: jax.lax.dot_general(x, y, dims))
        inp[key + "/jax"] = np.asarray(f(a, b))
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("xla_dot"))
    path = os.path.join(tmp, "jax.npz")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    res = subprocess.run([sys.executable, os.path.abspath(__file__), path], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(path, allow_pickle=False) as f:
        inp = dict(f)
    port_in = {k: v for k, v in inp.items() if not k.endswith("/jax")}
    return inp, run_port("xla_dot", port_in, tmp)


@pytest.mark.parametrize("key", CASES)
def test_product_equals_jax_lax_dot(case, key):
    inp, port = case
    got, want = port[key], inp[key + "/jax"]
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{(got != want).mean():.2%} of the elements differ"


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_side(sys.argv[1])
