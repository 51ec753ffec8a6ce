"""The port's fused LSTM layer (``ops/fused_lstm.py``) against the JAX
package's Pallas layer, on the CPU.

On CPU tensors the layer runs its plain versions (``lstm_forward_plain``,
``lstm_backward_plain``), the arithmetic the CUDA kernels are checked
against on the card.  Here they are held to
``mimikit_tpu.ops.pallas_lstm.fused_lstm_layer(interpret=True)``, as
``tests/test_pallas_lstm.py`` runs it:

* outputs h_all, h_T, c_T, and all six gradients through ``jax.vjp`` with
  random cotangents on the three outputs, and with a cotangent on h_all only
  (the others arrive as None in torch and are materialised as zeros);
* at the three (T, B, H) cases of ``test_pallas_lstm.py:48`` and at T = 67,
  whose Pallas grid runs 67 blocks of one step (``_pick_tc``);
* ``lstm_backward_plain``, written out as the Pallas backward is, against
  torch autograd through ``lstm_forward_plain``.

Tolerances: f32 on both sides, summed in another order by XLA and by torch:
outputs ``rtol=1e-5, atol=1e-6``, gradients ``rtol=1e-4, atol=1e-5``; the
written-out backward against autograd (same framework) ``rtol=1e-5,
atol=1e-6``.

JAX runs in this process, the port in one subprocess for the module
(``torch_port_worker.py fused_lstm``).  The kernel-against-plain check is
marked ``cuda`` and skips without a card.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_port_harness import ROOT, run_port

CASES = {"t12b4h16": (12, 4, 16), "t7b2h8": (7, 2, 8), "t32b8h16": (32, 8, 16),
         "t67b3h8": (67, 3, 8)}
D = 8
GRADS = ("dx", "dWi", "dWh", "db", "dh0", "dc0")


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(x=f(T, B, D), Wi=f(D, 4 * H, sc=D ** -0.5), Wh=f(H, 4 * H, sc=H ** -0.5),
                b=f(4 * H, sc=0.1), h0=f(B, H, sc=0.3), c0=f(B, H, sc=0.3),
                dh_all=f(T, B, H), dh_T=f(B, H), dc_T=f(B, H))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimikit_tpu.ops.pallas_lstm import _pick_tc, fused_lstm_layer

    assert _pick_tc(67, 3, 8) == 1  # the T=67 case runs a grid of 67 blocks
    inp, jx = {}, {}
    for i, (tag, (T, B, H)) in enumerate(CASES.items()):
        d = _inputs(T, B, H, seed=i)
        inp.update({f"{tag}/{k}": v for k, v in d.items()})
        args = tuple(jnp.asarray(d[k]) for k in ("x", "Wi", "Wh", "b", "h0", "c0"))
        out, vjp = jax.vjp(lambda *a: fused_lstm_layer(*a, interpret=True), *args)
        for n, v in zip(("h_all", "h_T", "c_T"), out):
            jx[f"{tag}/{n}"] = np.asarray(v)
        cts = tuple(jnp.asarray(d[k]) for k in ("dh_all", "dh_T", "dc_T"))
        for n, g in zip(GRADS, vjp(cts)):
            jx[f"{tag}/grad_{n}"] = np.asarray(g)
        only_h = (cts[0], jnp.zeros_like(cts[1]), jnp.zeros_like(cts[2]))
        for n, g in zip(GRADS, vjp(only_h)):
            jx[f"{tag}/grad_h_only_{n}"] = np.asarray(g)
    port = run_port("fused_lstm", inp, str(tmp_path_factory.mktemp("port_lstm")))
    return jx, port


@pytest.mark.parametrize("tag", CASES)
def test_outputs_match_pallas_interpret(case, tag):
    jx, port = case
    for n in ("h_all", "h_T", "c_T"):
        np.testing.assert_allclose(port[f"{tag}/{n}"], jx[f"{tag}/{n}"], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("tag", CASES)
def test_six_gradients_match_pallas_vjp(case, tag):
    jx, port = case
    for n in GRADS:
        k = f"{tag}/grad_{n}"
        assert port[k].shape == jx[k].shape
        np.testing.assert_allclose(port[k], jx[k], rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("tag", CASES)
def test_unused_outputs_get_zero_cotangents(case, tag):
    jx, port = case
    for n in GRADS:
        k = f"{tag}/grad_h_only_{n}"
        np.testing.assert_allclose(port[k], jx[k], rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("tag", CASES)
def test_written_backward_matches_autograd_of_plain_forward(case, tag):
    _, port = case
    for n in ("dxi", "dWh", "dh0", "dc0"):
        np.testing.assert_allclose(port[f"{tag}/written_{n}"], port[f"{tag}/autograd_{n}"],
                                   rtol=1e-5, atol=1e-6, err_msg=n)


_CARD_CHECK = """
import torch
from mimikit_tpu_torch.ops import fused_lstm as fl
g = torch.Generator().manual_seed(0)
for T, B, D, H in ((12, 4, 8, 16), (7, 3, 8, 32), (67, 3, 8, 8)):
    mk = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).cuda()
    x, Wi, Wh, b = mk(T, B, D), mk(D, 4 * H, sc=D ** -0.5), mk(H, 4 * H, sc=H ** -0.5), mk(4 * H)
    h0, c0, cts = mk(B, H), mk(B, H), (mk(T, B, H), mk(B, H), mk(B, H))
    xi = torch.addmm(b, x.reshape(T * B, D), Wi).reshape(T, B, -1)
    k = fl.lstm_forward(xi, Wh, h0, c0)
    p = fl.lstm_forward_plain(xi, Wh, h0, c0)
    kb = fl.lstm_backward(*cts, p[2], p[1], p[0], h0, c0, Wh)
    pb = fl.lstm_backward_plain(*cts, p[2], p[1], p[0], h0, c0, Wh)
    torch.cuda.synchronize()
    for a, r in zip((*k, *kb), (*p, *pb)):
        assert float((a - r).abs().max()) <= 1e-5 + 1e-4 * float(r.abs().max())
assert fl.lstm_forward.launches == 3 and fl.lstm_backward.launches == 3
print("ok")
"""


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    env = dict(os.environ, PYTHONPATH=ROOT)
    probe = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
                           capture_output=True, text=True, env=env)
    if probe.stdout.strip() != "True":
        pytest.skip("needs a CUDA device and nvcc (run on the card: python3 chip_smoke.py)")
    res = subprocess.run([sys.executable, "-c", _CARD_CHECK], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
