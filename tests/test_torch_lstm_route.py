"""The LSTM layer's three routes (``ops/fused_lstm.lstm_route``), on the CPU.

``LSTM.forward_seq`` asks ``lstm_route(B, T, H, dtype)`` for each layer, in
the order of the JAX package's gate (``mimikit_tpu/modules/rnn.py:99-128``):

* ``"cluster"`` where both cluster plans take the layer (SampleRNN-3's tier
  shapes), ``"wide"`` where the wide kernels' plan does (H a multiple of 128
  up to 1,024, any B and T: f32 H = 512 and 1,024, bf16 H = 768), ``"scan"``
  outside JAX's kernel gate (H not a multiple of 128, B < 8 or B*T < 64:
  H = 100, f32 H = 600), and a ``ValueError`` naming both plans' reasons
  otherwise (H = 1,152 at B = 32);
* the wide kernels' shared-memory sizes are the source's: ``wide_smem`` of
  ``csrc/fused_lstm.cu``, cut out of the source and built with the host's C++
  compiler, against ``_wide_smem``;
* the "scan" route (a step loop of ``lstm_step`` under autograd, no fused
  layer) against JAX's ``RNNStack``, which runs its ``lax.scan`` on the CPU,
  at (B, T, H) = (4, 16, 100), two layers: outputs, final carries and the
  gradients of every parameter, of x and of the initial carry, f32, within
  1e-5;
* the "wide" route at (T, B, H) = (4, 8, 512) (on the CPU the kernels' plain
  versions) against JAX's ``fused_lstm_layer(..., interpret=True)``, as
  ``tests/test_pallas_lstm.py:56`` runs it: outputs and gradients within
  1e-5;
* a weight-normed layer (flax's ``nn.WeightNorm`` around the cell, the
  demo recipe's LSTM) at (B, T, H) = (8, 16, 16): the port takes the
  "cluster" route on the effective weights (on the CPU the fused layer's
  plain versions), JAX its ``lax.scan`` (its gate refuses weight-normed
  stacks); outputs, final carries and the gradients of x, the carry, the
  bias and each ``_g`` and ``_v`` against JAX's scale and kernel gradients,
  with random scales, within 1e-5;
* past the wide kernels' limit inside JAX's gate, (T, B, H) = (8, 8, 1152),
  where the card's route raises, the CPU runs the fused layer's plain
  versions ("plain"): its outputs against the module's own step loop within
  1e-5, its gradients finite.

* an LSTM whose input width differs from its hidden width (the seq2seq
  encoder's first layer reads STFT bins) seeding a second LSTM with its final
  carry, on each route: "scan" (B, T, H) = (4, 16, 100), "cluster" (8, 8,
  16), "wide" (8, 4, 512) and "plain" (8, 8, 1152), the first layer's input
  width D = 24, 40, 72 and 40: both layers' outputs and final carries, and
  the gradients of a loss on the second layer's outputs only, so every
  gradient of the first layer (its weights, x, its initial carry) reaches it
  through h_T and c_T, and the second layer's carry gradient is dh0/dc0 of
  a seeded layer; against two JAX ``RNNStack`` s chained the same way (their
  scans), within 1e-5 (rtol 1e-5, atol 1e-5 * max|JAX|).

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py lstm_route``).
"""
import os
import re
import subprocess

import numpy as np
import pytest

from tests.torch_port_harness import ROOT, run_port

ROUTES = [
    # SampleRNN-3's tier shapes (frames of 16 and 8 over 2,048 samples, B = 32)
    ((32, 128, 256, 4), "cluster"), ((32, 256, 256, 4), "cluster"),
    ((32, 128, 256, 2), "cluster"), ((32, 256, 256, 2), "cluster"),
    # past a cluster's shared memory, H a multiple of 128: the wide kernels
    ((32, 128, 512, 4), "wide"), ((32, 8, 512, 4), "wide"), ((32, 128, 1024, 4), "wide"),
    ((32, 128, 768, 2), "wide"), ((32, 64, 1024, 2), "wide"),
    # the wide kernels take any B and T, inside JAX's gate or not
    ((4, 8, 512, 4), "wide"), ((1, 1, 1024, 2), "wide"),
    # outside JAX's kernel gate and the cluster plans: the scan
    ((4, 16, 100, 4), "scan"), ((32, 128, 600, 4), "scan"), ((32, 128, 600, 2), "scan"),
]
RAISES = [(32, 128, 1152, 4), (32, 128, 1152, 2)]
WIDE_H = (128, 256, 384, 512, 640, 768, 896, 1024, 600, 1152)
SCAN = dict(B=4, T=16, H=100, layers=2)
WIDE = dict(B=8, T=4, H=512)
PAST = dict(B=8, T=8, H=1152)
WN = dict(B=8, T=16, H=16)
TOL = dict(rtol=1e-5, atol=1e-5)
# the chained pair: (B, T, H, D) on each route of the first layer
CHAIN = {"scan": (4, 16, 100, 24), "cluster": (8, 8, 16, 40), "wide": (8, 4, 512, 72),
         "plain": (8, 8, 1152, 40)}
CHAIN_NAMES = (["y_enc", "y_dec", "c_enc", "h_enc", "c_dec", "h_dec", "grad_x", "grad_x2",
                "grad_c0", "grad_h0"]
               + [f"grad_{w}_{m}" for m in ("enc", "dec") for w in ("w_ih", "w_hh", "b_hh")])


def _key(B, T, H, es):
    return f"route/b{B}_t{T}_h{H}_e{es}"


def _port_weights(p, L, H, D, rng):
    """Weights in the port's layout (w_ih (4H, D), w_hh (4H, H), b_hh (4H,))
    from flax params p["l{k}"], or random where p is None."""
    out = {}
    for k in range(L):
        if p is None:
            s = H ** -0.5
            out[f"w_ih{k}"] = (rng.standard_normal((4 * H, D)) * D ** -0.5).astype(np.float32)
            out[f"w_hh{k}"] = (rng.standard_normal((4 * H, H)) * s).astype(np.float32)
            out[f"b_hh{k}"] = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
            continue
        cell = p[f"l{k}"]
        out[f"w_ih{k}"] = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T for g in "ifgo"])
        out[f"w_hh{k}"] = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in "ifgo"])
        out[f"b_hh{k}"] = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"])
    return out


def _case_inputs(prefix, B, T, H, L, rng, weights):
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    d = {"x": f(B, T, H), "gy": f(B, T, H), "layers": np.array(L), **weights}
    for k in range(L):
        d.update({f"c0_{k}": f(B, H, sc=0.3), f"h0_{k}": f(B, H, sc=0.3),
                  f"gc_{k}": f(B, H), f"gh_{k}": f(B, H)})
    return {prefix + k: v for k, v in d.items()}


def _jax_scan(inp):
    """JAX's RNNStack (its lax.scan on the CPU) on the scan case: outputs,
    final carries and the gradients in the port's layout."""
    import jax
    import jax.numpy as jnp

    from mimikit_tpu.modules.rnn import RNNStack

    p, L, H = "scan/", SCAN["layers"], SCAN["H"]
    stack = RNNStack(hidden_dim=H, n_layers=L)
    assert not stack.bind({})._use_fused_lstm(SCAN["B"], SCAN["T"])  # JAX takes its scan
    x = jnp.asarray(inp[p + "x"])
    carry = tuple((jnp.asarray(inp[f"{p}c0_{k}"]), jnp.asarray(inp[f"{p}h0_{k}"]))
                  for k in range(L))
    params = stack.init(jax.random.PRNGKey(0), x, carry)["params"]

    def loss(params, x, carry):
        y, final = stack.apply({"params": params}, x, carry)
        v = (y * inp[p + "gy"]).sum()
        for k, (c, h) in enumerate(final):
            v = v + (c * inp[f"{p}gc_{k}"]).sum() + (h * inp[f"{p}gh_{k}"]).sum()
        return v, (y, final)

    (_, (y, final)), (gp, gx, gc) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, x, carry)
    out = {"y": np.asarray(y), "grad_x": np.asarray(gx)}
    for k in range(L):
        out[f"c_{k}"], out[f"h_{k}"] = np.asarray(final[k][0]), np.asarray(final[k][1])
        out[f"grad_c0_{k}"], out[f"grad_h0_{k}"] = np.asarray(gc[k][0]), np.asarray(gc[k][1])
    g = _port_weights(gp, L, H, H, None)
    for k in range(L):
        out[f"grad_weight_ih{k}"], out[f"grad_weight_hh{k}"] = g[f"w_ih{k}"], g[f"w_hh{k}"]
        out[f"grad_bias_hh{k}"] = g[f"b_hh{k}"]
    return params, out


def _wn_params(rng):
    """A weight-normed RNNStack's flax params (one layer of WN's width): its
    initialisation with the scales drawn from U(0.5, 1.5)."""
    import jax
    import jax.numpy as jnp

    from mimikit_tpu.modules.rnn import RNNStack

    B, T, H = WN["B"], WN["T"], WN["H"]
    zeros = jnp.zeros((B, H))
    params = jax.device_get(RNNStack(hidden_dim=H, n_layers=1, weight_norm=True).init(
        jax.random.PRNGKey(1), jnp.zeros((B, T, H)), ((zeros, zeros),))["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    scales = params["cells_0"]
    for key in scales:
        scales[key] = rng.uniform(0.5, 1.5, scales[key].shape).astype(np.float32)
    return params


def _wn_port_weights(params):
    """The weight-normed layer in the port's layout: ``w_ih_v0`` (4H, H) and
    ``g_ih0`` (4H,) (and the same for hh) from the kernels and scales."""
    out = _port_weights(params, 1, WN["H"], WN["H"], None)
    for p in "ih":
        out[f"w_{p}h_v0"] = out.pop(f"w_{p}h0")
        out[f"g_{p}h0"] = np.concatenate(
            [params["cells_0"][f"l0/{p}{g}/kernel/scale"] for g in "ifgo"])
    return out


def _jax_wn(inp, params):
    """JAX's weight-normed RNNStack (its scan) on the wn case: outputs, final
    carries and the gradients of the kernels and scales in the port's layout."""
    import jax
    import jax.numpy as jnp

    from mimikit_tpu.modules.rnn import RNNStack

    p = "wn/"
    stack = RNNStack(hidden_dim=WN["H"], n_layers=1, weight_norm=True)
    assert not stack.bind({})._use_fused_lstm(WN["B"], WN["T"])  # JAX takes its scan
    x = jnp.asarray(inp[p + "x"])
    carry = ((jnp.asarray(inp[p + "c0_0"]), jnp.asarray(inp[p + "h0_0"])),)

    def loss(params, x, carry):
        y, final = stack.apply({"params": params}, x, carry)
        (c, h), = final
        v = (y * inp[p + "gy"]).sum() + (c * inp[p + "gc_0"]).sum() + (h * inp[p + "gh_0"]).sum()
        return v, (y, final)

    (_, (y, final)), (gp, gx, gc) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, x, carry)
    gp = jax.tree_util.tree_map(np.asarray, jax.device_get(gp))
    g = _wn_port_weights(gp)
    out = {"y": np.asarray(y), "grad_x": np.asarray(gx), "c_0": np.asarray(final[0][0]),
           "h_0": np.asarray(final[0][1]), "grad_c0_0": np.asarray(gc[0][0]),
           "grad_h0_0": np.asarray(gc[0][1]), "grad_bias_hh0": g["b_hh0"]}
    for q in "ih":
        out[f"grad_weight_{q}h_g0"], out[f"grad_weight_{q}h_v0"] = g[f"g_{q}h0"], g[f"w_{q}h_v0"]
    return out


def _jax_wide(inp):
    """JAX's fused_lstm_layer in interpret mode on the wide case (one layer):
    outputs and gradients in the port's layout."""
    import jax
    import jax.numpy as jnp

    from mimikit_tpu.ops.pallas_lstm import fused_lstm_layer

    p = "wide/"
    args = (jnp.asarray(inp[p + "x"]).swapaxes(0, 1), jnp.asarray(inp[p + "w_ih0"].T),
            jnp.asarray(inp[p + "w_hh0"].T), jnp.asarray(inp[p + "b_hh0"]),
            jnp.asarray(inp[p + "h0_0"]), jnp.asarray(inp[p + "c0_0"]))
    (h_all, h_T, c_T), vjp = jax.vjp(lambda *a: fused_lstm_layer(*a, interpret=True), *args)
    dx, dWi, dWh, db, dh0, dc0 = vjp((jnp.asarray(inp[p + "gy"]).swapaxes(0, 1),
                                      jnp.asarray(inp[p + "gh_0"]), jnp.asarray(inp[p + "gc_0"])))
    return {"y": np.asarray(h_all).swapaxes(0, 1), "h_0": np.asarray(h_T), "c_0": np.asarray(c_T),
            "grad_x": np.asarray(dx).swapaxes(0, 1), "grad_weight_ih0": np.asarray(dWi).T,
            "grad_weight_hh0": np.asarray(dWh).T, "grad_bias_hh0": np.asarray(db),
            "grad_h0_0": np.asarray(dh0), "grad_c0_0": np.asarray(dc0)}


def _chain_inputs(tag, rng):
    """The chained pair's inputs: x (B, T, D), x2 (B, T, H), the first
    layer's non-zero carry, the cotangent of the second layer's outputs,
    random weights of both layers."""
    B, T, H, D = CHAIN[tag]
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    enc = {f"enc_{k[:-1]}": v for k, v in _port_weights(None, 1, H, D, rng).items()}
    dec = {f"dec_{k[:-1]}": v for k, v in _port_weights(None, 1, H, H, rng).items()}
    d = {"x": f(B, T, D), "x2": f(B, T, H, sc=0.5), "c0": f(B, H, sc=0.3), "h0": f(B, H, sc=0.3),
         "gy": f(B, T, H), **enc, **dec}
    return {f"chain/{tag}/{k}": v for k, v in d.items()}


def _jax_chain(inp, tag):
    """Two JAX RNNStacks chained (their scans): the first (input D) from the
    given carry, the second from the first's final carry; outputs, carries
    and the gradients of sum(y_dec * gy) in the port's layout."""
    import jax
    import jax.numpy as jnp

    from mimikit_tpu.modules.rnn import RNNStack

    p = f"chain/{tag}/"
    B, T, H, D = CHAIN[tag]
    enc, dec = RNNStack(hidden_dim=H, n_layers=1), RNNStack(hidden_dim=H, n_layers=1)

    def cell(m):
        g = lambda w: np.split(inp[f"{p}{m}_{w}"], 4)  # noqa: E731
        return {"l0": {**{f"i{q}": {"kernel": jnp.asarray(k.T)} for q, k in zip("ifgo", g("w_ih"))},
                       **{f"h{q}": {"kernel": jnp.asarray(k.T), "bias": jnp.asarray(b)}
                          for q, k, b in zip("ifgo", g("w_hh"), g("b_hh"))}}}

    def loss(pe, pd, x, x2, carry):
        y_e, fe = enc.apply({"params": pe}, x, carry)
        y_d, fd = dec.apply({"params": pd}, x2, fe)
        return (y_d * inp[p + "gy"]).sum(), (y_e, y_d, fe, fd)

    args = (cell("enc"), cell("dec"), jnp.asarray(inp[p + "x"]), jnp.asarray(inp[p + "x2"]),
            ((jnp.asarray(inp[p + "c0"]), jnp.asarray(inp[p + "h0"])),))
    (_, (y_e, y_d, fe, fd)), (ge, gd, gx, gx2, gc) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    out = {"y_enc": y_e, "y_dec": y_d, "c_enc": fe[0][0], "h_enc": fe[0][1], "c_dec": fd[0][0],
           "h_dec": fd[0][1], "grad_x": gx, "grad_x2": gx2, "grad_c0": gc[0][0],
           "grad_h0": gc[0][1]}
    for m, g, d_in in (("enc", ge, D), ("dec", gd, H)):
        w = _port_weights(jax.device_get(g), 1, H, d_in, None)
        out.update({f"grad_w_ih_{m}": w["w_ih0"], f"grad_w_hh_{m}": w["w_hh0"],
                    f"grad_b_hh_{m}": w["b_hh0"]})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimikit_tpu.modules.rnn import RNNStack

    rng = np.random.default_rng(16)
    # the scan case's weights are JAX's initialisation, handed to the port
    probe = RNNStack(hidden_dim=SCAN["H"], n_layers=SCAN["layers"])
    zeros = jnp.zeros((SCAN["B"], SCAN["H"]))
    params = probe.init(jax.random.PRNGKey(0), jnp.zeros((SCAN["B"], SCAN["T"], SCAN["H"])),
                        tuple((zeros, zeros) for _ in range(SCAN["layers"])))["params"]
    inp = {"route_cases": np.array([c for c, _ in ROUTES] + RAISES), "wide_h": np.array(WIDE_H)}
    inp.update(_case_inputs("scan/", SCAN["B"], SCAN["T"], SCAN["H"], SCAN["layers"], rng,
                            _port_weights(params, SCAN["layers"], SCAN["H"], SCAN["H"], None)))
    inp.update(_case_inputs("wide/", WIDE["B"], WIDE["T"], WIDE["H"], 1, rng,
                            _port_weights(None, 1, WIDE["H"], WIDE["H"], rng)))
    inp.update(_case_inputs("past/", PAST["B"], PAST["T"], PAST["H"], 1, rng,
                            _port_weights(None, 1, PAST["H"], PAST["H"], rng)))
    wn_params = _wn_params(rng)
    inp.update(_case_inputs("wn/", WN["B"], WN["T"], WN["H"], 1, rng, _wn_port_weights(wn_params)))
    for tag in CHAIN:
        inp.update(_chain_inputs(tag, rng))
    jx = {"scan": _jax_scan(inp)[1], "wide": _jax_wide(inp), "wn": _jax_wn(inp, wn_params)}
    jx.update({f"chain/{tag}": _jax_chain(inp, tag) for tag in CHAIN})
    port = run_port("lstm_route", inp, str(tmp_path_factory.mktemp("route")))
    return jx, port


@pytest.mark.parametrize("shape,route", ROUTES, ids=lambda v: str(v))
def test_route_table(case, shape, route):
    _, port = case
    assert str(port[_key(*shape)]) == route


@pytest.mark.parametrize("shape", RAISES, ids=str)
def test_route_raises_past_the_wide_limit(case, shape):
    _, port = case
    k = _key(*shape)
    assert k not in port
    msg = str(port[k + "_error"])
    # both plans' reasons: the cluster kernels' and the wide kernels'
    assert "no LSTM route" in msg and "kernel cannot run" in msg
    assert "the wide kernels: H=1152 is past the wide kernels' 1024" in msg


@pytest.mark.parametrize("H", WIDE_H)
def test_wide_plan(case, H):
    """128 blocks of H/128 units for H a multiple of 128 up to 1,024, within
    a block's shared memory; a ValueError otherwise."""
    _, port = case
    for es in (4, 2):
        k = f"wide/h{H}_e{es}"
        if H % 128 or H > 1024:
            assert k + "/plan" not in port and (k + "/error") in port
            continue
        assert port[k + "/plan"].tolist() == [128, H // 128]
        for bw in (0, 1):
            assert int(port[f"{k}_bw{bw}/smem"]) <= int(port["smem_limit"])


def _source_wide_smem(tmp_path):
    """{(H, es, backward): bytes} of the .cu's own ``wide_smem``, cut out of
    the source and built for the host."""
    src = open(os.path.join(ROOT, "mimikit_tpu_torch", "csrc", "fused_lstm.cu")).read()
    part = re.search(r"#define MMK_WIDE_BLOCKS.*?// -- end of the wide layout", src, re.S).group(0)
    grid = "".join(f"  show({H}, {es}, {bw});\n" for H in WIDE_H if H % 128 == 0 and H <= 1024
                   for es in (4, 2) for bw in (0, 1))
    code = ("#include <cstdio>\n#include <cstddef>\n#define __host__\n#define __device__\n"
            "#define MMK_LSTM_THREADS 256\n" + part + "\n"
            "static void show(int H, int es, int bw) {\n"
            '  std::printf("%d %d %d %zu\\n", H, es, bw, wide_smem(H, es, bw));\n}\n'
            "int main() {\n" + grid + "}\n")
    cpp, exe = tmp_path / "wide.cpp", tmp_path / "wide"
    cpp.write_text(code)
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(cpp)], check=True,
                   capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    return {tuple(v[:3]): v[3] for v in (list(map(int, ln.split())) for ln in out.splitlines())}


def test_wide_shared_memory_agrees_with_the_source(case, tmp_path):
    _, port = case
    src = _source_wide_smem(tmp_path)
    assert len(src) == 32
    for (H, es, bw), n in src.items():
        assert int(port[f"wide/h{H}_e{es}_bw{bw}/smem"]) == n, (H, es, bw)


def test_scan_route_runs_no_fused_layer(case):
    _, port = case
    assert str(port["scan/route"]) == "scan"
    assert int(port["scan/fused_calls"]) == 0


def test_wide_route_runs_the_fused_layer(case):
    """On the CPU the wide route is the fused layer's plain versions: no
    kernel launch."""
    _, port = case
    assert str(port["wide/route"]) == "wide"
    assert int(port["wide/fused_calls"]) == 1 and int(port["wide/launches"]) == 0


def _names(case_name, L):
    outs = ["y"] + [f"{n}_{k}" for k in range(L) for n in ("c", "h")]
    grads = ["grad_x"] + [f"grad_{n}{k}" for k in range(L)
                          for n in ("weight_ih", "weight_hh", "bias_hh")]
    grads += [f"grad_{n}_{k}" for k in range(L) for n in ("c0", "h0")]
    return [(case_name, n) for n in outs + grads]


@pytest.mark.parametrize("which,name", _names("scan", SCAN["layers"]), ids=lambda v: str(v))
def test_scan_route_matches_jax_scan(case, which, name):
    jx, port = case
    np.testing.assert_allclose(port[f"{which}/{name}"], jx[which][name], **TOL, err_msg=name)


@pytest.mark.parametrize("which,name", _names("wide", 1), ids=lambda v: str(v))
def test_wide_route_matches_pallas_interpret(case, which, name):
    jx, port = case
    np.testing.assert_allclose(port[f"{which}/{name}"], jx[which][name], **TOL, err_msg=name)


def test_weight_normed_layer_takes_the_fused_layer(case):
    """A weight-normed layer goes through lstm_route like a plain one: at
    the demo recipe's kind of shape the "cluster" route, one fused-layer
    call on the effective weights (on the CPU its plain versions)."""
    _, port = case
    assert str(port["wn/route"]) == "cluster"
    assert int(port["wn/fused_calls"]) == 1 and int(port["wn/launches"]) == 0


WN_NAMES = ["y", "c_0", "h_0", "grad_x", "grad_c0_0", "grad_h0_0", "grad_bias_hh0"] + [
    f"grad_weight_{p}h_{w}0" for p in "ih" for w in "gv"]


@pytest.mark.parametrize("name", WN_NAMES)
def test_weight_normed_layer_matches_jax(case, name):
    """Outputs and gradients of the weight-normed layer (``_g`` against JAX's
    scale, ``_v`` against its kernel) against JAX's scan."""
    jx, port = case
    np.testing.assert_allclose(port[f"wn/{name}"], jx["wn"][name], **TOL, err_msg=name)


def test_cpu_runs_the_plain_versions_past_the_wide_limit(case):
    """At H = 1,152 inside JAX's gate the card's route raises; on the CPU the
    module runs the fused layer's plain versions, as it does at every width."""
    _, port = case
    assert "past the wide kernels' 1024" in str(port["past/card_error"])
    assert str(port["past/route"]) == "plain"
    assert int(port["past/fused_calls"]) == 1 and int(port["past/launches"]) == 0
    for name in ("y", "h_0", "c_0"):
        np.testing.assert_allclose(port[f"past/{name}"], port[f"past/scan_{name}"], **TOL,
                                   err_msg=name)
    for name in ("grad_x", "grad_weight_ih0", "grad_weight_hh0", "grad_bias_hh0", "grad_c0_0",
                 "grad_h0_0"):
        assert np.isfinite(port[f"past/{name}"]).all(), name


@pytest.mark.parametrize("tag", list(CHAIN))
def test_chained_layers_take_their_routes(case, tag):
    """The first layer (input width D) and the second take the route of
    their (B, T, H): the width of the input plays no part."""
    _, port = case
    assert str(port[f"chain/{tag}/route_enc"]) == tag
    assert str(port[f"chain/{tag}/route_dec"]) == tag


@pytest.mark.parametrize("tag", list(CHAIN))
@pytest.mark.parametrize("name", CHAIN_NAMES)
def test_chained_carry_gradients_match_jax(case, tag, name):
    """The seeded carry on every route: the second layer's dh0/dc0 carry the
    whole gradient of the first layer, its weights, x and initial carry."""
    jx, port = case
    want = jx[f"chain/{tag}"][name]
    got = port[f"chain/{tag}/{name}"]
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)
