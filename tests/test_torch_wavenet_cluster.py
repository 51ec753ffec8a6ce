"""The cluster kernel of the port's WaveNet decode (``csrc/wavenet_cluster.cu``):
its plan, the relaid weights it reads, and the route that sends batches to
it, on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain twin by teacher forcing); what it reads is built here, in Python:

* the plan (``ops.wavenet_decode.cluster_plan``) at WaveNet-10's widths
  (``chip_smoke.py``'s ``WN_FULL``), at ``WN_SMALL``'s and at two nets
  between them (one of two blocks of dilations), clusters of 16 blocks (the
  kernel's one instantiation): every output column of every product is computed by exactly one
  block (the learned-temperature logit by every block, beside its share of
  the Q logits; the last layer's residual columns by none: its x is not
  used); a block's conv columns are the tanh and sigmoid columns of its own
  gate units, two units a quad; a block's shared memory is within 232,448
  bytes for every group size up to the largest, and is the sum of the
  activations, the resident region and the ring; the exchanges a step are
  22 at WaveNet-10;
* the relaid weights (``cluster_layout``) hold each block's slice of each
  product, and its bias, where the table says (resident, or piece by piece
  in the ring's order), equal to the pack's (``wavenet_weight_pack``), every
  run and piece at a multiple of 16 bytes;
* the route of ``decode_single`` and ``decode_chunk``: B up to
  ``WN_CLUSTER_ROUTE``'s limit to the cluster kernel at the size it names,
  wider batches to the block kernel, whatever the chunk's length (the
  launchers replaced by recorders, the tensors on the meta device), and a
  net outside the plan (a width that is not a multiple of 8) to the block
  kernel, whose gate still admits it.

The port runs in one subprocess for the module (``torch_port_worker.py
wavenet_cluster``).
"""
import json

import numpy as np
import pytest

from tests.torch_port_harness import run_port

NETS = {
    "full": dict(blocks=(10,), dim=128, q_levels=256, mlp_dim=128),
    "small": dict(blocks=(3,), dim=16, q_levels=32, mlp_dim=16),
    "mid": dict(blocks=(6,), dim=64, q_levels=128, mlp_dim=64),
    "two_blocks": dict(blocks=(4, 4), dim=32, q_levels=64, mlp_dim=32),
    "outside": dict(blocks=(3,), dim=12, q_levels=32, mlp_dim=16),
}
SIZES = (16,)
PLANNED = ("full", "small", "mid", "two_blocks")
CASES = [(n, cl) for n in PLANNED for cl in SIZES]
BATCHES = (1, 8, 32, 64, 65, 128, 129, 256)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    inp = {f"net_{k}/spec": np.array(json.dumps(v)) for k, v in NETS.items()}
    return run_port("wavenet_cluster", inp, str(tmp_path_factory.mktemp("port_src")))


def _q(net, cl):
    return f"net_{net}/cl{cl}/"


def _rows(cols):
    """Each rank's columns (the worker pads ragged ranks with -2)."""
    return [[c for c in row if c != -2] for row in np.asarray(cols).tolist()]


def test_the_worker_knows_the_cluster_sizes(port):
    assert tuple(port["sizes"].tolist()) == SIZES


@pytest.mark.parametrize("net,cl", CASES)
def test_plan_fits_every_group_in_a_block(port, net, cl):
    q = _q(net, cl)
    assert int(port[q + "max_streams"]) >= 37
    assert np.all(port[q + "smem"] <= int(port["smem_per_block"])), port[q + "smem"]
    assert np.array_equal(port[q + "smem"], port[q + "smem_sum"])


@pytest.mark.parametrize("net,cl", CASES)
def test_every_output_column_is_computed_by_exactly_one_block(port, net, cl):
    q = _q(net, cl)
    spec = NETS[net]
    D, Q = spec["dim"], spec["q_levels"]
    units = port[q + "units"].tolist()
    last_head = [u for u in units if u.startswith("h")][-1]
    has_res = port[f"net_{net}/has_res"].tolist()
    for name in units:
        rows, N = _rows(port[f"{q}cols/{name}"]), int(port[f"{q}N/{name}"])
        if name == last_head:
            assert sorted(c for row in rows for c in row[:-4]) == list(range(Q)), name
            assert all(row[-4:] == [Q, -1, -1, -1] for row in rows)
        elif name == f"sr{len(has_res) - 1}":
            assert sorted(c for row in rows for c in row) == list(range(D)), name  # skips only
        else:
            assert sorted(c for row in rows for c in row) == list(range(N)), name


@pytest.mark.parametrize("net,cl", CASES)
def test_a_block_owns_the_tanh_and_sigmoid_columns_of_its_gate_units(port, net, cl):
    q = _q(net, cl)
    D = NETS[net]["dim"]
    for name in [u for u in port[q + "units"].tolist() if u.startswith("conv")]:
        for row in _rows(port[f"{q}cols/{name}"]):
            for quad in np.asarray(row, np.int64).reshape(-1, 4):
                u0 = quad[0]
                assert u0 % 2 == 0 and quad.tolist() == [u0, D + u0, u0 + 1, D + u0 + 1]


@pytest.mark.parametrize("net,cl", CASES)
def test_relaid_slices_and_biases_equal_the_pack(port, net, cl):
    q = _q(net, cl)
    assert port[q + "equal"].all(), port[q + "units"][~port[q + "equal"]]
    assert np.all(port[q + "aligned"] % 16 == 0)
    # the resident region (biases and resident slices) is one bulk load a block
    assert np.all(port[q + "load_floats"] <= int(port[q + "wreg_floats"]))


def test_wavenet_10_streams_some_slices_and_keeps_some_resident_for_one_stream(port):
    for cl in SIZES:
        q = _q("full", cl)
        assert np.all(port[q + "resident_bytes"] > 0) and np.all(port[q + "streamed_bytes"] > 0)


def test_exchanges_a_step(port):
    assert int(port["net_full/exchanges"]) == 22


def _routed(route, B):
    for most, cl in route:
        if B <= most:
            return f"cluster{cl}"
    return "block"


@pytest.mark.parametrize("net", PLANNED)
def test_route_is_chosen_by_b(port, net):
    """Both wrappers, every chunk: B takes the kernel the route names."""
    route = port["route"].tolist()
    assert route and [m for m, _ in route] == sorted(m for m, _ in route)
    assert {cl for _, cl in route} <= set(SIZES)
    for B in BATCHES:
        taken = port[f"net_{net}/route_b{B}"].tolist()
        assert len(taken) == 4 and set(taken) == {_routed(route, B)}, (B, taken)
        want = _routed(route, B)
        assert int(port[f"net_{net}/route_fn_b{B}"]) == (0 if want == "block" else int(want[7:]))


def test_a_net_outside_the_plan_takes_the_block_kernel(port):
    assert bool(port["net_outside/gate"])
    for cl in SIZES:
        assert int(port[_q("outside", cl) + "max_streams"]) == 0
        assert "multiples" in str(port[_q("outside", cl) + "why"])
    for B in BATCHES:
        assert set(port[f"net_outside/route_b{B}"].tolist()) == {"block"}
