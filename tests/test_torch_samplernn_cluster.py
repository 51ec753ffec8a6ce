"""The cluster kernel of the port's SampleRNN chunked decode
(``csrc/samplernn_cluster.cu``): its plan, the relaid weights it reads,
and the route that sends batches to it, on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain twin by teacher forcing); what it reads is built here, in Python:

* the plan (``ops.samplernn_decode.cluster_plan``) at SampleRNN-3's widths
  (``chip_smoke.py``'s ``FULL``) and at a narrower net, clusters of 8 and 16
  blocks, f32 and bf16 weights: every output column of every product is
  computed by exactly one block (the learned-temperature logit by every
  block, beside its share of the Q logits); a block's gates are the four
  gates of its hidden units and its up-sampler columns its units' columns of
  every cache row; the head's slices are resident (inside the once-a-launch
  load) and the tiers' slices stream; every run, piece and piece offset is a
  multiple of 16 bytes; a block's shared memory is within 232,448 bytes for
  every group size up to the largest, with at least two ring slots; a net
  narrower than 8 units a block is refused;
* the relaid weights (``cluster_layout``) hold each block's slice of each
  product and its bias where the plan says, equal to the pack's
  (``samplernn_weight_pack``), and the bottom's framed dense whole;
* ``decode_chunk``'s route, one table for each weight dtype: B up to
  ``K2_CLUSTER_ROUTE``'s limit for the pack's dtype to the cluster kernel,
  wider batches to the block kernel, whatever the chunk's
  length (the launchers replaced by recorders, the tensors on the meta
  device), and every chunk of a SampleRNN stream (run on the CPU through the
  plain twin) routes to one kernel;
* ``decode_single``'s route (K1, every B = 1 … 63 that ``SampleRNN.generate``
  sends it): the same table, reckoned from ``cluster_plan`` and
  ``max_streams`` (``cluster_size_for``), and ``cl=0`` / 8 / 16 forcing the
  block kernel or the cluster kernel at that size.

The port runs in one subprocess for the module (``torch_port_worker.py
samplernn_cluster``).
"""
import json

import numpy as np
import pytest

from tests.torch_port_harness import run_port

NETS = {
    "full": dict(frame_sizes=(16, 8, 8), hidden_dim=256, q_levels=256, mlp_dim=256),
    "mid": dict(frame_sizes=(8, 4, 2), hidden_dim=128, q_levels=64, mlp_dim=128),
    "small": dict(frame_sizes=(8, 4, 2), hidden_dim=32, q_levels=32, mlp_dim=32),
}
SIZES = (8, 16)
DTYPES = ("f32", "bf16")
CASES = [(n, d, cl) for n in ("full", "mid") for d in DTYPES for cl in SIZES]
SMEM_PER_BLOCK = 232_448


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    inp = {f"net_{k}/spec": np.array(json.dumps(v)) for k, v in NETS.items()}
    return run_port("samplernn_cluster", inp, str(tmp_path_factory.mktemp("port_src")))


def _q(net, dt, cl):
    return f"net_{net}/{dt}/cl{cl}/"


def test_the_worker_knows_the_cluster_sizes(port):
    assert tuple(port["sizes"].tolist()) == SIZES


@pytest.mark.parametrize("net,dt,cl", CASES)
def test_plan_fits_every_group_in_a_block(port, net, dt, cl):
    q = _q(net, dt, cl)
    assert int(port[q + "max_streams"]) >= 18
    assert np.all(port[q + "smem"] <= SMEM_PER_BLOCK), port[q + "smem"]
    assert np.all(port[q + "slots"] >= 2)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("cl", SIZES)
def test_a_net_too_narrow_for_the_cluster_is_refused(port, dt, cl):
    assert int(port[_q("small", dt, cl) + "max_streams"]) == 0


@pytest.mark.parametrize("net,dt,cl", CASES)
def test_every_output_column_is_computed_by_exactly_one_block(port, net, dt, cl):
    q = _q(net, dt, cl)
    spec = NETS[net]
    Q = spec["q_levels"]
    for name in port[q + "units"]:
        cols, N = port[f"{q}cols/{name}"], int(port[f"{q}N/{name}"])
        if name == f"wh{len([n for n in port[q + 'units'] if n.startswith('wh')]) - 1}":
            # the last head layer: each block its Q / cl logits, then the temperature's
            own = cols[:, : Q // cl]
            assert sorted(own.ravel().tolist()) == list(range(Q)), name
            assert np.all(cols[:, Q // cl] == Q) and np.all(cols[:, Q // cl + 1 :] == -1)
        else:
            assert sorted(cols.ravel().tolist()) == list(range(N)), name


@pytest.mark.parametrize("net,dt,cl", CASES)
def test_a_block_owns_its_units_gates_and_cache_columns(port, net, dt, cl):
    q = _q(net, dt, cl)
    H = NETS[net]["hidden_dim"]
    Hb = H // cl
    for name in port[q + "units"]:
        cols = port[f"{q}cols/{name}"]
        if name.startswith("wx") or name.startswith("wup"):
            for r in range(cl):
                units = np.asarray(cols[r]) % H
                assert set(units.tolist()) == set(range(r * Hb, (r + 1) * Hb)), (name, r)


@pytest.mark.parametrize("net,dt,cl", CASES)
def test_resident_and_streamed_slices_hold_the_weights_a_step_reads(port, net, dt, cl):
    q = _q(net, dt, cl)
    n_tiers = len(NETS[net]["frame_sizes"]) - 1
    units = port[q + "units"].tolist()
    assert units == [f"{k}{i}" for i in range(n_tiers) for k in ("wx", "wup")] + \
        [f"wh{k}" for k in range(len(units) - 2 * n_tiers)]
    assert port[q + "resident_units"].tolist() == [u for u in units if u.startswith("wh")]
    assert bool(port[q + "resident_in_load"])
    for name in units:
        assert bool(port[f"{q}equal/{name}"]), name
    assert bool(port[q + "wbot_equal"])


@pytest.mark.parametrize("net,dt,cl", CASES)
def test_every_run_and_piece_is_16_byte_aligned(port, net, dt, cl):
    q = _q(net, dt, cl)
    assert np.all(port[q + "offsets_bytes"] % 16 == 0)
    assert port[q + "piece_bytes"].size and np.all(port[q + "piece_bytes"] % 16 == 0)


def _routed(route, B):
    """The kernel K2_CLUSTER_ROUTE names for B: the first entry admitting B."""
    for most, cl in route:
        if B <= most:
            return f"cluster{cl}" if cl else "block"
    return "block"


def test_each_weight_dtype_has_its_route(port):
    routes = {k.split("/")[1]: port[k].tolist() for k in port if k.startswith("route/")}
    assert set(routes) == {"float32", "bfloat16"}
    for route in routes.values():
        assert route and [most for most, _ in route] == sorted(most for most, _ in route)
        assert {cl for _, cl in route} <= set(SIZES) | {0}


@pytest.mark.parametrize("net", ("full", "mid"))
def test_route_is_chosen_by_b(port, net):
    """On each pack, B takes the kernel its dtype's route names."""
    for dt, name in (("f32", "float32"), ("bf16", "bfloat16")):
        route = port[f"route/{name}"].tolist()
        keys = [k for k in port if k.startswith(f"net_{net}/{dt}/route_b")]
        assert {int(k.rsplit("_b", 1)[1]) for k in keys} >= {1, 256, route[-1][0] + 1}
        for key in keys:
            B = int(key.rsplit("_b", 1)[1])
            taken = port[key].tolist()
            assert len(taken) == 3 and set(taken) == {_routed(route, B)}, (dt, B, taken)


def test_a_net_outside_the_plan_takes_the_block_kernel(port):
    keys = [k for k in port if k.startswith("net_small/") and "/route_b" in k]
    assert {k.split("/")[1] for k in keys} == set(DTYPES)
    for key in keys:
        assert set(port[key].tolist()) == {"block"}, key


@pytest.mark.parametrize("B", (2, 64))
def test_every_chunk_of_a_stream_takes_one_kernel(port, B):
    taken = port[f"net_mid/stream_route_b{B}"].tolist()
    assert len(taken) >= 3 and len(set(taken)) == 1, taken


@pytest.mark.parametrize("net", ("full", "mid", "small"))
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_single_takes_the_route_below_64(port, net, dt):
    """K1's one-launch decode takes the kernel the pack dtype's route names
    at every B that ``generate`` sends it, as ``cluster_size_for`` reckons
    it from the plan (a net outside the plan: the block kernel)."""
    name = {"f32": "float32", "bf16": "bfloat16"}[dt]
    route = port[f"route/{name}"].tolist()
    taken = port[f"net_{net}/{dt}/single_route"].tolist()
    sizes = port[f"net_{net}/{dt}/cluster_size_for"].tolist()
    assert len(taken) == len(sizes) == 63
    fits = {cl: int(port[_q(net, dt, cl) + "max_streams"]) > 0 for cl in SIZES}
    for B, (got, cl) in enumerate(zip(taken, sizes), start=1):
        assert got == (f"cluster{cl}" if cl else "block"), (B, got, cl)
        want = _routed(route, B)
        if want != "block" and not fits[int(want[len("cluster"):])]:
            want = "block"
        assert got == want, (B, got, want)
    if net != "small":
        assert set(taken) != {"block"}


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_single_cl_forces_the_kernel(port, dt):
    assert port[f"net_full/{dt}/single_forced"].tolist() == ["block", "cluster8", "cluster16"]
