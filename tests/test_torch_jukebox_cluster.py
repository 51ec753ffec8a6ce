"""The cluster and group kernels of the port's JukeBox decode
(``csrc/jukebox_cluster.cu``, ``csrc/jukebox_group.cu``): their residency
plans, the relaid weights they read, and the route that sends streams to
them, on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against the plain twin by teacher forcing); what they read is built here, in
Python:

* the residency plan (``ops.jukebox_decode.cluster_plan``) at jukebox3's
  widths and at the tests' small ones, clusters of 8 and 16 blocks, and the
  group kernel's (``group_plan``) at clusters of 4, 8 and 16 blocks for
  groups of 1, 2 and the most streams that fit: every output column of
  every product is computed by exactly one block of each head group (the
  blocks that share their heads; one block at 8 blocks and 8 heads) and the
  attention rows of a head by exactly one block; the slices, one head
  group's, hold exactly the weights a step reads; resident plus streamed
  bytes are a block's slices, and the streamed pieces hold exactly the
  streamed ones; every offset is 16-byte aligned; a block's shared memory
  is within 232,448 bytes; a group's activations grow with its streams and
  one stream more than the most does not fit;
* the relaid weights (``cluster_layout``) hold each block's slice of each
  product (and its bias) where its table says, equal to the pack's;
* ``decode_pyramid``'s route: B <= 7 streams to clusters of 16 blocks,
  B <= 15 (``_K8_CLUSTER_MAX_B``) to clusters of 8 (``K8_CLUSTER_ROUTE``),
  wider batches up to ``K8_GROUP_ROUTE``'s limit to the group kernel, more
  to the block kernel, whatever the chunk's length (the launchers replaced
  by recorders, the window on the meta device); a net outside every plan
  (3 heads, which neither divide nor are divided by the cluster sizes) to
  the block kernel at every B; and every chunk of a JukeBox stream (run on
  the CPU through the plain twin) routes to one kernel.

The port runs in one subprocess for the module (``torch_port_worker.py
jukebox_cluster``).
"""
import json

import numpy as np
import pytest

from tests.torch_port_harness import run_port

# chip_smoke.py's JB_FULL (jukebox3, benchmarks/bench_decode.py:117-126) and JB_SMALL
NETS = {
    "jukebox3": dict(frame_sizes=(32, 16, 4), model_dim=128, n_heads=8, feedforward_dim=256,
                     num_layers=2, rf=128, q_levels=256, mlp_dim=128),
    "small": dict(frame_sizes=(8, 4, 2), model_dim=32, n_heads=4, feedforward_dim=64,
                  num_layers=2, rf=16, q_levels=32, mlp_dim=16),
    # inside the tier-pyramid gate, outside every cluster plan: 3 heads
    "outside": dict(frame_sizes=(8, 4, 2), model_dim=48, n_heads=3, feedforward_dim=96,
                    num_layers=2, rf=16, q_levels=32, mlp_dim=16),
}
PLANNED = ("jukebox3", "small")
SIZES = (8, 16)
GROUP_SIZES = (4, 8, 16)
CASES = [(n, cl) for n in PLANNED for cl in SIZES]
# the group kernel's plans: (net, cluster size, group of one, two or the most streams)
GROUPS = ("one", "two", "most")
GCASES = [(n, cl, g) for n in PLANNED for cl in GROUP_SIZES for g in GROUPS]
SMEM_PER_BLOCK = 232_448
TAB_HEADER = 4


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    inp = {f"net_{k}/spec": np.array(json.dumps(v)) for k, v in NETS.items()}
    inp["stream_net"] = np.array("small")
    return run_port("jukebox_cluster", inp, str(tmp_path_factory.mktemp("port_jbc")))


def _q(net, cl, group=None, port=None):
    """The worker's prefix of a plan: the cluster kernel's at ``cl``, or the
    group kernel's at ``cl`` and a group of one, two or the most streams."""
    if group is None:
        return f"net_{net}/cl{cl}/"
    S = {"one": 1, "two": 2, "most": int(port[f"net_{net}/g{cl}/max_streams"])}[group]
    return f"net_{net}/g{cl}s{S}/"


def _units(port, q):
    return [str(u) for u in port[q + "units"]]


def test_the_worker_knows_the_cluster_sizes(port):
    assert tuple(port["sizes"].tolist()) == SIZES
    assert tuple(port["group_sizes"].tolist()) == GROUP_SIZES


@pytest.mark.parametrize("net,cl", CASES)
def test_plan_fits_and_the_gate_admits(port, net, cl):
    assert bool(port[f"net_{net}/in_gate"])
    assert bool(port[f"net_{net}/cl{cl}/fits"])


@pytest.mark.parametrize("net", PLANNED)
@pytest.mark.parametrize("cl", GROUP_SIZES)
def test_the_group_grows_to_the_most_streams_that_fit(port, net, cl):
    """A group's activations grow with its streams, so the group kernel's
    plan fits up to a most (at least two at these widths) and not one
    stream more; the shared memory stays within a block's."""
    S_max = int(port[f"net_{net}/g{cl}/max_streams"])
    assert S_max >= 2
    act, smem = port[f"net_{net}/g{cl}/act_by_S"], port[f"net_{net}/g{cl}/smem_by_S"]
    assert len(act) == S_max + 1 and (np.diff(act) > 0).all()
    assert (smem[:S_max] <= SMEM_PER_BLOCK).all()
    for group in GROUPS:
        assert bool(port[_q(net, cl, group, port) + "fits"])


@pytest.mark.parametrize("net", PLANNED)
@pytest.mark.parametrize("cl", GROUP_SIZES)
def test_each_stream_adds_the_same_activations(port, net, cl):
    """A group's buffers hold each stream's rows alike: one stream more adds
    the same floats, whatever the group."""
    act = port[f"net_{net}/g{cl}/act_by_S"]
    assert len(set(np.diff(act).tolist())) == 1


HEAD_UNITS = ("qkv", "cq", "ckv")


def _slices(port, q, cl, name):
    """Each rank's pack columns of unit ``name`` in the plan at ``q``."""
    counts, cols = port[f"{q}cols_of/{name}"], port[f"{q}cols/{name}"]
    if cols[0] < 0:
        return [np.zeros(0, int)] * cl
    return np.split(cols, np.cumsum(counts)[:-1])


def _group(name, cl, rph, part):
    """The ranks that compute a unit's columns once between them: all of
    them, or for a head product the part-th block of every head group."""
    if name.split(".")[0] in HEAD_UNITS:
        return [r for r in range(cl) if r % rph == part]
    return list(range(cl))


def _columns_once(port, net, cl, q):
    spec = NETS[net]
    d, nH = spec["model_dim"], spec["n_heads"]
    heads = port[q + "heads"]  # (first head, heads, ranks a head, row part) of each rank
    rph = int(heads[0, 2])
    assert rph == max(1, cl // nH) and int(heads[0, 1]) == max(1, nH // cl)
    assert [int(h[3]) for h in heads] == [r % rph for r in range(cl)]
    for name in _units(port, q):
        per_rank = _slices(port, q, cl, name)
        assert all(len(c) % 4 == 0 for c in per_rank), name
        kind = name.split(".")[0]
        for part in range(rph):
            group = np.concatenate([per_rank[r] for r in _group(name, cl, rph, part)])
            assert len(np.unique(group)) == len(group), name
            if kind in HEAD_UNITS:  # q|k|v: 3d, the cross q: d, a layer's cross k|v: 2d
                assert len(group) == {"qkv": 3 * d, "cq": d, "ckv": 2 * d}[kind], name
        if kind in HEAD_UNITS:
            for r in range(cl):
                assert np.array_equal(per_rank[r], per_rank[r - r % rph]), name


def _step_weights(port, net, cl, q):
    rph = int(port[q + "heads"][0, 2])
    total = 0
    for name, K in zip(_units(port, q), port[q + "unit_K"]):
        per_rank = _slices(port, q, cl, name)
        total += int(K) * sum(len(per_rank[r]) for r in _group(name, cl, rph, 0))
    assert total == int(port[f"net_{net}/step_weights"])


def _resident_and_streamed(port, net, cl, q):
    res, stream = port[q + "resident_bytes"], port[q + "streamed_bytes"]
    assert np.array_equal(port[q + "piece_bytes"], stream)
    tabs = port[q + "tabs"]
    small = port[q + "small_floats"]
    for r in range(cl):
        n_load = int(tabs[r, 1])
        assert 4 * n_load == 4 * int(small[r]) + int(res[r])
        assert n_load <= int(port[q + "wreg_floats"])
    if net == "jukebox3":  # jukebox3's slices outgrow a block: some stream
        assert stream.min() > 0


def _aligned(port, cl, q, slot=2048):
    tabs = port[q + "tabs"]
    n_units = len(_units(port, q))
    for r in range(cl):
        tab = tabs[r]
        base, n_load, n_pieces = int(tab[0]), int(tab[1]), int(tab[2])
        units = tab[TAB_HEADER : TAB_HEADER + 3 * n_units].reshape(n_units, 3)
        pieces = tab[TAB_HEADER + 3 * n_units :][: 2 * n_pieces].reshape(n_pieces, 2)
        assert base % 4 == 0 and n_load % 4 == 0
        assert all(int(w) % 4 == 0 for w in units[:, 0] if w >= 0)
        assert all(int(b) % 4 == 0 for b in units[:, 1])
        assert (pieces % 4 == 0).all()
        assert (pieces[:, 1] <= slot).all()  # a ring slot


def _smem(port, q):
    smem = int(port[q + "smem_bytes"])
    assert 0 < smem <= SMEM_PER_BLOCK
    assert smem % 16 == 0


@pytest.mark.parametrize("net,cl", CASES)
def test_every_column_is_computed_once(port, net, cl):
    """A product's columns over the ranks are its columns exactly once; a
    head product's (whole heads) exactly once over one block of each head
    group, whose blocks compute the same columns and split the head's query
    rows."""
    _columns_once(port, net, cl, _q(net, cl))


@pytest.mark.parametrize("net,cl", CASES)
def test_the_slices_hold_the_weights_a_step_reads(port, net, cl):
    """Counting a head product once per head group, the ranks' slices are
    the weights a step reads (the last up-sampler's last chunk only)."""
    _step_weights(port, net, cl, _q(net, cl))


@pytest.mark.parametrize("net,cl", CASES)
def test_resident_and_streamed_bytes_are_the_slices(port, net, cl):
    _resident_and_streamed(port, net, cl, _q(net, cl))


@pytest.mark.parametrize("net,cl", CASES)
def test_every_run_is_16_byte_aligned(port, net, cl):
    _aligned(port, cl, _q(net, cl))


@pytest.mark.parametrize("net,cl", CASES)
def test_a_block_fits_its_shared_memory(port, net, cl):
    _smem(port, _q(net, cl))


@pytest.mark.parametrize("net,cl", CASES)
def test_relaid_weights_hold_each_slice(port, net, cl):
    assert port[f"net_{net}/cl{cl}/slices_equal_pack"].all()


@pytest.mark.parametrize("net,cl,group", GCASES)
def test_group_plan_computes_every_column_once(port, net, cl, group):
    """The group kernel's plans split the products as the cluster
    kernel's, at every cluster size and group."""
    _columns_once(port, net, cl, _q(net, cl, group, port))


@pytest.mark.parametrize("net,cl,group", GCASES)
def test_group_plan_slices_hold_the_weights_a_step_reads(port, net, cl, group):
    _step_weights(port, net, cl, _q(net, cl, group, port))


@pytest.mark.parametrize("net,cl,group", GCASES)
def test_group_plan_resident_and_streamed_bytes_are_the_slices(port, net, cl, group):
    _resident_and_streamed(port, net, cl, _q(net, cl, group, port))


@pytest.mark.parametrize("net,cl,group", GCASES)
def test_group_plan_runs_are_16_byte_aligned_and_fit(port, net, cl, group):
    q = _q(net, cl, group, port)
    _aligned(port, cl, q, slot=4096)
    _smem(port, q)


@pytest.mark.parametrize("net,cl,group", GCASES)
def test_group_relaid_weights_hold_each_slice(port, net, cl, group):
    assert port[_q(net, cl, group, port) + "slices_equal_pack"].all()


def _expected(port, B):
    """The kernel the route tables name for B: the first (most streams,
    cluster size) of the cluster kernel's admitting B, else of the group
    kernel's, else the block kernel."""
    for most, cl in port["route"].tolist():
        if B <= most:
            return f"cluster{cl}"
    for most, cl in port["group_route"].tolist():
        if B <= most:
            return f"group{cl}"
    return "block"


@pytest.mark.parametrize("net", PLANNED)
@pytest.mark.parametrize("B", [1, 2, 7, 8, 15, 16, 60, 61, 64, 200])
def test_route_by_batch(port, net, B):
    """Clusters of 16 blocks up to 7 streams, of 8 up to 15
    (``K8_CLUSTER_ROUTE``), then the group kernel up to
    ``K8_GROUP_ROUTE``'s limit, the block kernel beyond, for chunks of 7,
    64 and 1,600 steps alike."""
    assert port["route"].tolist() == [[7, 16], [15, 8]]
    assert port["group_route"].tolist() == [[60, 8]]
    assert int(port["limit"]) == 15
    assert port[f"net_{net}/route_b{B}"].tolist() == [_expected(port, B)] * 3


@pytest.mark.parametrize("B", [1, 16, 200])
def test_a_net_outside_the_plans_takes_the_block_kernel(port, B):
    """3 heads divide among no cluster size (nor they among the heads):
    neither plan fits, and every B decodes on the block kernel, the gate
    admitting the net."""
    assert bool(port["net_outside/in_gate"])
    assert not bool(port["net_outside/cl8/fits"]) and not bool(port["net_outside/cl16/fits"])
    assert all(int(port[f"net_outside/g{cl}/max_streams"]) == 0 for cl in GROUP_SIZES)
    assert port[f"net_outside/route_b{B}"].tolist() == ["block"] * 3


@pytest.mark.parametrize("B", [1, 8, 16, 17])
def test_a_stream_keeps_one_kernel(port, B):
    """Every chunk of a 3-chunk JukeBox stream routes to one kernel."""
    taken = port[f"stream_route_b{B}"].tolist()
    assert len(taken) >= 3
    assert set(taken) == {_expected(port, B)}
    toks = port[f"stream_b{B}"]
    assert toks.shape == (B, 24) and len(set(toks[0].tolist())) > 1
