"""The fused LSTM kernels' plans (``ops/fused_lstm.py``), on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against their
plain versions); what each launch is given is decided in Python:

* the forward (K3a) takes ``lstm_kernel_rows`` batch rows a cluster of 8
  blocks: 4 at the training path's tier shapes (B=32, H=256), in f32 and
  bf16; it raises for H not a multiple of 8 and where a block's shared
  memory would pass 227 KB;
* the backward walk (K3b) takes ``lstm_bwd_plan``'s (cluster size, rows):
  ``LSTM_BWD_ROUTE``'s size for the stream dtype (8 where that size cannot
  take the net), the fewest rows that keep the clusters to the route's most;
  with a cluster size forced, H not a multiple of it raises, and so does a
  plan whose shared memory passes 227 KB or whose pairs pass a block's 256
  threads.  Every plan it gives lies within those limits.

The port runs in one subprocess for the module (``torch_port_worker.py
lstm_plan``).
"""
import numpy as np
import pytest

from tests.torch_port_harness import run_port

TIER = (32, 256)
CASES = [
    # the tier shapes, by the route and forced
    (32, 256, 4, 0), (32, 256, 2, 0), (32, 256, 4, 8), (32, 256, 4, 16), (32, 256, 2, 8),
    (32, 256, 2, 16),
    # the small shapes of the card's checks
    (4, 16, 4, 0), (3, 32, 4, 0), (3, 8, 4, 0), (4, 16, 2, 0),
    # wider batches: more rows a cluster
    (64, 256, 4, 0), (256, 256, 4, 0), (1, 256, 4, 0),
    # H not a multiple of the cluster size
    (4, 8, 4, 16), (4, 40, 4, 16), (4, 40, 2, 0), (4, 8, 2, 0), (4, 12, 4, 0), (4, 12, 4, 8),
    # shared memory past 227 KB
    (32, 344, 4, 0), (32, 512, 4, 0), (32, 512, 2, 0), (32, 512, 4, 8), (32, 384, 4, 8),
    # pairs past a block's threads
    (64, 320, 2, 8),
    # a cluster size the kernel is not built for
    (32, 256, 4, 4),
]


def _key(B, H, es, cl):
    return f"b{B}_h{H}_e{es}_cl{cl}"


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port("lstm_plan", {"cases": np.array(CASES)}, str(tmp_path_factory.mktemp("plan")))


def test_route_names_built_cluster_sizes(port):
    sizes = set(port["sizes"].tolist())
    assert sizes == {8, 16}
    for dt in ("float32", "bfloat16"):
        cl, most = port[f"route/{dt}"].tolist()
        assert cl in sizes and 1 <= most <= 132 // cl


@pytest.mark.parametrize("es", (4, 2))
def test_tier_shapes(port, es):
    k = _key(*TIER, es, 0)
    assert int(port[k + "/fwd_rows"]) == 4
    cl, rows = port[k + "/bwd_plan"].tolist()
    route_cl, most = port[f"route/{'float32' if es == 4 else 'bfloat16'}"].tolist()
    assert cl == route_cl and -(-TIER[0] // rows) <= most
    for forced in (8, 16):
        assert port[_key(*TIER, es, forced) + "/bwd_plan"].tolist()[0] == forced


@pytest.mark.parametrize("case", [c for c in CASES if c[2] in (2, 4)], ids=lambda c: _key(*c))
def test_every_plan_lies_within_the_limits(port, case):
    B, H, es, cl = case
    k = _key(*case)
    if k + "/bwd_plan" not in port:
        assert k + "/bwd_error" in port
        return
    size, rows = port[k + "/bwd_plan"].tolist()
    assert size in (8, 16) and H % size == 0 and H % 4 == 0
    assert rows in (1, 2, 4, 8) and rows * (H // size) <= 256
    assert int(port[k + "/bwd_smem"]) <= int(port["smem_limit"])
    if cl:
        assert size == cl


@pytest.mark.parametrize("case", [(4, 8, 4, 16), (4, 40, 4, 16), (4, 12, 4, 8), (32, 256, 4, 4)],
                         ids=lambda c: _key(*c))
def test_h_not_a_multiple_of_the_cluster_raises(port, case):
    k = _key(*case)
    assert k + "/bwd_plan" not in port
    assert "multiple" in str(port[k + "/bwd_error"]) or "not one of" in str(port[k + "/bwd_error"])


def test_unforced_size_drops_to_8_where_16_cannot_take_the_net(port):
    """bf16 streams route to 16 blocks (``LSTM_BWD_ROUTE``), but H = 40 or 8
    does not divide among them."""
    assert port["route/bfloat16"].tolist()[0] == 16
    assert port[_key(4, 40, 2, 0) + "/bwd_plan"].tolist()[0] == 8
    assert port[_key(4, 8, 2, 0) + "/bwd_plan"].tolist()[0] == 8


@pytest.mark.parametrize("case", [(32, 344, 4, 0), (32, 512, 4, 0), (32, 512, 4, 8),
                                  (32, 384, 4, 8)], ids=lambda c: _key(*c))
def test_shared_memory_past_227_kb_raises(port, case):
    k = _key(*case)
    assert k + "/bwd_plan" not in port
    assert "shared memory" in str(port[k + "/bwd_error"])


def test_forward_limits_raise(port):
    assert "multiple of 8" in str(port[_key(4, 12, 4, 0) + "/fwd_error"])
    assert "shared-memory" in str(port[_key(32, 344, 4, 0) + "/fwd_error"])
    assert "shared-memory" in str(port[_key(32, 512, 4, 0) + "/fwd_error"])


def test_pairs_past_a_blocks_threads_take_fewer_rows(port):
    """B=64 would take 8 rows a cluster, but 8 rows x 40 units pass 256
    threads."""
    size, rows = port[_key(64, 320, 2, 8) + "/bwd_plan"].tolist()
    assert size == 8 and rows == 4


@pytest.mark.parametrize("B,rows", [(1, 1), (64, 8), (256, 8)])
def test_rows_keep_the_clusters_to_the_routes_most(port, B, rows):
    assert port[_key(B, 256, 4, 0) + "/bwd_plan"].tolist()[1] == rows
