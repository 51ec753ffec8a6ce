"""The fused LSTM kernels' plans (``ops/fused_lstm.py``), on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against their
plain versions); what each launch is given is decided in Python:

* the forward (K3a) takes ``lstm_fwd_plan``'s (cluster size, rows):
  ``LSTM_FWD_ROUTE``'s size for the stream dtype (the other built size where
  that one cannot take the net), the fewest rows that keep the clusters to
  the route's most; with a cluster size forced, H not a multiple of it
  raises, and so does a plan whose shared memory passes 227 KB, and on bf16
  streams one that puts more than 32 units on a block (the tensor-core
  product's 8 warps of 4); pairs past a block's 256 threads take fewer rows;
* the backward walk (K3b) takes ``lstm_bwd_plan``'s (cluster size, rows):
  ``LSTM_BWD_ROUTE``'s size for the stream dtype (8 where that size cannot
  take the net), the fewest rows that keep the clusters to the route's most;
  with a cluster size forced, H not a multiple of it raises, and so does a
  plan whose shared memory passes 227 KB or whose pairs pass a block's 256
  threads.  Every plan either gives lies within those limits;
* the wrapper's shared-memory sizes are the source's: ``fwd_smem`` and
  ``bwd_smem`` of ``csrc/fused_lstm.cu``, cut out of the source and built
  with the host's C++ compiler, against ``_fwd_smem`` and ``_bwd_smem``.

The port runs in one subprocess for the module (``torch_port_worker.py
lstm_plan``).
"""
import os
import re
import subprocess

import numpy as np
import pytest

from tests.torch_port_harness import ROOT, run_port

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
    (4, 8, 4, 16), (4, 40, 4, 16), (4, 40, 2, 0), (4, 40, 4, 0), (4, 8, 2, 0), (4, 12, 4, 0),
    (4, 12, 4, 8),
    # shared memory past 227 KB
    (32, 344, 4, 0), (32, 512, 4, 0), (32, 512, 2, 0), (32, 512, 4, 8), (32, 384, 4, 8),
    # pairs past a block's threads
    (64, 320, 2, 8), (64, 320, 4, 8),
    # bf16: more units a block than the tensor-core product takes
    (32, 512, 2, 8),
    # a cluster size the kernel is not built for
    (32, 256, 4, 4),
]
# (H, rows, cluster size, element bytes) at which the shared-memory sizes of
# the wrapper and of the source are compared
SMEM_GRID = [(H, r, cl, es) for H in (16, 40, 96, 256, 320, 344, 512) for r in (1, 4, 8)
             for cl in (8, 16) for es in (4, 2)]


def _key(B, H, es, cl):
    return f"b{B}_h{H}_e{es}_cl{cl}"


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port("lstm_plan", {"cases": np.array(CASES), "smem_grid": np.array(SMEM_GRID)},
                    str(tmp_path_factory.mktemp("plan")))


def _route(port, part, es):
    return port[f"{part}/{'float32' if es == 4 else 'bfloat16'}"].tolist()


def test_route_names_built_cluster_sizes(port):
    sizes = set(port["sizes"].tolist())
    assert sizes == {8, 16}
    for dt in ("float32", "bfloat16"):
        cl, most = port[f"route/{dt}"].tolist()
        assert cl in sizes and 1 <= most <= 132 // cl


def test_forward_route_names_built_cluster_sizes(port):
    sizes = set(port["fwd_sizes"].tolist())
    assert sizes == {8, 16}
    for es in (4, 2):
        cl, most = _route(port, "fwd_route", es)
        assert cl in sizes and 1 <= most <= 132 // cl


@pytest.mark.parametrize("es", (4, 2))
def test_tier_shapes(port, es):
    k = _key(*TIER, es, 0)
    cl, rows = port[k + "/fwd_plan"].tolist()
    route_cl, most = _route(port, "fwd_route", es)
    assert cl == route_cl and rows == 4 and -(-TIER[0] // rows) <= most
    for forced in (8, 16):
        assert port[_key(*TIER, es, forced) + "/fwd_plan"].tolist() == [forced, 4]
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
    assert "multiple" in str(port[_key(4, 12, 4, 0) + "/fwd_error"])
    assert "shared memory" in str(port[_key(32, 344, 4, 0) + "/fwd_error"])
    assert "shared memory" in str(port[_key(32, 512, 4, 0) + "/fwd_error"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: _key(*c))
def test_every_forward_plan_lies_within_the_limits(port, case):
    B, H, es, cl = case
    k = _key(*case)
    if k + "/fwd_plan" not in port:
        assert k + "/fwd_error" in port
        return
    size, rows = port[k + "/fwd_plan"].tolist()
    assert size in (8, 16) and H % size == 0 and H % 4 == 0
    assert rows in (1, 2, 4, 8) and rows * (H // size) <= 256
    assert es == 4 or H // size <= 32
    assert int(port[k + "/fwd_smem"]) <= int(port["smem_limit"])
    if cl:
        assert size == cl


@pytest.mark.parametrize("case", [(4, 8, 4, 16), (4, 40, 4, 16), (4, 12, 4, 8), (32, 256, 4, 4)],
                         ids=lambda c: _key(*c))
def test_forward_h_not_a_multiple_of_the_cluster_raises(port, case):
    k = _key(*case)
    assert k + "/fwd_plan" not in port
    assert "multiple" in str(port[k + "/fwd_error"]) or "not one of" in str(port[k + "/fwd_error"])


@pytest.mark.parametrize("case", [(32, 344, 4, 0), (32, 512, 4, 0), (32, 512, 4, 8),
                                  (32, 384, 4, 8)], ids=lambda c: _key(*c))
def test_forward_shared_memory_past_227_kb_raises(port, case):
    k = _key(*case)
    assert k + "/fwd_plan" not in port
    assert "shared memory" in str(port[k + "/fwd_error"])


@pytest.mark.parametrize("case", [(4, 40, 2, 0), (4, 8, 2, 0), (4, 40, 4, 0), (32, 512, 2, 0)],
                         ids=lambda c: _key(*c))
def test_forward_unforced_size_takes_the_other_where_the_routes_cannot(port, case):
    """H = 40 or 8 does not divide among 16 blocks; bf16 at H = 512 puts 64
    units on each of 8 blocks, past the tensor-core product's 32."""
    B, H, es, _ = case
    size = port[_key(*case) + "/fwd_plan"].tolist()[0]
    route = _route(port, "fwd_route", es)[0]
    takes_route = H % route == 0 and (es == 4 or H // route <= 32)
    assert size == (route if takes_route else 24 - route)


def test_bf16_forward_past_32_units_a_block_raises(port):
    assert "32 units" in str(port[_key(32, 512, 2, 8) + "/fwd_error"])


def test_forward_pairs_past_a_blocks_threads_take_fewer_rows(port):
    """B=64 would take 8 rows a cluster, but 8 rows x 40 units pass 256
    threads."""
    assert port[_key(64, 320, 4, 8) + "/fwd_plan"].tolist() == [8, 4]


@pytest.mark.parametrize("B,rows", [(1, 1), (64, 8), (256, 8)])
def test_forward_rows_keep_the_clusters_to_the_routes_most(port, B, rows):
    assert port[_key(B, 256, 4, 0) + "/fwd_plan"].tolist()[1] == rows


def _source_smem(tmp_path):
    """{(H, rows, cl, es): (fwd_smem, bwd_smem)} of the .cu's own functions,
    cut out of the source and built for the host."""
    src = open(os.path.join(ROOT, "mimikit_tpu_torch", "csrc", "fused_lstm.cu")).read()
    parts = [re.search(r"__host__ __device__ inline int mmk_pow2_floor.*?\n// The product of one step",
                       src, re.S).group(0),
             re.search(r"static size_t fwd_smem\(.*?\n// Launches", src, re.S).group(0)]
    grid = "".join(f"  show({H}, {r}, {cl}, {es});\n" for H, r, cl, es in SMEM_GRID)
    code = ("#include <cstdio>\n#include <cstddef>\n#define __host__\n#define __device__\n"
            "#define MMK_LSTM_THREADS 256\n" + "\n".join(parts) + "\n"
            "static void show(int H, int r, int cl, int es) {\n"
            '  std::printf("%d %d %d %d %zu %zu\\n", H, r, cl, es, fwd_smem(H, r, cl, es),'
            " bwd_smem(H, r, cl, es));\n}\nint main() {\n" + grid + "}\n")
    cpp, exe = tmp_path / "smem.cpp", tmp_path / "smem"
    cpp.write_text(code)
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(cpp)], check=True,
                   capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    return {tuple(v[:4]): tuple(v[4:]) for v in (list(map(int, ln.split())) for ln in out.splitlines())}


@pytest.mark.parametrize("part", ("fwd", "bwd"))
def test_shared_memory_agrees_with_the_source(port, part, tmp_path):
    c = _source_smem(tmp_path)
    col = 4 if part == "fwd" else 5
    got = {tuple(v[:4]): int(v[col]) for v in port["smem_grid"].tolist()}
    assert set(got) == set(c)
    assert all(got[k] == c[k][col - 4] for k in got), [
        (k, got[k], c[k][col - 4]) for k in got if got[k] != c[k][col - 4]][:5]


def test_pairs_past_a_blocks_threads_take_fewer_rows(port):
    """B=64 would take 8 rows a cluster, but 8 rows x 40 units pass 256
    threads."""
    size, rows = port[_key(64, 320, 2, 8) + "/bwd_plan"].tolist()
    assert size == 8 and rows == 4


@pytest.mark.parametrize("B,rows", [(1, 1), (64, 8), (256, 8)])
def test_rows_keep_the_clusters_to_the_routes_most(port, B, rows):
    assert port[_key(B, 256, 4, 0) + "/bwd_plan"].tolist()[1] == rows
