"""The wide LSTM kernels' layout (``ops/fused_lstm.py``), on the CPU.

K3a-wide and K3b-wide run only on the card (``chip_smoke.py`` holds them
against their plain versions); what each launch is given, and the order in
which the backward walk adds its partial sums, is mirrored in Python:

* ``_wide_shape`` / ``_wide_smem`` at every H the wide route takes (128 …
  1,024 in steps of 128), both stream types, both directions: the shared
  memory fits a block's 227 KB; a pass holds 32 batch rows, or 16 where 32
  do not fit (f32 at H = 896 and 1,024); every row pitch is 4 mod 32 words
  (a fragment's loads on 32 banks); the gate columns pad to the mma's N (8)
  and K (16 bf16, 8 f32); the warps' column tiles of the backward each lie in
  one rank's piece; the exchange's groups cover the clusters once;
* every field of ``_wide_shape`` the kernels read (U, NJ, NJP, KJ, P, PJ,
  RP, and the backward's groups G of CPG clusters) equals the .cu's own
  ``wide_shape``, cut out of the source and built for the host with g++;
* the wrappers' residency check refuses a card holding one cluster fewer
  than the launch's 128/WIDE_CL, and passes one holding enough;
* the backward's decomposition written in plain torch (each block's partial
  dh over its 4U gate columns, the two blocks of a cluster in rank order,
  then the 64 clusters in the kernel's groups) against
  ``lstm_backward_plain`` at (T, B, H) = (4, 3, 256) and (3, 5, 512): one
  step's dz @ Wh^T, and the whole walk's dxi, dh0 and dc0, within 1e-5 of
  the largest magnitude.

The port runs in one subprocess for the module (``torch_port_worker.py
lstm_wide_layout``).
"""
import os
import re
import subprocess

import numpy as np
import pytest

from tests.torch_port_harness import ROOT, run_port

WIDE_H = tuple(range(128, 1025, 128))
WALKS = ((4, 3, 256), (3, 5, 512))
# the fields of the .cu's WideShape, in its order
FIELDS = ("U", "NJ", "NJP", "KJ", "P", "PJ", "RP", "G", "CPG")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    rng = np.random.default_rng(17)
    inp = {"wide_h": np.array(WIDE_H), "walk_cases": np.array(WALKS)}
    for T, B, H in WALKS:
        p = f"walk/t{T}_b{B}_h{H}/"
        for name, shape, scale in (("xi", (T, B, 4 * H), 0.5), ("Wh", (H, 4 * H), H ** -0.5),
                                   ("h0", (B, H), 0.3), ("c0", (B, H), 0.3),
                                   ("dh_all", (T, B, H), 0.1), ("dh_T", (B, H), 0.1),
                                   ("dc_T", (B, H), 0.1)):
            inp[p + name] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return run_port("lstm_wide_layout", inp, str(tmp_path_factory.mktemp("wide_layout")))


def _shape(out, H, es, bw):
    k = f"h{H}_e{es}_bw{bw}/"
    return {n[len(k):]: int(v) for n, v in out.items() if n.startswith(k)}


@pytest.mark.parametrize("bw", (0, 1), ids=("forward", "backward"))
@pytest.mark.parametrize("es", (4, 2), ids=("f32", "bf16"))
@pytest.mark.parametrize("H", WIDE_H)
def test_layout_fits_a_block(layout, H, es, bw):
    s = _shape(layout, H, es, bw)
    assert 0 < s["smem"] <= int(layout["smem_limit"])
    assert s["U"] == H // 128 and s["NJ"] == 4 * s["U"]
    assert s["NJP"] % 8 == 0 and s["NJ"] <= s["NJP"] < s["NJ"] + 8
    kd = 16 if es == 2 else 8
    assert s["KJ"] % kd == 0 and s["NJ"] <= s["KJ"] < s["NJ"] + kd
    # every row pitch is 4 mod 32 32-bit words
    for pitch in (s["P"], s["PJ"]):
        assert (pitch * es // 4) % 32 in (4, 12, 20, 28)
    # 32 rows a pass where they fit, else 16 (and only f32 at H >= 896)
    assert s["RP"] in (16, 32)
    assert (s["RP"] == 16) == (es == 4 and H >= 896)
    assert s["RP"] * s["U"] <= int(layout["threads"])  # a thread a (row, unit)


@pytest.mark.parametrize("es", (4, 2), ids=("f32", "bf16"))
@pytest.mark.parametrize("H", WIDE_H)
def test_backward_tiles_and_groups(layout, H, es):
    """A warp's column tiles (H/64 of 8) lie in one rank's piece (H/2
    columns), and the exchange's groups cover each cluster once."""
    s = _shape(layout, H, es, 1)
    cl, blocks = int(layout["cl"]), int(layout["blocks"])
    warp_cols, piece = H // 8, H // cl
    assert piece % warp_cols == 0
    assert s["NCL"] == blocks // cl
    covered = [c for g in range(s["G"]) for c in range(g * s["CPG"], min(s["NCL"],
                                                                          (g + 1) * s["CPG"]))]
    assert covered == list(range(s["NCL"]))
    assert s["G"] <= 8


@pytest.fixture(scope="module")
def source_layout(tmp_path_factory):
    """{(H, es, backward): {field: value}} of the .cu's own ``wide_shape``,
    cut out of the source and built for the host."""
    src = open(os.path.join(ROOT, "mimikit_tpu_torch", "csrc", "fused_lstm.cu")).read()
    part = re.search(r"#define MMK_WIDE_BLOCKS.*?// -- end of the wide layout", src, re.S).group(0)
    fmt = " ".join(["%d"] * (3 + len(FIELDS)))
    show = ", ".join(f"s.{f}" for f in FIELDS)
    code = ("#include <cstdio>\n#include <cstddef>\n#define __host__\n#define __device__\n"
            "#define MMK_LSTM_THREADS 256\n" + part + "\n"
            "int main() {\n"
            f"  for (int H = 128; H <= 1024; H += 128)\n"
            "    for (int es = 4; es >= 2; es -= 2)\n"
            "      for (int bw = 0; bw < 2; ++bw) {\n"
            "        const WideShape s = wide_shape(H, es, bw);\n"
            f'        std::printf("{fmt}\\n", H, es, bw, {show});\n'
            "      }\n}\n")
    tmp = tmp_path_factory.mktemp("wide_source")
    cpp, exe = tmp / "wide.cpp", tmp / "wide"
    cpp.write_text(code)
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(cpp)], check=True,
                   capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    rows = [list(map(int, ln.split())) for ln in out.splitlines()]
    return {tuple(v[:3]): dict(zip(FIELDS, v[3:])) for v in rows}


@pytest.mark.parametrize("H", WIDE_H)
def test_layout_is_the_sources(layout, source_layout, H):
    for es in (4, 2):
        for bw in (0, 1):
            s = _shape(layout, H, es, bw)
            assert {f: s[f] for f in FIELDS} == source_layout[(H, es, bw)], (H, es, bw)


@pytest.mark.parametrize("T,B,H", WALKS)
def test_one_step_dh_in_the_kernels_order(layout, T, B, H):
    p = f"walk/t{T}_b{B}_h{H}/"
    ref, got = layout[p + "dz_wh"], layout[p + "wide_dz_wh"]
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("name", ("dxi", "dh0", "dc0"))
@pytest.mark.parametrize("T,B,H", WALKS)
def test_walk_in_the_kernels_order_matches_the_plain_version(layout, T, B, H, name):
    p = f"walk/t{T}_b{B}_h{H}/"
    ref, got = layout[p + name], layout[p + "wide_" + name]
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_a_card_holding_too_few_clusters_is_refused(layout):
    assert "needs 64 clusters of 2 blocks resident at once; this card holds 63" in str(
        layout["resident_short"])
    assert str(layout["resident_enough"]) == ""
