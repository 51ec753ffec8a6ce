"""LSTM layer over time for training: hand-written CUDA kernels, their
wrappers and their plain PyTorch versions.

The kernels (``csrc/fused_lstm.cu``) replace the TPU kernels of
``mimikit_tpu/ops/pallas_lstm.py:76`` ``_make_fused_calls``: the forward
(K3a, ``pallas_call`` at :111) and the backward (K3b, :197).  What bounds
them on an H100 and what their design does about it is in the source note at
the top of the ``.cu`` file.  A layer takes one of three routes
(:func:`lstm_route`, in the order of JAX's gate,
``mimikit_tpu/modules/rnn.py:99-128``):

* ``"cluster"``: both recurrences on thread block clusters of 8 or 16
  blocks, each block owning H/cl hidden units with its slice of Wh in shared
  memory: the size by stream dtype is a route from a sweep on the card
  (``LSTM_FWD_ROUTE``, ``LSTM_BWD_ROUTE``), and the plans
  (``lstm_fwd_plan``, ``lstm_bwd_plan``) pick the batch rows a cluster and
  raise outside the kernels' limits (:func:`lstm_forward`,
  :func:`lstm_backward`);
* ``"wide"``: where a cluster cannot hold Wh, H a multiple of 128 up to
  1,024 (:func:`lstm_wide_plan`): one cooperative launch of 128 blocks in
  clusters of 2, each owning H/128 units with its part of Wh in shared
  memory, a grid barrier a step, the products on the tensor cores
  (K3a-wide :func:`lstm_forward_wide`, K3b-wide :func:`lstm_backward_wide`);
* ``"scan"``: outside JAX's kernel gate (H not a multiple of 128, B < 8 or
  B*T < 64), where JAX runs a ``lax.scan``: ``LSTM.forward_seq`` runs a step
  loop under autograd, and no kernel.

* :func:`lstm_forward` ``(xi, Wh, h0, c0) -> (h_all, c_all, gates)``;
* :func:`lstm_backward` ``(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0,
  Wh) -> (dxi, dWh, dh0, dc0)``;
* :func:`fused_lstm_layer` ``(x, Wi, Wh, b, h0, c0) -> (h_all, h_T, c_T)``,
  the layer as ``pallas_lstm.fused_lstm_layer`` has it (time-major, gate
  order i|f|g|o, ``Wi`` (D, 4H), ``Wh`` (H, 4H)), differentiable in every
  argument through a ``torch.autograd.Function`` whose backward is the
  backward kernel.  ``xi = x @ Wi + b`` and ``db``, ``dWi``, ``dx`` from
  ``dxi`` are products outside the kernels, as in ``pallas_lstm.py:245-277``.

The wrappers' rule: a CPU tensor takes the plain version
(:func:`lstm_forward_plain`, :func:`lstm_backward_plain`, step loops that
mirror the kernels' arithmetic); a CUDA tensor launches the kernel or raises.

Stream types (``pallas_lstm.py:29-36,308``): float32, or bfloat16 for the
``param_dtype="bfloat16"`` training policy.  Every stream of a call has one
dtype, checked.  On bf16 streams the carries and the arithmetic stay f32;
h (the stored h_all and the next product's input) and the backward's dz (the
stored dxi and the input of ``dz @ Wh^T``) are rounded to bf16 once, and c,
the gates, dh0, dc0 and dWh where they are stored.  The layer's products
outside the kernels take the bf16 values in f32 and round their results
once, as ``pallas_lstm.py:244-278`` does; a float16 layer runs the f32
kernels and returns float16.  Each wrapper counts its f32 launches in
``.launches`` and its bf16 ones in ``.launches_bf16``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .nvcc import CSRC, build_library

__all__ = [
    "lstm_forward_plain",
    "lstm_backward_plain",
    "lstm_forward",
    "lstm_backward",
    "fused_lstm_layer",
    "lstm_fwd_plan",
    "lstm_bwd_plan",
    "lstm_wide_plan",
    "lstm_route",
    "lstm_forward_wide",
    "lstm_backward_wide",
    "LSTM_FWD_ROUTE",
    "LSTM_BWD_ROUTE",
    "build_lstm_kernel",
]

SOURCE = CSRC / "fused_lstm.cu"
THREADS = 256     # threads of a block
SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may use on sm_90
_ROW_GROUPS = (1, 2, 4, 8)
# the cluster sizes the forward and the backward walk are built for: a
# block of a cluster of cl owns H/cl hidden units
FWD_CLUSTER_SIZES = (8, 16)
BWD_CLUSTER_SIZES = (8, 16)
# per stream dtype, (cluster size, most clusters) of the forward, as the
# backward's below.  chip_smoke.py's sweep times both sizes at the training
# path's tier shapes, B=32 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): a
# step ~2.6 us on 8 blocks against ~3.7 on 16 in f32, ~2.3 against ~2.9 in
# bf16 (tools/profile_lstm_fwd.py: on 16 the push and barrier cost more, and
# two blocks may share an SM)
LSTM_FWD_ROUTE = {
    torch.float32: (8, 8),
    torch.bfloat16: (8, 8),
}
# per stream dtype, (cluster size, most clusters) of the backward walk: the
# batch is split into the fewest rows a cluster (1, 2, 4 or 8) that keep the
# clusters to that many.  chip_smoke.py's sweep times both sizes at the
# training path's tier shapes, B=32 (NVIDIA H100 80GB HBM3, 700 W; PERF.md
# §6): a step of the walk ~3.0 us on 8 blocks against ~3.15 on 16 in f32,
# ~3.6 against ~3.3 in bf16, whose product costs more on 8 blocks
# (tools/profile_lstm_bwd.py).
LSTM_BWD_ROUTE = {
    torch.float32: (8, 8),
    torch.bfloat16: (16, 8),
}
# the wide route (``MMK_WIDE_*`` in the .cu): blocks of its cooperative
# launch, blocks a cluster (an H100 holds 66 clusters of 2 such blocks, 30 of
# 4: tools/wide_cluster_probe.py), batch rows a pass (halved where they do
# not fit), groups of clusters in the backward's sum of the clusters'
# partial dh; H a multiple of WIDE_BLOCKS up to WIDE_MAX_H
WIDE_BLOCKS, WIDE_CL, WIDE_RP, WIDE_GROUPS, WIDE_MAX_H = 128, 2, 32, 8, 1024
WARPS = THREADS // 32


# -- plain versions ---------------------------------------------------------------

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _rounding(dtype: torch.dtype):
    """f32 -> f32 rounded through ``dtype`` (the identity for float32)."""
    if dtype == torch.float32:
        return lambda v: v
    return lambda v: v.to(dtype).float()


def lstm_forward_plain(xi: torch.Tensor, Wh: torch.Tensor, h0: torch.Tensor,
                       c0: torch.Tensor):
    """The forward kernel's arithmetic as a PyTorch step loop
    (``pallas_lstm.py:95-109``).  xi (T, B, 4H); returns h_all, c_all
    (T, B, H) and the post-activation gates (T, B, 4H), in xi's dtype.  On
    bf16 streams the arithmetic and the c carry are f32, the product takes the
    rounded h (bf16 values multiplied in f32: exact products, f32 sums), and
    h, c and the gates are rounded where stored."""
    dt = xi.dtype
    rnd = _rounding(dt)
    H = Wh.shape[0]
    Wh = Wh.float()
    h, c = h0.float(), c0.float()
    hs, cs, gs = [], [], []
    for t in range(xi.shape[0]):
        z = xi[t].float() + h @ Wh
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H : 2 * H])
        g = torch.tanh(z[:, 2 * H : 3 * H])
        o = torch.sigmoid(z[:, 3 * H :])
        c = f * c + i * g
        h = rnd(o * torch.tanh(c))
        hs.append(h)
        cs.append(c)
        gs.append(torch.cat([i, f, g, o], dim=1))
    return tuple(torch.stack(v).to(dt) for v in (hs, cs, gs))


def lstm_backward_plain(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh):
    """The backward kernel's arithmetic as a reverse-time PyTorch loop,
    written out as ``bwd_kernel`` is (``pallas_lstm.py:143-195``), with
    ``dWh`` summed step by step in f32.  Returns dxi (T, B, 4H), dWh (H, 4H),
    dh0, dc0 (B, H), in the streams' dtype.  On bf16 streams the dh and dc
    carries are f32, dz is rounded to bf16 once (the stored dxi and the input
    of ``dz @ Wh^T``), and dWh, dh0 and dc0 are rounded where stored."""
    dt = gates.dtype
    rnd = _rounding(dt)
    T, B, H = c_all.shape
    Wh = Wh.float()
    dh_c, dc_c = dh_T.float(), dc_T.float()
    dWh = torch.zeros_like(Wh)
    dxi = torch.empty(gates.shape, dtype=torch.float32, device=gates.device)
    for t in range(T - 1, -1, -1):
        dh = dh_all[t].float() + dh_c
        i, f, g, o = gates[t].float().split(H, dim=1)
        tc = torch.tanh(c_all[t].float())
        do = dh * tc
        dc = dc_c + dh * o * (1.0 - tc * tc)
        c_prev = (c_all[t - 1] if t > 0 else c0).float()
        dz = rnd(torch.cat([
            dc * g * i * (1.0 - i),
            dc * c_prev * f * (1.0 - f),
            dc * i * (1.0 - g * g),
            do * o * (1.0 - o),
        ], dim=1))
        dxi[t] = dz
        dh_c = dz @ Wh.t()
        dc_c = dc * f
        h_prev = (h_all[t - 1] if t > 0 else h0).float()
        dWh += h_prev.t() @ dz
    return tuple(v.to(dt) for v in (dxi, dWh, dh_c, dc_c))


# -- the kernels: scope, build, bind, launch ------------------------------------------

def _fwd_shape(H: int, cl: int) -> dict:
    """The forward's layout (``fwd_shape`` in the .cu) on clusters of ``cl``:
    units a block U; f32: lanes a unit KSW (a power of two, at most 32, U *
    KSW <= 256), units a warp UW, the slice's row pitch HP (a phase of eight
    lanes on distinct banks); bf16: warps with columns NWM (4 units each), k
    padded to KP (tiles of 16), the pitch HB of the slice's and the h
    buffers' rows."""
    U = H // cl
    per = min(32, max(1, THREADS // U)) if U > 0 else 1
    ksw = 1 << (per.bit_length() - 1)
    uw = 32 // ksw
    KP = -(-H // 16) * 16
    return dict(U=U, KSW=ksw, UW=uw, HP=-(-H // 32) * 32 + (4 if uw >= 8 else (32 // uw) % 32),
                NWM=-(-U // 4), KP=KP, HB=-(-KP // 64) * 64 + 8)


def _fwd_smem(H: int, rows: int, cl: int, esize: int = 4) -> int:
    """Bytes of shared memory of the forward kernel (``fwd_smem`` in the .cu)
    on clusters of ``cl`` blocks for ``esize``-byte streams: the block's Wh
    slice, two h buffers (by step parity) and its new h, all of the stream
    type (bf16: the slice in 16-column warp tiles, the h buffers of 8
    rows)."""
    s = _fwd_shape(H, cl)
    if esize == 4:
        return 4 * (4 * s["U"] * s["HP"] + 2 * rows * H + rows * s["U"])
    return 2 * (16 * s["NWM"] * s["HB"] + 2 * 8 * s["HB"] + rows * s["U"])


def _bwd_smem(H: int, rows: int, cl: int, esize: int = 4) -> int:
    """Bytes of shared memory of the backward walk (``bwd_smem`` in the .cu)
    on clusters of ``cl`` blocks: the block's Wh columns (4H/cl rows of H + 4
    stream elements), its dz, the product's partial sums and the receive
    area of the exchanged pieces (f32)."""
    U = H // cl
    NC = 4 * U
    JS = THREADS // (H // 4)
    return esize * NC * (H + 4) + 4 * (NC * rows + JS * rows * H + 2 * cl * rows * U)


def _fwd_fits(H: int, cl: int, rows: int, esize: int) -> str:
    """Why the forward cannot run (H, ``rows`` a cluster) on clusters of
    ``cl`` blocks; "" where it can (``fwd_fits`` in the .cu, and the shared
    memory)."""
    if cl not in FWD_CLUSTER_SIZES:
        return f"cluster size {cl} is not one of {FWD_CLUSTER_SIZES}"
    if H < cl or H % cl or H % 4:
        return f"H={H} is not a multiple of the cluster size {cl} and of 4"
    if rows * (H // cl) > THREADS:
        return f"H={H} at {rows} rows a cluster needs more than {THREADS} threads a block"
    if esize == 2 and H // cl > 32:
        return (f"H={H} on clusters of {cl} puts more than 32 units on a block"
                f" (the bf16 product's 8 warps of 4)")
    smem = _fwd_smem(H, rows, cl, esize)
    if smem > SMEM_PER_BLOCK:
        return (f"H={H} on clusters of {cl} needs {smem} bytes of shared memory a block"
                f" (at most {SMEM_PER_BLOCK})")
    return ""


def _plan(B: int, H: int, esize: int, cl: Optional[int], route: dict, sizes: tuple,
          fits, what: str) -> Tuple[int, int]:
    """(cluster size, rows a cluster) from ``route`` (the other sizes in
    order where the route's cannot take the net at one row), the fewest rows
    (1, 2, 4 or 8) that keep the clusters to the route's most; ``fits`` says
    why a plan cannot run (where no size takes the net, the smallest's
    reason is raised)."""
    size, most = route[torch.float32 if esize == 4 else torch.bfloat16]
    if B < 1:
        raise ValueError(f"the LSTM {what} needs B >= 1, got B={B}")
    if cl is None:
        cl = next((c for c in (size, *sizes) if not fits(H, c, 1, esize)), min(sizes))
    rows = [r for r in _ROW_GROUPS if not fits(H, cl, r, esize)]
    if not rows:
        raise ValueError(f"the LSTM {what} kernel cannot run: {fits(H, cl, 1, esize)}")
    return cl, next((r for r in rows if -(-B // r) <= most), rows[-1])


def lstm_fwd_plan(B: int, H: int, esize: int = 4, cl: Optional[int] = None) -> Tuple[int, int]:
    """(cluster size, batch rows a cluster) of the forward at (B, H) on
    ``esize``-byte streams: ``cl`` if given, else ``LSTM_FWD_ROUTE``'s size
    for the streams' dtype (another built size where that one cannot take
    the net); the fewest rows (1, 2, 4 or 8) that keep the clusters to the
    route's most, within the limits.  Raises ``ValueError`` outside them: H a
    multiple of the cluster size and of 4, rows x H/cl within a block's 256
    threads, bf16 at most 32 units a block, and a block's shared memory (227
    KB)."""
    return _plan(B, H, esize, cl, LSTM_FWD_ROUTE, FWD_CLUSTER_SIZES, _fwd_fits, "forward")


def _bwd_fits(H: int, cl: int, rows: int, esize: int) -> str:
    """Why the backward walk cannot run (H, ``rows`` a cluster) on clusters
    of ``cl`` blocks; "" where it can."""
    if cl not in BWD_CLUSTER_SIZES:
        return f"cluster size {cl} is not one of {BWD_CLUSTER_SIZES}"
    if H % cl or H % 4:
        return f"H={H} is not a multiple of the cluster size {cl} and of 4"
    if H // 4 > THREADS or rows * (H // cl) > THREADS:
        return f"H={H} at {rows} rows a cluster needs more than {THREADS} threads a block"
    smem = _bwd_smem(H, rows, cl, esize)
    if smem > SMEM_PER_BLOCK:
        return (f"H={H} on clusters of {cl} needs {smem} bytes of shared memory a block"
                f" (at most {SMEM_PER_BLOCK})")
    return ""


def lstm_bwd_plan(B: int, H: int, esize: int = 4, cl: Optional[int] = None) -> Tuple[int, int]:
    """(cluster size, batch rows a cluster) of the backward walk at (B, H) on
    ``esize``-byte streams: ``cl`` if given, else ``LSTM_BWD_ROUTE``'s size
    for the streams' dtype (8 where that size cannot take the net); the
    fewest rows (1, 2, 4 or 8) that keep the clusters to the route's most,
    within the limits.  Raises ``ValueError`` outside them: H a multiple of
    the cluster size and of 4, a block's threads, and its shared memory
    (227 KB)."""
    return _plan(B, H, esize, cl, LSTM_BWD_ROUTE, BWD_CLUSTER_SIZES, _bwd_fits, "backward")


def _wide_bytes(H: int, esize: int, backward: bool, s: dict) -> int:
    """Bytes of shared memory of a wide kernel at the layout ``s``
    (``wide_bytes`` in the .cu): forward, the slice (NJP x P), a pass's h
    rows (RP x P), the warps' partial sums (8 x RP x NJP f32) and an
    mbarrier; backward, the slice (H x PJ), a pass's dz (RP x PJ), the
    cluster's pieces of partial dh (WIDE_CL x RP x (H/WIDE_CL + 4) f32) and
    the exchange's partial sums (8 x RP x U f32) and an mbarrier."""
    def r16(n):
        return -(-n // 16) * 16
    if backward:
        return (r16(esize * H * s["PJ"]) + r16(esize * s["RP"] * s["PJ"])
                + 4 * (s["RP"] * (H + 4 * WIDE_CL) + WIDE_GROUPS * s["RP"] * s["U"]) + 16)
    return (r16(esize * s["NJP"] * s["P"]) + r16(esize * s["RP"] * s["P"])
            + 4 * WARPS * s["RP"] * s["NJP"] + 16)


def _wide_shape(H: int, esize: int, backward: bool) -> dict:
    """The wide route's layout (``wide_shape`` in the .cu): units a block U,
    gate columns NJ = 4U, padded to an mma's N (NJP, 8) and K (KJ: 16 bf16,
    8 f32), the pitch P of h's and the forward slice's rows (H + 4 floats,
    H + 8 bf16: 4 mod 32 words), the pitch PJ of the backward slice's and
    dz's rows, batch rows a pass RP (WIDE_RP, or half where that does not
    fit); the backward's clusters NCL = 128/WIDE_CL, whose sums of partial
    dh an owner adds in G groups of CPG clusters (each group in cluster
    order, then the groups in order)."""
    U = H // WIDE_BLOCKS
    kd = 16 if esize == 2 else 8
    s = dict(U=U, NJ=4 * U, NJP=-(-4 * U // 8) * 8, KJ=-(-4 * U // kd) * kd,
             P=H + 16 // esize, RP=WIDE_RP, NCL=WIDE_BLOCKS // WIDE_CL)
    s["PJ"] = s["KJ"] + 16 // esize
    if _wide_bytes(H, esize, backward, s) > SMEM_PER_BLOCK:
        s["RP"] = WIDE_RP // 2
    s["G"] = min(WIDE_GROUPS, max(1, 4 * THREADS // max(1, s["RP"] * U)))
    s["CPG"] = -(-s["NCL"] // s["G"])
    return s


def _wide_smem(H: int, esize: int, backward: bool) -> int:
    """Bytes of shared memory of K3a-wide (K3b-wide with ``backward``) on
    ``esize``-byte streams (``wide_smem`` in the .cu)."""
    return _wide_bytes(H, esize, backward, _wide_shape(H, esize, backward))


def _wide_work(B: int, H: int, backward: bool) -> int:
    """Floats of a wide kernel's f32 workspace at (B, H) (``wide_work`` in
    the .cu): the carry (B x H) and, backward, the exchange of the clusters'
    sums of partial dh (2 x 128/WIDE_CL x B x H)."""
    return B * H * (1 + 2 * WIDE_BLOCKS // WIDE_CL if backward else 1)


def _wide_fits(H: int, esize: int) -> str:
    """Why the wide route cannot take H; "" where it can (``wide_fits`` in
    the .cu)."""
    if H < WIDE_BLOCKS or H % WIDE_BLOCKS:
        return f"H={H} is not a multiple of {WIDE_BLOCKS}"
    if H > WIDE_MAX_H:
        return f"H={H} is past the wide kernels' {WIDE_MAX_H}"
    smem = max(_wide_smem(H, esize, False), _wide_smem(H, esize, True))
    if smem > SMEM_PER_BLOCK:
        return (f"H={H} needs {smem} bytes of shared memory a block (at most"
                f" {SMEM_PER_BLOCK})")
    return ""


def lstm_wide_plan(B: int, H: int, esize: int = 4) -> Tuple[int, int]:
    """(blocks, hidden units a block) of K3a-wide and K3b-wide at (B, H) on
    ``esize``-byte streams: ``WIDE_BLOCKS`` blocks of H/128 units, any B >= 1.
    Raises ``ValueError`` outside the limits: H a multiple of 128 up to
    1,024, and a block's shared memory (227 KB)."""
    if B < 1:
        raise ValueError(f"the wide LSTM kernels need B >= 1, got B={B}")
    why = _wide_fits(H, esize)
    if why:
        raise ValueError(f"the wide LSTM kernels cannot run: {why}")
    return WIDE_BLOCKS, H // WIDE_BLOCKS


def _jax_runs_a_scan(B: int, T: int, H: int) -> bool:
    """Outside the JAX package's kernel gate (``mimikit_tpu/modules/rnn.py:
    126-128``, ``_use_fused_lstm``), where it runs a ``lax.scan``."""
    return H % 128 != 0 or B < 8 or B * T < 64


def lstm_route(B: int, T: int, H: int, dtype: torch.dtype = torch.float32,
               cpu: bool = False) -> str:
    """The route of one LSTM layer at (B, T, H) on ``dtype`` streams
    (bfloat16, or float32 for any other dtype): ``"cluster"`` where both
    cluster plans take it, else ``"wide"`` where :func:`lstm_wide_plan` does,
    else ``"scan"`` where JAX runs its scan.  Otherwise (H past the wide
    route's 1,024 inside JAX's gate) it raises ``ValueError`` naming both
    plans' reasons, or with ``cpu`` gives ``"plain"``: on CPU tensors the
    fused layer runs its plain versions at any width."""
    es = 2 if dtype == torch.bfloat16 else 4
    try:
        lstm_fwd_plan(B, H, es)
        lstm_bwd_plan(B, H, es)
        return "cluster"
    except ValueError as e:
        cluster = str(e)
    wide = _wide_fits(H, es)
    if not wide:
        return "wide"
    if _jax_runs_a_scan(B, T, H):
        return "scan"
    if cpu:
        return "plain"
    raise ValueError(f"no LSTM route takes (B, T, H) = ({B}, {T}, {H}) on {dtype} streams:"
                     f" {cluster}; the wide kernels: {wide}")


def dwh_splits(R: int, H: int) -> int:
    """Row ranges the dWh product splits its R = T*B rows into: enough for
    about 512 blocks of 64 x 64 tiles (several per SM), each range at least
    256 rows."""
    tiles = -(-H // 64) * -(-4 * H // 64)
    return max(1, min(R // 256, -(-512 // tiles)))


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""
    # {(device, H, backward, dtype): clusters}: wide_clusters_that_fit's answers
    wide_clusters = {}


def build_lstm_kernel() -> Path:
    """Compile ``csrc/fused_lstm.cu`` for sm_90a into ``build/kernels/``
    and return the library's path."""
    path, log = build_library(SOURCE, "mmk_fused_lstm")
    if log:
        _Kernel.build_log = log
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/fused_lstm.cu``) with its functions'
    argument and result types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mmk_lstm_forward.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.mmk_lstm_forward.restype = i
    lib.mmk_lstm_backward.argtypes = [p] * 14 + [i] * 7 + [p]
    lib.mmk_lstm_backward.restype = i
    for fn in (lib.mmk_lstm_fwd_smem, lib.mmk_lstm_bwd_smem):
        fn.argtypes = [i] * 4
        fn.restype = ctypes.c_longlong
    for fn in (lib.mmk_lstm_fwd_clusters, lib.mmk_lstm_bwd_clusters):
        fn.argtypes = [i] * 4
        fn.restype = i
    lib.mmk_lstm_wide_forward.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.mmk_lstm_wide_forward.restype = i
    lib.mmk_lstm_wide_backward.argtypes = [p] * 15 + [i] * 5 + [p]
    lib.mmk_lstm_wide_backward.restype = i
    lib.mmk_lstm_wide_smem.argtypes = [i] * 3
    lib.mmk_lstm_wide_smem.restype = ctypes.c_longlong
    lib.mmk_lstm_wide_work.argtypes = [i] * 3
    lib.mmk_lstm_wide_work.restype = ctypes.c_longlong
    lib.mmk_lstm_wide_clusters.argtypes = [i] * 3
    lib.mmk_lstm_wide_clusters.restype = i
    lib.mmk_lstm_wide_layout.argtypes = [i] * 3 + [ctypes.POINTER(i)]
    lib.mmk_lstm_wide_layout.restype = None
    lib.mmk_lstm_error_string.argtypes = [i]
    lib.mmk_lstm_error_string.restype = ctypes.c_char_p
    return lib


# the fields of the wide layout, in the order mmk_lstm_wide_layout gives them
_WIDE_LAYOUT = ("U", "NJ", "NJP", "KJ", "P", "PJ", "RP", "G", "CPG")


def _source_wide_layout(lib, H: int, es: int, bw: int) -> tuple:
    out = (ctypes.c_int * len(_WIDE_LAYOUT))()
    lib.mmk_lstm_wide_layout(H, es, bw, out)
    return tuple(out)


def _mirror_wide_layout(H: int, es: int, bw: int) -> tuple:
    s = _wide_shape(H, es, bool(bw))
    return tuple(s[k] for k in _WIDE_LAYOUT)


def _library():
    if _Kernel.lib is None:
        lib = _bind(ctypes.CDLL(str(build_lstm_kernel())))
        for H, r, es in ((256, 4, 4), (16, 1, 4), (256, 8, 2), (16, 1, 2), (320, 2, 4)):
            if any(lib.mmk_lstm_fwd_smem(H, r, cl, es) != _fwd_smem(H, r, cl, es)
                   for cl in FWD_CLUSTER_SIZES) or any(
                lib.mmk_lstm_bwd_smem(H, r, cl, es) != _bwd_smem(H, r, cl, es)
                for cl in BWD_CLUSTER_SIZES
            ):
                raise RuntimeError("the LSTM kernels' shared-memory sizes differ between C and Python")
        if any(lib.mmk_lstm_wide_smem(H, es, bw) != _wide_smem(H, es, bool(bw))
               or lib.mmk_lstm_wide_work(5, H, bw) != _wide_work(5, H, bool(bw))
               or _source_wide_layout(lib, H, es, bw) != _mirror_wide_layout(H, es, bw)
               for H in range(WIDE_BLOCKS, WIDE_MAX_H + 1, WIDE_BLOCKS)
               for es in (4, 2) for bw in (0, 1)):
            raise RuntimeError("the wide LSTM kernels' layout, shared-memory or workspace sizes"
                               " differ between C and Python")
        _Kernel.lib = lib
    return _Kernel.lib


def _check(x: torch.Tensor, name: str, shape, device, dtype):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}; this call's streams are {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream_dtype(x: torch.Tensor) -> torch.dtype:
    if x.dtype not in _STREAM_DTYPES:
        raise ValueError(f"the LSTM kernels take float32 or bfloat16 streams, got {x.dtype}")
    return x.dtype


def _count(wrapper, dtype: torch.dtype):
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {_library().mmk_lstm_error_string(err).decode()}")


def lstm_forward(xi: torch.Tensor, Wh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                 cl: Optional[int] = None):
    """K3a: the recurrence over xi (T, B, 4H) from (h0, c0) (B, H) with Wh
    (H, 4H).  Returns h_all, c_all (T, B, H) and gates (T, B, 4H), in the
    streams' dtype (float32 or bfloat16, one for all four inputs).  On CUDA
    tensors ``cl`` (8 or 16) forces the cluster size; None takes
    :func:`lstm_fwd_plan`'s."""
    if xi.device.type == "cpu":
        return lstm_forward_plain(xi, Wh, h0, c0)
    T, B, H4 = xi.shape
    H = Wh.shape[0]
    dev, dt = xi.device, _stream_dtype(xi)
    cl, rows = lstm_fwd_plan(B, H, xi.element_size(), cl)
    if T < 1 or H4 != 4 * H:
        raise ValueError(f"xi has shape {tuple(xi.shape)}, expected (T >= 1, B, {4 * H})")
    for x, name, shape in ((xi, "xi", (T, B, H4)), (Wh, "Wh", (H, H4)),
                           (h0, "h0", (B, H)), (c0, "c0", (B, H))):
        _check(x, name, shape, dev, dt)
    lib = _library()
    h_all = torch.empty(T, B, H, device=dev, dtype=dt)
    c_all = torch.empty(T, B, H, device=dev, dtype=dt)
    gates = torch.empty(T, B, H4, device=dev, dtype=dt)
    err = lib.mmk_lstm_forward(
        xi.data_ptr(), Wh.data_ptr(), h0.data_ptr(), c0.data_ptr(), h_all.data_ptr(),
        c_all.data_ptr(), gates.data_ptr(), T, B, H, rows, cl, int(dt == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "LSTM forward kernel")
    _count(lstm_forward, dt)
    lstm_forward.last_cluster_size, lstm_forward.last_rows = cl, rows
    return h_all, c_all, gates


def fwd_clusters_that_fit(H: int, rows: int, cl: int, dtype: torch.dtype) -> int:
    """The clusters of ``cl`` blocks (``rows`` batch rows each) of the
    forward that the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    n = _library().mmk_lstm_fwd_clusters(H, rows, cl, int(dtype == torch.bfloat16))
    if n < 0:
        _raise_on(-n, "LSTM forward cluster query")
    return n


def bwd_clusters_that_fit(H: int, rows: int, cl: int, dtype: torch.dtype) -> int:
    """The clusters of ``cl`` blocks (``rows`` batch rows each) of the
    backward walk that the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    n = _library().mmk_lstm_bwd_clusters(H, rows, cl, int(dtype == torch.bfloat16))
    if n < 0:
        _raise_on(-n, "LSTM backward cluster query")
    return n


def lstm_backward(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh, cl=None):
    """K3b: the reverse-time walk and dWh.  Returns dxi (T, B, 4H), dWh
    (H, 4H), dh0 and dc0 (B, H), in the streams' dtype (one for all nine
    inputs).  On CUDA tensors ``cl`` (8 or 16) forces the walk's cluster
    size; None takes :func:`lstm_bwd_plan`'s."""
    if gates.device.type == "cpu":
        return lstm_backward_plain(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh)
    T, B, H = c_all.shape
    dev, dt = gates.device, _stream_dtype(gates)
    cl, rows = lstm_bwd_plan(B, H, gates.element_size(), cl)
    for x, name, shape in (
        (dh_all, "dh_all", (T, B, H)), (dh_T, "dh_T", (B, H)), (dc_T, "dc_T", (B, H)),
        (gates, "gates", (T, B, 4 * H)), (c_all, "c_all", (T, B, H)),
        (h_all, "h_all", (T, B, H)), (h0, "h0", (B, H)), (c0, "c0", (B, H)),
        (Wh, "Wh", (H, 4 * H)),
    ):
        _check(x, name, shape, dev, dt)
    lib = _library()
    dxi = torch.empty(T, B, 4 * H, device=dev, dtype=dt)
    dWh = torch.empty(H, 4 * H, device=dev, dtype=dt)
    dh0 = torch.empty(B, H, device=dev, dtype=dt)
    dc0 = torch.empty(B, H, device=dev, dtype=dt)
    splits = dwh_splits(T * B, H)
    # f32 partial tiles; f32 with one split writes dWh directly
    part = (torch.empty(splits, H, 4 * H, device=dev)
            if splits > 1 or dt != torch.float32 else dWh)
    err = lib.mmk_lstm_backward(
        dh_all.data_ptr(), dh_T.data_ptr(), dc_T.data_ptr(), gates.data_ptr(),
        c_all.data_ptr(), h_all.data_ptr(), h0.data_ptr(), c0.data_ptr(), Wh.data_ptr(),
        dxi.data_ptr(), dWh.data_ptr(), part.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        T, B, H, rows, cl, splits, int(dt == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "LSTM backward kernel")
    _count(lstm_backward, dt)
    lstm_backward.last_cluster_size, lstm_backward.last_rows = cl, rows
    return dxi, dWh, dh0, dc0


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its data is not 16-byte aligned (the wide
    forward copies h0's rows with the bulk copy engine)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def wide_clusters_that_fit(H: int, backward: bool, dtype: torch.dtype) -> int:
    """The clusters of WIDE_CL blocks of K3a-wide (K3b-wide's walk with
    ``backward``) at hidden size H that the current card holds at once
    (``cudaOccupancyMaxActiveClusters``, asked once a card, H, direction
    and dtype); a launch needs WIDE_BLOCKS / WIDE_CL of them."""
    key = (torch.cuda.current_device(), H, bool(backward), dtype)
    if key not in _Kernel.wide_clusters:
        n = _library().mmk_lstm_wide_clusters(H, int(backward), int(dtype == torch.bfloat16))
        if n < 0:
            _raise_on(-n, "wide LSTM cluster query")
        _Kernel.wide_clusters[key] = n
    return _Kernel.wide_clusters[key]


def _wide_resident(H: int, backward: bool, dtype: torch.dtype):
    """Raises where the card cannot hold all WIDE_BLOCKS blocks of a wide
    launch at once: its grid barriers would wait for blocks that never run."""
    n, need = wide_clusters_that_fit(H, backward, dtype), WIDE_BLOCKS // WIDE_CL
    if n < need:
        raise RuntimeError(
            f"K3{'b' if backward else 'a'}-wide at H={H} needs {need} clusters of {WIDE_CL}"
            f" blocks resident at once; this card holds {n}")


def lstm_forward_wide(xi: torch.Tensor, Wh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
    """K3a-wide: :func:`lstm_forward` for H past a cluster's shared memory
    (:func:`lstm_wide_plan`): the same outputs, on one cooperative launch of
    128 blocks in clusters of WIDE_CL."""
    if xi.device.type == "cpu":
        return lstm_forward_plain(xi, Wh, h0, c0)
    T, B, H4 = xi.shape
    H = Wh.shape[0]
    dev, dt = xi.device, _stream_dtype(xi)
    lstm_wide_plan(B, H, xi.element_size())
    if T < 1 or H4 != 4 * H:
        raise ValueError(f"xi has shape {tuple(xi.shape)}, expected (T >= 1, B, {4 * H})")
    for x, name, shape in ((xi, "xi", (T, B, H4)), (Wh, "Wh", (H, H4)),
                           (h0, "h0", (B, H)), (c0, "c0", (B, H))):
        _check(x, name, shape, dev, dt)
    lib = _library()
    h_all = torch.empty(T, B, H, device=dev, dtype=dt)
    c_all = torch.empty(T, B, H, device=dev, dtype=dt)
    gates = torch.empty(T, B, H4, device=dev, dtype=dt)
    _wide_resident(H, False, dt)
    cbuf = torch.empty(_wide_work(B, H, False), device=dev)
    err = lib.mmk_lstm_wide_forward(
        xi.data_ptr(), Wh.data_ptr(), _aligned(h0).data_ptr(), c0.data_ptr(), h_all.data_ptr(),
        c_all.data_ptr(), gates.data_ptr(), cbuf.data_ptr(), T, B, H,
        int(dt == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "wide LSTM forward kernel")
    _count(lstm_forward_wide, dt)
    return h_all, c_all, gates


def lstm_backward_wide(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh):
    """K3b-wide: :func:`lstm_backward` for H past a cluster's shared memory
    (:func:`lstm_wide_plan`): the walk on one cooperative launch of 128
    blocks in clusters of WIDE_CL, then the same dWh product."""
    if gates.device.type == "cpu":
        return lstm_backward_plain(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh)
    T, B, H = c_all.shape
    dev, dt = gates.device, _stream_dtype(gates)
    lstm_wide_plan(B, H, gates.element_size())
    for x, name, shape in (
        (dh_all, "dh_all", (T, B, H)), (dh_T, "dh_T", (B, H)), (dc_T, "dc_T", (B, H)),
        (gates, "gates", (T, B, 4 * H)), (c_all, "c_all", (T, B, H)),
        (h_all, "h_all", (T, B, H)), (h0, "h0", (B, H)), (c0, "c0", (B, H)),
        (Wh, "Wh", (H, 4 * H)),
    ):
        _check(x, name, shape, dev, dt)
    lib = _library()
    dxi = torch.empty(T, B, 4 * H, device=dev, dtype=dt)
    dWh = torch.empty(H, 4 * H, device=dev, dtype=dt)
    dh0 = torch.empty(B, H, device=dev, dtype=dt)
    dc0 = torch.empty(B, H, device=dev, dtype=dt)
    _wide_resident(H, True, dt)
    work = torch.empty(_wide_work(B, H, True), device=dev)
    splits = dwh_splits(T * B, H)
    part = (torch.empty(splits, H, 4 * H, device=dev)
            if splits > 1 or dt != torch.float32 else dWh)
    err = lib.mmk_lstm_wide_backward(
        dh_all.data_ptr(), dh_T.data_ptr(), dc_T.data_ptr(), gates.data_ptr(),
        c_all.data_ptr(), h_all.data_ptr(), h0.data_ptr(), c0.data_ptr(), Wh.data_ptr(),
        dxi.data_ptr(), dWh.data_ptr(), part.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        work.data_ptr(), T, B, H, splits, int(dt == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "wide LSTM backward kernel")
    _count(lstm_backward_wide, dt)
    return dxi, dWh, dh0, dc0


lstm_forward.launches = lstm_forward.launches_bf16 = 0
lstm_backward.launches = lstm_backward.launches_bf16 = 0
lstm_forward_wide.launches = lstm_forward_wide.launches_bf16 = 0
lstm_backward_wide.launches = lstm_backward_wide.launches_bf16 = 0
# the last launch's plan
lstm_forward.last_cluster_size = lstm_forward.last_rows = 0
lstm_backward.last_cluster_size = lstm_backward.last_rows = 0


# -- the layer ---------------------------------------------------------------------------

def _materialize(ct: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Outputs the loss does not use come back as None: zeros instead
    (``pallas_lstm.py:280-286``)."""
    return torch.zeros_like(like) if ct is None else ct.contiguous()


def _kernels(x: torch.Tensor, H: int, route: Optional[str]):
    """(forward, backward) wrappers of the layer: on CPU tensors the cluster
    wrappers, which run the plain versions whatever the route; on CUDA
    tensors those of ``route`` (:func:`lstm_route`'s, asked here where
    None), raising where it names no kernel."""
    if x.device.type == "cpu":
        return lstm_forward, lstm_backward
    if route is None:
        route = lstm_route(x.shape[1], x.shape[0], H, x.dtype)
    if route not in ("cluster", "wide"):
        raise ValueError(f"the LSTM kernels have no {route!r} route: LSTM.forward_seq runs a"
                         " step loop outside their gate")
    return ((lstm_forward, lstm_backward) if route == "cluster"
            else (lstm_forward_wide, lstm_backward_wide))


class _FusedLSTMLayer(torch.autograd.Function):
    """The layer with the kernels' backward (``pallas_lstm.py:239-289``).
    Its products outside the kernels take the streams' values in f32 and
    round their results once to the streams' dtype (bf16: ``xi`` after the
    bias, ``dx``, ``dWi`` and ``db``, as the Pallas layer's einsums with
    ``preferred_element_type=f32`` do; f32: the plain products)."""

    @staticmethod
    def forward(ctx, x, Wi, Wh, b, h0, c0, kernels):
        T, B, D = x.shape
        dt = x.dtype
        xi = torch.addmm(b.float(), x.reshape(T * B, D).float(), Wi.float())
        xi = xi.to(dt).reshape(T, B, -1)
        ctx.kernels = kernels
        h_all, c_all, gates = ctx.kernels[0](xi, Wh, h0, c0)
        ctx.save_for_backward(x, Wi, Wh, h0, c0, h_all, c_all, gates)
        ctx.set_materialize_grads(False)
        return h_all, h_all[-1].clone(), c_all[-1].clone()

    @staticmethod
    def backward(ctx, dh_all, dh_T, dc_T):
        x, Wi, Wh, h0, c0, h_all, c_all, gates = ctx.saved_tensors
        T, B, D = x.shape
        dt = x.dtype
        dxi, dWh, dh0, dc0 = ctx.kernels[1](
            _materialize(dh_all, h_all), _materialize(dh_T, h0), _materialize(dc_T, c0),
            gates, c_all, h_all, h0, c0, Wh,
        )
        dxi2 = dxi.reshape(T * B, -1).float()
        need = ctx.needs_input_grad
        dx = (dxi2 @ Wi.float().t()).to(dt).reshape(T, B, D) if need[0] else None
        dWi = (x.reshape(T * B, D).float().t() @ dxi2).to(dt) if need[1] else None
        db = dxi2.sum(0).to(dt) if need[3] else None
        return dx, dWi, dWh, db, dh0, dc0, None


def fused_lstm_layer(x: torch.Tensor, Wi: torch.Tensor, Wh: torch.Tensor, b: torch.Tensor,
                     h0: torch.Tensor, c0: torch.Tensor,
                     route: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """One LSTM layer over time.  x (T, B, D) time-major; Wi (D, 4H), Wh
    (H, 4H), b (4H,) in gate order i|f|g|o; h0, c0 (B, H).  Returns
    ``(h_all (T, B, H), h_T, c_T)``, differentiable in every argument.  On
    CUDA tensors the kernels run, or the call raises (outside their scope:
    see :func:`lstm_route`); on CPU tensors the plain versions run.

    The dtype follows ``x`` (``pallas_lstm.py:308``): bfloat16 runs the
    bf16-stream kernels; any other dtype runs the f32 kernels, and a float16
    ``x`` gets float16 outputs back.  Every argument is cast to the layer's
    dtype.  The kernels are those of ``route``, the layer's
    :func:`lstm_route` ("cluster" or "wide"; asked here where None, as
    ``LSTM.forward_seq`` has it already); a shape on the "scan" route raises
    on CUDA tensors."""
    if x.dim() != 3 or Wh.dim() != 2 or Wh.shape[1] != 4 * Wh.shape[0]:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, Wh {tuple(Wh.shape)}")
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    out = _FusedLSTMLayer.apply(
        *(a.to(dt).contiguous() for a in (x, Wi, Wh, b, h0, c0)),
        _kernels(x, Wh.shape[0], route),
    )
    if x.dtype == torch.float16:
        return tuple(o.to(x.dtype) for o in out)
    return out
