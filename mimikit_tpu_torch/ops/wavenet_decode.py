"""WaveNet decode: the hand-written CUDA kernel, its wrappers and its plain twin.

The kernel (``csrc/wavenet_decode.cu``) replaces the TPU kernels
``make_wavenet_pallas_decoder`` (K4, ``mimikit_tpu/ops/pallas_decode.py:402``)
and ``make_wavenet_pallas_chunked`` (K5, ``pallas_decode.py:559``).  Both
computed the same step; K5 only carried its state in and out.  Here one
state-carrying CUDA entry serves both, behind two counted wrappers:

* :func:`decode_single` — K4's route: builds the state from the prompt and
  runs the whole decode in one launch;
* :func:`decode_chunk` — K5's route: runs ``n_steps`` steps from absolute
  step ``t0`` on a caller-held :class:`WaveNetDecodeState`.

Semantics (``pallas_decode.py:448-526,682-783``): iteration t pushes the
sample at s = t-1 and predicts position t; each layer's ring slot ``s % d``
is read (the layer's input at s-d) before it is overwritten with the input
at s; rows before ``prior_t`` teacher-force and echo the prompt; the first
token carry is ``prompt[:, 0]`` and a decode starts at t = 1, from zero
rings.

What is not carried over from the JAX package: its VMEM arithmetic
(``WaveNet._pallas_mode``, ``_chunked_ring_split``, ``_chunk_for``) and its
batch split (``_pallas_batch_split``).  They fit rings and weights into a
TPU core's scoped VMEM and pick which rings stream from HBM by DMA; on the
card the rings live in device memory and the weights in L2 whatever the
width, so a net in the gate always takes the kernel.

A second kernel, ``csrc/wavenet_cluster.cu``, computes the same step with a
group of streams on a thread-block cluster, each block holding its column
slices of the weights in shared memory (:func:`cluster_plan`,
:func:`cluster_layout`).  Both wrappers send a CUDA batch where
:func:`route` names by B (``WN_CLUSTER_ROUTE``); nets outside the cluster
plan and the other batches take the block kernel, so every chunk of a stream
takes one kernel.

What bounds each kernel on an H100, and what its design does about it, is in
the source note at the top of its ``.cu`` file.

The wrappers' rule: a CPU tensor takes the plain PyTorch twin
(:func:`decode_plain`); a CUDA tensor launches the kernel or raises.  There is
no fallback.  The kernel is built with ``nvcc`` at first use into
``build/kernels/`` (see :mod:`.nvcc`) — nothing is compiled or imported when
this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses as dtc
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from .noise import gumbel_noise
from .nvcc import CSRC, build_library
from .temperature import Temperature, row_temperatures
from .samplernn_decode import SMEM_PER_BLOCK, _check, _head_is_plain_mish

__all__ = ["wavenet_weight_pack", "WaveNetPack", "WaveNetDecodeState", "cluster_plan",
           "cluster_layout", "route"]

MAX_LAYERS = 64
MAX_HEAD = 8
THREADS = 1024  # a block's threads, WN_THREADS in the .cu file
GROUPS = (1, 2, 4, 8, 16)  # the streams a block can own
SOURCE = CSRC / "wavenet_decode.cu"
CLUSTER_SOURCE = CSRC / "wavenet_cluster.cu"
CLUSTER_SIZES = (16,)  # the cluster kernel's instantiation (8 blocks never won: PERF.md)
RING_SLOTS = 3           # the ring of streamed weight pieces (6 streamed no faster)
SLOT_FLOATS = 4096       # 16 KB a piece
TAB_HEADER = 4
MAX_GROUP = 64           # the most streams a group a plan is searched for
# (the widest B, cluster size): where decode_single and decode_chunk send a
# CUDA batch to the cluster kernel (csrc/wavenet_cluster.cu), in order; past
# the last row, or for a net outside the plan, the block kernel.  From
# chip_smoke.py's route sweep of both kernels at B = 1 .. 256 on an NVIDIA
# H100 80GB HBM3 (700 W).
WN_CLUSTER_ROUTE = ((128, 16),)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _smem_per_stream(D: int, S: int, Q: int, head_dims, n_layers: int) -> Tuple[int, int, int]:
    """(bytes, ds, red): the shared memory one stream takes in a block, as the
    kernel lays it out — four rows of ``ds`` floats (the conv input, the
    products' outputs, the gate's output, the skips), ``red`` floats of
    split-K partial sums, each layer's ring row and the token — and the two
    strides."""
    ds = _round4(max(2 * D, S + D, Q + 1, *(d for dims in head_dims for d in dims)))
    widest = max(2 * D, S + D, *(o for _, o in head_dims))
    red = max(THREADS, -(-widest // 32) * 32)
    return 4 * (4 * ds + red + n_layers * _round4(D)) + 4, ds, red


# -- scope gate (pallas_decode.py:330-371) ---------------------------------------

def supports_kernel_decode(net) -> bool:
    """True for the standard gated WaveNet (``supports_pallas_wavenet``):
    kernel-2 dilated layers, Tanh x Sigmoid gates, skips, plain residuals,
    one embedding input and one learned-temperature plain-Mish MLP head, a
    categorical objective.  The port adds the kernel's own limits: at most
    ``MAX_LAYERS`` layers and ``MAX_HEAD`` head layers, and one stream's
    shared memory within a block's."""
    from ..features.functionals import Discrete
    from ..modules.io import EmbeddingIO, MLPIO

    cfg = net.config
    if cfg.dims_1x1 or cfg.groups != 1 or cfg.stride != 1:
        return False
    if cfg.with_affine_residuals or cfg.layerwise_inputs:
        return False
    if cfg.reverse_layer_order or cfg.tie_io_weights or not cfg.bias:
        return False
    if str(cfg.act_f) != "Tanh" or str(cfg.act_g) != "Sigmoid":
        return False
    if cfg.skips_dim is None or len(cfg.dims_dilated) != 1:
        return False
    if cfg.residuals_dim is not None and cfg.residuals_dim != cfg.dims_dilated[0]:
        return False
    layers = type(net).get_layers_cfg(cfg)
    if any(lc["kernel_size"] != 2 for lc in layers):
        return False
    io = cfg.io_spec
    if len(io.inputs) != 1 or len(io.targets) != 1:
        return False
    if not isinstance(io.inputs[0].elem_type, Discrete):
        return False
    if not isinstance(io.inputs[0].module, EmbeddingIO):
        return False
    t_mod = io.targets[0].module
    if not isinstance(t_mod, MLPIO) or t_mod.min_temperature is None:
        return False
    if not _head_is_plain_mish(t_mod):
        return False
    if str(io.targets[0].objective.objective_type) != "categorical_dist":
        return False
    D, S, Q = cfg.dims_dilated[0], cfg.skips_dim, io.targets[0].elem_type.size
    n_head = t_mod.n_hidden_layers + 2
    head = [(S, t_mod.hidden_dim)] + [(t_mod.hidden_dim,) * 2] * t_mod.n_hidden_layers
    head.append((t_mod.hidden_dim, Q + 1))
    return (
        len(layers) <= MAX_LAYERS
        and n_head <= MAX_HEAD
        and _smem_per_stream(D, S, Q, head, len(layers))[0] <= SMEM_PER_BLOCK
    )


# -- weight pack (pallas_decode.py:374-398) --------------------------------------

@dtc.dataclass
class WaveNetPack:
    """The kernel's view of a WaveNet: every weight in one flat f32 buffer,
    each tensor's (offset, shape) in it, and the static sizes the kernel
    reads."""

    flat: torch.Tensor
    offsets: dict
    dilations: Tuple[int, ...]
    has_res: Tuple[bool, ...]
    dim: int
    skips_dim: int
    q_levels: int
    head_dims: Tuple[Tuple[int, int], ...]
    min_temperature: float

    def view(self, name: str) -> torch.Tensor:
        off, shape = self.offsets[name]
        n = 1
        for s in shape:
            n *= s
        return self.flat[off : off + n].view(shape)


@torch.no_grad()
def wavenet_weight_pack(net) -> WaveNetPack:
    """Flatten ``net``'s weights into the kernel's layout, on ``net``'s device.

    ``emb`` (Q, D); per layer l: ``wc{l}`` = [K0; K1] (2D, 2D), the two taps
    of the kernel-2 dilated conv stacked so that ``[x(s-d) | x(s)] @ wc``
    is the conv, ``bc{l}`` (2D), ``wsr{l}`` = [W_skip | W_res] (D, S + D) —
    (D, S) on the last layer, which has no residual — and ``bsr{l}``; then
    the head chain ``wh{k}``/``bh{k}`` (the last layer emits Q+1 logits, the
    extra one being the learned temperature).  Each tensor starts at a
    multiple of 4 floats."""
    parts, offsets = [], {}
    pos = 0

    def add(name, x):
        nonlocal pos
        x = x.detach().to(torch.float32).contiguous()
        offsets[name] = (pos, tuple(x.shape))
        pad = -x.numel() % 4
        parts.append(x.reshape(-1))
        if pad:
            parts.append(x.new_zeros(pad))
        pos += x.numel() + pad

    add("emb", net.input_modules[0][0].weight)
    has_res = []
    for l, layer in enumerate(net.layers):
        conv = layer.conv_dil[0][0]
        add(f"wc{l}", torch.cat([conv.weight[:, :, 0].t(), conv.weight[:, :, 1].t()], 0))
        add(f"bc{l}", conv.bias)
        sr = [layer.conv_skip.weight[:, :, 0].t()]
        br = [layer.conv_skip.bias]
        if layer.has_residuals:
            sr.append(layer.conv_res.weight[:, :, 0].t())
            br.append(layer.conv_res.bias)
        add(f"wsr{l}", torch.cat(sr, 1))
        add(f"bsr{l}", torch.cat(br))
        has_res.append(layer.has_residuals)
    mlp = net.output_modules[0].estimator[0]
    linears = list(mlp.fc)[0::2]
    for k, lin in enumerate(linears):
        add(f"wh{k}", lin.weight.t())
        add(f"bh{k}", lin.bias)
    return WaveNetPack(
        flat=torch.cat(parts),
        offsets=offsets,
        dilations=tuple(layer.dilation for layer in net.layers),
        has_res=tuple(has_res),
        dim=net.config.dims_dilated[0],
        skips_dim=net.config.skips_dim,
        q_levels=linears[-1].out_features - 1,
        head_dims=tuple((lin.in_features, lin.out_features) for lin in linears),
        min_temperature=float(mlp.min_temperature),
    )


# -- decode state ----------------------------------------------------------------

@dtc.dataclass
class WaveNetDecodeState:
    """What a decode carries from step to step, for B streams: ``tok`` (B,)
    int32, the token at the position before the next step's; ``rings``
    (sum(d), B, D) f32, layer l's ring in rows ``ring_rows[l] ..
    ring_rows[l] + d_l`` (slot ``s % d_l`` holds the layer's input at the
    latest s with that remainder)."""

    tok: torch.Tensor
    rings: torch.Tensor
    dilations: Tuple[int, ...]

    @property
    def ring_rows(self) -> Tuple[int, ...]:
        rows, r = [], 0
        for d in self.dilations:
            rows.append(r)
            r += d
        return tuple(rows)

    def ring(self, l: int) -> torch.Tensor:
        r = self.ring_rows[l]
        return self.rings[r : r + self.dilations[l]]


def init_decode_state(pack: WaveNetPack, prompt: torch.Tensor) -> WaveNetDecodeState:
    """State before step 1: the carry is ``prompt[:, 0]``, the rings zero."""
    B = prompt.shape[0]
    return WaveNetDecodeState(
        tok=prompt[:, 0].to(torch.int32).clone(),  # a copy: the carry is written in place
        rings=torch.zeros(sum(pack.dilations), B, pack.dim, device=prompt.device),
        dilations=pack.dilations,
    )


# -- the plain twin ----------------------------------------------------------------

@torch.no_grad()
def decode_plain(pack: WaveNetPack, prompt: torch.Tensor, state: WaveNetDecodeState, t0: int,
                 n_steps: int, out_t0: int, out_len: int, seed: int,
                 temperature: Temperature, return_scores: bool = False):
    """The plain PyTorch twin of the kernel: ``n_steps`` steps from absolute
    step ``t0`` with the kernel's arithmetic, sampling rule and noise,
    teacher-forcing while ``t < prior_t``.  ``state`` is updated in place.
    Returns ``out`` (B, out_len) int32 holding the tokens of steps
    ``out_t0 ..``; with ``return_scores`` also the (n_steps, B, Q) scores the
    argmax ran over (tempered logits, plus noise when sampling)."""
    B, prior_t = prompt.shape
    D, S, Q = pack.dim, pack.skips_dim, pack.q_levels
    dev = prompt.device
    temps = row_temperatures(temperature, B, dev)
    prompt = prompt.to(torch.int64)
    emb = pack.view("emb")
    layers = [
        (state.ring(l), d, pack.view(f"wc{l}"), pack.view(f"bc{l}"), pack.view(f"wsr{l}"),
         pack.view(f"bsr{l}"), pack.has_res[l])
        for l, d in enumerate(pack.dilations)
    ]
    head = [(pack.view(f"wh{k}"), pack.view(f"bh{k}")) for k in range(len(pack.head_dims))]
    tok = state.tok.to(torch.int64)
    out = torch.zeros(B, out_len, dtype=torch.int32, device=dev)
    scores_all = []
    for i in range(n_steps):
        t = t0 + i
        s = t - 1
        x = emb[prompt[:, s] if s < prior_t else tok]
        skips = None
        for ring, d, wc, bc, wsr, bsr, res in layers:
            old = ring[s % d].clone()
            ring[s % d] = x
            fg = torch.addmm(bc, torch.cat([old, x], 1), wc)
            y = torch.tanh(fg[:, :D]) * torch.sigmoid(fg[:, D:])
            z = torch.addmm(bsr, y, wsr)
            skips = z[:, :S] if skips is None else skips + z[:, :S]
            x = x + z[:, S:] if res else y
        h = skips
        for k, (wh, bh) in enumerate(head):
            h = torch.addmm(bh, h, wh)
            if k < len(head) - 1:
                h = h * torch.tanh(F.softplus(h))
        scores = h[:, :Q] / torch.clamp_min(torch.sigmoid(h[:, Q : Q + 1]), pack.min_temperature)
        if temps is not None:
            scores = scores / temps.column() + gumbel_noise(seed, t, B, Q, dev)
        tok = prompt[:, t] if t < prior_t else torch.argmax(scores, dim=-1)
        if 0 <= t - out_t0 < out_len:
            out[:, t - out_t0] = tok.to(torch.int32)
        if return_scores:
            scores_all.append(scores)
    state.tok.copy_(tok)
    if return_scores:
        return out, torch.stack(scores_all)
    return out



# -- the cluster kernel's plan and layout ------------------------------------------

def _split(n: int, cl: int, r: int) -> Tuple[int, int]:
    """Rank r's share [lo, hi) of n items over cl ranks (wc_lo in the .cu)."""
    return r * n // cl, (r + 1) * n // cl


@dtc.dataclass(frozen=True)
class ClusterUnit:
    """One product of a step: ``K`` rows of the pack's (K, N) matrix ``src``
    (bias ``bias``); ``cols[r]`` the columns rank r computes, four a quad,
    -1 for a zero column; its input in two segments, ``ka`` rows and the
    rest."""

    name: str
    src: str
    bias: str
    K: int
    N: int
    cols: Tuple[Tuple[int, ...], ...]
    ka: int  # the first segment of K (the conv's x(s - d) rows; K elsewhere)


@dtc.dataclass(frozen=True)
class ClusterPlan:
    """Where each block of a cluster of ``cl`` keeps each weight slice of a
    step for groups of ``S`` streams, and its shared memory."""

    cl: int
    S: int
    units: Tuple[ClusterUnit, ...]
    resident: Tuple[Tuple[bool, ...], ...]
    small: Tuple[int, ...]   # each rank's bias floats
    ow: int
    skw: int
    lgw: int
    tab_ints: int
    act_floats: int
    wreg_floats: int
    smem_bytes: int
    fits: bool
    why: str

    def slice_floats(self, u: int, r: int) -> int:
        return self.units[u].K * len(self.units[u].cols[r])

    def bytes(self, r: int, resident: bool) -> int:
        """Rank r's weight bytes a step that are resident (or streamed)."""
        return 4 * sum(self.slice_floats(u, r) for u in range(len(self.units))
                       if self.resident[r][u] == resident)

    def pieces(self, r: int):
        """Rank r's streamed pieces of a step, in order: (unit, first quad,
        quads)."""
        out = []
        for u, unit in enumerate(self.units):
            q = len(unit.cols[r]) // 4
            if self.resident[r][u] or q == 0:
                continue
            per = max(1, SLOT_FLOATS // (4 * unit.K))
            out += [(u, q0, min(per, q - q0)) for q0 in range(0, q, per)]
        return out


Geometry = Tuple[int, int, int, Tuple[bool, ...], Tuple[Tuple[int, int], ...]]


def _geometry(pack: WaveNetPack) -> Geometry:
    return pack.dim, pack.skips_dim, pack.q_levels, tuple(pack.has_res), tuple(pack.head_dims)


def _units(g: Geometry, cl: int) -> Tuple[ClusterUnit, ...]:
    """Every product of a step, in the order the kernel runs them: each
    layer's gated conv (rank r's quads of gate units, a quad the tanh and
    sigmoid columns of units 2q and 2q + 1) and its skip|res product (its
    skip quads, then its residual quads; none on the last layer, whose x is
    not used), then the head's layers (the last: its quads of the Q logits,
    then the temperature column in a quad of its own, on every rank)."""
    D, Sk, Q, has_res, head = g
    L = len(has_res)

    def quads(n, r):
        lo, hi = _split(n, cl, r)
        return tuple(c for q in range(lo, hi) for c in range(4 * q, 4 * q + 4))

    units = []
    for l, res in enumerate(has_res):
        conv = tuple(tuple(c for q in range(*_split(D // 2, cl, r))
                           for c in (2 * q, D + 2 * q, 2 * q + 1, D + 2 * q + 1))
                     for r in range(cl))
        units.append(ClusterUnit(f"conv{l}", f"wc{l}", f"bc{l}", 2 * D, 2 * D, conv, D))
        keep = res and l + 1 < L
        sr = tuple(quads(Sk // 4, r) + (tuple(Sk + c for c in quads(D // 4, r)) if keep else ())
                   for r in range(cl))
        units.append(ClusterUnit(f"sr{l}", f"wsr{l}", f"bsr{l}", D, Sk + (D if res else 0), sr,
                                 D))
    for k, (d_in, d_out) in enumerate(head):
        if k + 1 < len(head):
            cols = tuple(quads(d_out // 4, r) for r in range(cl))
        else:
            cols = tuple(quads(Q // 4, r) + (Q, -1, -1, -1) for r in range(cl))
        units.append(ClusterUnit(f"h{k}", f"wh{k}", f"bh{k}", d_in, d_out, cols, d_in))
    return tuple(units)


def _act_floats(D: int, S: int, cl: int, ow: int, skw: int, lgw: int, tab_ints: int) -> int:
    """Floats of the buffers before the weights (``wc_carve``): x(s), y, the
    two ring-row and head buffers, the pick's candidates, the skip
    accumulators, the logits, the token carry, the table, the ring's
    barriers."""
    r4 = _round4
    return (2 * S * D + 2 * S * ow + r4(2 * cl * S) + S * skw + S * lgw + r4(S) + r4(tab_ints)
            + r4(2 * (RING_SLOTS + 1)))


@functools.lru_cache(maxsize=None)
def _plan(g: Geometry, cl: int, S: int) -> ClusterPlan:
    D, Sk, Q, has_res, head = g
    units = _units(g, cl)
    ow = _round4(max([D, Sk] + [w for dims in head[:-1] for w in dims] + [head[-1][0]]))
    skw = 4 * max(_split(Sk // 4, cl, r)[1] - _split(Sk // 4, cl, r)[0] for r in range(cl))
    lgw = 4 * (max(_split(Q // 4, cl, r)[1] - _split(Q // 4, cl, r)[0] for r in range(cl)) + 1)
    small = tuple(sum(len(u.cols[r]) for u in units) for r in range(cl))
    slices = [[u.K * len(u.cols[r]) for u in units] for r in range(cl)]
    # the table has room for every unit streamed: its size does not depend on the choice
    most_pieces = max(sum(-(-len(u.cols[r]) // 4 // max(1, SLOT_FLOATS // (4 * u.K)))
                          for u in units) for r in range(cl))
    tab_ints = TAB_HEADER + 3 * len(units) + 2 * most_pieces
    act = _act_floats(D, S, cl, ow, skw, lgw, tab_ints)
    budget = SMEM_PER_BLOCK // 4 - act - RING_SLOTS * SLOT_FLOATS
    # streamed first: the odd layers' convs, then the even ones', then the
    # skip|res products the same way, then the head, until the rest fits,
    # so that the streamed pieces spread over the step
    L = len(has_res)
    order = ([2 * l for l in range(1, L, 2)] + [2 * l for l in range(0, L, 2)]
             + [2 * l + 1 for l in range(1, L, 2)] + [2 * l + 1 for l in range(0, L, 2)]
             + list(range(2 * L, len(units))))
    resident = []
    for r in range(cl):
        row, over = [True] * len(units), small[r] + sum(slices[r]) - budget
        for u in order:
            if over > 0 and slices[r][u]:
                row[u] = False
                over -= slices[r][u]
        resident.append(tuple(row))
    wreg = _round4(max(small[r] + sum(f for f, k in zip(slices[r], resident[r]) if k)
                       for r in range(cl)))
    streams = not all(all(row) for row in resident)
    smem = 4 * (act + wreg + (RING_SLOTS * SLOT_FLOATS if streams else 0))
    why = ""
    if cl not in CLUSTER_SIZES:
        why = f"cluster size {cl} is not one of {CLUSTER_SIZES}"
    elif S < 1:
        why = f"a group of {S} streams"
    elif D % 8 or Sk % 4 or Q % 4 or any(w % 4 for dims in head[:-1] for w in dims):
        why = "the widths are not multiples of 8 (dims) and 4 (skips, classes, head)"
    elif L > MAX_LAYERS or len(head) > MAX_HEAD:
        why = f"{L} layers / {len(head)} head layers exceed the kernel's limits"
    elif any(4 * u.K > SLOT_FLOATS for u in units):
        why = "a product's depth outgrows a ring slot"
    elif min(budget - x for x in small) < 0 or smem > SMEM_PER_BLOCK:
        why = f"{smem} bytes of shared memory a block"
    return ClusterPlan(cl=cl, S=S, units=units, resident=tuple(resident), small=small, ow=ow,
                       skw=skw, lgw=lgw, tab_ints=tab_ints, act_floats=act, wreg_floats=wreg,
                       smem_bytes=smem, fits=not why, why=why)


def cluster_plan(pack: WaveNetPack, cl: int, S: int) -> ClusterPlan:
    """The cluster kernel's plan of ``pack``'s net on clusters of ``cl``
    blocks for groups of ``S`` streams, a pure function of its widths: each
    product's column slice a rank computes, whether it stays in the rank's
    shared memory or streams through the ring of ``RING_SLOTS`` pieces of
    ``SLOT_FLOATS`` (the odd layers' convs first, then the even ones', then
    the skip|res products, then the head, until the rest fits in 232,448
    bytes beside the group's rows), and ``why`` a net does not fit."""
    return _plan(_geometry(pack), cl, S)


def max_streams(pack: WaveNetPack, cl: int) -> int:
    """The most streams a group whose plan fits at ``cl`` blocks (0: none)."""
    S = 0
    while S < MAX_GROUP and cluster_plan(pack, cl, S + 1).fits:
        S += 1
    return S


def exchanges_per_step(pack: WaveNetPack) -> int:
    """The cluster barriers of a step: y after each layer, x after each
    residual but the last layer's, the skips, each hidden head layer, the
    pick."""
    L = len(pack.dilations)
    return L + sum(pack.has_res[:-1]) + 1 + len(pack.head_dims) - 1 + 1


def _k_order(K: int, ka: int) -> np.ndarray:
    """The k of each of a quad's K weight rows as the kernel reads them: the
    segments [0, ka) and [ka, K) in blocks of 128, in a block of nb the row
    of k = 4 l + e at e nb / 4 + l (lane l reads e's rows side by side)."""
    out = []
    for lo, hi in ((0, ka), (ka, K)):
        for k0 in range(lo, hi, 128):
            q4 = min(128, hi - k0) // 4
            out.append((k0 + 4 * np.arange(q4)[None, :] + np.arange(4)[:, None]).ravel())
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _layout_np(plan: ClusterPlan, offsets: dict, zero: int):
    """(index into the pack's flat weights, ``zero`` for a zero, of every
    float of the relaid buffer; (cl, tab_ints) int32 tables).  Rank r's
    region: each unit's bias slice, its resident slices, then its streamed
    pieces; a slice, and each piece (whole quads), is quad-major: a quad's K
    rows of four columns together, in :func:`_k_order`."""
    parts, tabs, base = [], np.zeros((plan.cl, plan.tab_ints), np.int32), 0

    def slice_idx(unit, cols, q0, nq):  # quads q0 .. q0 + nq: (nq, K, 4), k in _k_order
        o = offsets[unit.src][0]
        c = np.asarray(cols, np.int64)[4 * q0 : 4 * (q0 + nq)].reshape(nq, 1, 4)
        k = _k_order(unit.K, unit.ka)
        idx = o + k[None, :, None] * unit.N + c
        return np.where(c < 0, zero, idx).ravel()

    for r in range(plan.cl):
        idx, rows, pos = [], [], 0
        for unit in plan.units:
            c = np.asarray(unit.cols[r], np.int64)
            rows.append([0, pos, len(c) // 4])
            idx.append(np.where(c < 0, zero, offsets[unit.bias][0] + c))
            pos += len(c)
        for u, unit in enumerate(plan.units):
            if plan.resident[r][u]:
                rows[u][0] = pos
                idx.append(slice_idx(unit, unit.cols[r], 0, len(unit.cols[r]) // 4))
                pos += plan.slice_floats(u, r)
            else:
                rows[u][0] = -1
        n_load, pieces = pos, []
        for u, q0, nq in plan.pieces(r):
            unit = plan.units[u]
            pieces.append((pos, nq * 4 * unit.K))
            idx.append(slice_idx(unit, unit.cols[r], q0, nq))
            pos += nq * 4 * unit.K
        tab = [base, n_load, len(pieces), len(plan.units)] + sum(rows, []) + sum(
            (list(p) for p in pieces), [])
        tabs[r, : len(tab)] = tab
        region = np.concatenate(idx) if idx else np.zeros(0, np.int64)
        parts.append(np.concatenate([region, np.full(-len(region) % 4, zero, np.int64)]))
        base += len(parts[-1])
    return np.concatenate(parts), tabs


@functools.lru_cache(maxsize=8)
def _layout_index(g: Geometry, cl: int, S: int, offsets: Tuple, zero: int, device: str):
    """:func:`_layout_np`'s int32 index and tables on ``device``, kept for a
    few (widths, layout, group, device) keys."""
    idx, tabs = _layout_np(_plan(g, cl, S), {k: (o, s) for k, o, s in offsets}, zero)
    assert zero < 2 ** 31
    return (torch.from_numpy(idx.astype(np.int32)).to(device),
            torch.from_numpy(tabs).to(device))


def cluster_layout(pack: WaveNetPack, cl: int, S: int):
    """(relaid weights, tables, plan) of ``pack`` for the cluster kernel on
    clusters of ``cl`` blocks, groups of ``S`` streams, on the pack's device:
    one gather of the pack's flat weights (a zero appended), by an index
    cached for the net's widths and layout (``generate`` packs the weights
    anew each call), kept on the pack."""
    cache = pack.__dict__.setdefault("_cluster", {})
    if (cl, S) not in cache:
        offsets = tuple(sorted((k, o, tuple(s)) for k, (o, s) in pack.offsets.items()))
        idx, tabs = _layout_index(_geometry(pack), cl, S, offsets, pack.flat.numel(),
                                  str(pack.flat.device))
        flat = torch.cat([pack.flat, pack.flat.new_zeros(4)])
        cache[(cl, S)] = (flat.index_select(0, idx), tabs, cluster_plan(pack, cl, S))
    return cache[(cl, S)]


def route(pack: WaveNetPack, B: int) -> Optional[int]:
    """The cluster size :func:`decode_single` and :func:`decode_chunk` launch
    B streams of ``pack``'s net with (on CUDA tensors): the first
    ``WN_CLUSTER_ROUTE`` row that names B, where a group of one stream
    fits; None for the block kernel.  It depends on B and the widths only,
    so every chunk of a stream takes one kernel."""
    for most, cl in WN_CLUSTER_ROUTE:
        if B <= most and max_streams(pack, cl) > 0:
            return cl
    return None


def streams_a_group(pack: WaveNetPack, cl: int, B: int, clusters: int) -> int:
    """S: B streams spread over the clusters that fit, at most the plan's
    largest group (more groups then wait for a cluster)."""
    return max(1, min(max_streams(pack, cl), -(-B // clusters)))


# -- the kernels: build, bind, launch ------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``WnDecodeArgs`` in ``csrc/wavenet_decode.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("prompt", ctypes.c_void_p),
        ("tok", ctypes.c_void_p),
        ("rings", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("t0", ctypes.c_longlong),
        ("out_t0", ctypes.c_longlong),
        ("off_emb", ctypes.c_longlong),
        ("off_wc", ctypes.c_longlong * MAX_LAYERS),
        ("off_bc", ctypes.c_longlong * MAX_LAYERS),
        ("off_wsr", ctypes.c_longlong * MAX_LAYERS),
        ("off_bsr", ctypes.c_longlong * MAX_LAYERS),
        ("ring_row", ctypes.c_longlong * MAX_LAYERS),
        ("off_wh", ctypes.c_longlong * MAX_HEAD),
        ("off_bh", ctypes.c_longlong * MAX_HEAD),
        ("n_steps", ctypes.c_int),
        ("out_len", ctypes.c_int),
        ("B", ctypes.c_int),
        ("D", ctypes.c_int),
        ("S", ctypes.c_int),
        ("Q", ctypes.c_int),
        ("prior_t", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("n_head", ctypes.c_int),
        ("argmax", ctypes.c_int),
        ("group", ctypes.c_int),
        ("ds", ctypes.c_int),
        ("red", ctypes.c_int),
        ("seed", ctypes.c_uint),
        ("temperature", ctypes.c_void_p),
        ("min_temperature", ctypes.c_float),
        ("dil", ctypes.c_int * MAX_LAYERS),
        ("has_res", ctypes.c_int * MAX_LAYERS),
        ("head_in", ctypes.c_int * MAX_HEAD),
        ("head_out", ctypes.c_int * MAX_HEAD),
    ]


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_kernel() -> Path:
    """Compile ``csrc/wavenet_decode.cu`` for sm_90a into ``build/kernels/``
    (see :mod:`.nvcc`) and return the library's path."""
    path, log = build_library(SOURCE, "mmk_wavenet")
    if log:
        _Kernel.build_log = log
    return path


def _library():
    if _Kernel.lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        lib.mmk_wavenet_decode.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.mmk_wavenet_decode.restype = ctypes.c_int
        lib.mmk_wavenet_args_size.argtypes = []
        lib.mmk_wavenet_args_size.restype = ctypes.c_int
        lib.mmk_wavenet_error_string.argtypes = [ctypes.c_int]
        lib.mmk_wavenet_error_string.restype = ctypes.c_char_p
        if lib.mmk_wavenet_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("WnDecodeArgs layout differs between C and Python")
        _Kernel.lib = lib
    return _Kernel.lib


def group_for(pack: WaveNetPack, B: int, device) -> int:
    """Streams per block: the fewest of ``GROUPS`` that keep the grid within
    one block per SM and whose shared memory fits a block (the same rule as
    the SampleRNN kernel's; ``chip_smoke.py --bench`` times each group)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = _smem_per_stream(pack.dim, pack.skips_dim, pack.q_levels, pack.head_dims,
                           len(pack.dilations))[0]
    g = 1
    while g < GROUPS[-1] and -(-B // g) > sms and 2 * g * per <= SMEM_PER_BLOCK:
        g *= 2
    return g


def _launch(pack: WaveNetPack, prompt, state: WaveNetDecodeState, t0: int, n_steps: int,
            out: torch.Tensor, out_t0: int, seed: int, temperature: Temperature,
            group: Optional[int] = None) -> bool:
    """Launch the kernel on ``state`` and ``out``; False when there are no
    steps to run (nothing is launched)."""
    dev = pack.flat.device
    if dev.type != "cuda":
        raise ValueError(f"the decode kernel runs on CUDA tensors, got {dev}")
    B, prior_t = prompt.shape
    D, S, Q = pack.dim, pack.skips_dim, pack.q_levels
    L, n_head = len(pack.dilations), len(pack.head_dims)
    _check(pack.flat, "weights", torch.float32, pack.flat.shape, dev)
    _check(prompt, "prompt", torch.int32, (B, prior_t), dev)
    _check(state.tok, "state.tok", torch.int32, (B,), dev)
    _check(state.rings, "state.rings", torch.float32, (sum(pack.dilations), B, D), dev)
    _check(out, "out", torch.int32, (B, out.shape[1]), dev)
    if prior_t < 1 or t0 < 1 or n_steps < 0:
        raise ValueError("empty prompt, t0 below 1 or negative step count")
    if L > MAX_LAYERS or n_head > MAX_HEAD:
        raise ValueError(f"{L} layers / {n_head} head layers exceed the kernel's limits")
    temps = row_temperatures(temperature, B, dev)
    group = group or group_for(pack, B, dev)
    per, ds, red = _smem_per_stream(D, S, Q, pack.head_dims, L)
    if group not in GROUPS or group * per > SMEM_PER_BLOCK:
        raise ValueError(f"group {group} is not one of {GROUPS} or does not fit a block")
    if n_steps == 0:
        return False
    lib = _library()
    a = _Args()
    a.w, a.prompt, a.tok = pack.flat.data_ptr(), prompt.data_ptr(), state.tok.data_ptr()
    a.rings, a.out = state.rings.data_ptr(), out.data_ptr()
    a.t0, a.out_t0, a.off_emb = t0, out_t0, pack.offsets["emb"][0]
    for l, (d, r, row) in enumerate(zip(pack.dilations, pack.has_res, state.ring_rows)):
        a.off_wc[l], a.off_bc[l] = pack.offsets[f"wc{l}"][0], pack.offsets[f"bc{l}"][0]
        a.off_wsr[l], a.off_bsr[l] = pack.offsets[f"wsr{l}"][0], pack.offsets[f"bsr{l}"][0]
        a.ring_row[l], a.dil[l], a.has_res[l] = row, d, int(r)
    for k, (d_in, d_out) in enumerate(pack.head_dims):
        a.off_wh[k], a.off_bh[k] = pack.offsets[f"wh{k}"][0], pack.offsets[f"bh{k}"][0]
        a.head_in[k], a.head_out[k] = d_in, d_out
    a.n_steps, a.out_len, a.B, a.D, a.S, a.Q = n_steps, out.shape[1], B, D, S, Q
    a.prior_t, a.n_layers, a.n_head = prior_t, L, n_head
    a.argmax, a.group = int(temps is None), group
    a.ds, a.red = ds, red
    a.seed = seed & 0xFFFFFFFF
    a.temperature = None if temps is None else temps.tensor.data_ptr()
    a.min_temperature = pack.min_temperature
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mmk_wavenet_decode(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(
            f"wavenet decode kernel launch failed: {lib.mmk_wavenet_error_string(err).decode()}"
        )
    return True


class _ClArgs(ctypes.Structure):
    """Mirror of ``WcArgs`` in ``csrc/wavenet_cluster.cu``."""

    _fields_ = [
        ("cw", ctypes.c_void_p),
        ("tab", ctypes.c_void_p),
        ("emb", ctypes.c_void_p),
        ("prompt", ctypes.c_void_p),
        ("tok", ctypes.c_void_p),
        ("rings", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("barriers", ctypes.c_void_p),
        ("t0", ctypes.c_longlong),
        ("out_t0", ctypes.c_longlong),
        ("ring_row", ctypes.c_longlong * MAX_LAYERS),
        ("n_steps", ctypes.c_int),
        ("out_len", ctypes.c_int),
        ("B", ctypes.c_int),
        ("D", ctypes.c_int),
        ("Sk", ctypes.c_int),
        ("Q", ctypes.c_int),
        ("prior_t", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("n_head", ctypes.c_int),
        ("S", ctypes.c_int),
        ("ow", ctypes.c_int),
        ("skw", ctypes.c_int),
        ("lgw", ctypes.c_int),
        ("tab_ints", ctypes.c_int),
        ("wreg_floats", ctypes.c_int),
        ("n_slots", ctypes.c_int),
        ("slot_floats", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("argmax", ctypes.c_int),
        ("seed", ctypes.c_uint),
        ("temperature", ctypes.c_void_p),
        ("min_temperature", ctypes.c_float),
        ("dil", ctypes.c_int * MAX_LAYERS),
        ("has_res", ctypes.c_int * MAX_LAYERS),
        ("head_in", ctypes.c_int * MAX_HEAD),
        ("head_out", ctypes.c_int * MAX_HEAD),
    ]


class _ClusterKernel:
    """The cluster kernel's library (one per process), its compiler output
    and the clusters that fit, by (device, cluster size, shared memory)."""

    lib = None
    build_log = ""
    clusters = {}


def build_cluster_kernel() -> Path:
    """Compile ``csrc/wavenet_cluster.cu`` for sm_90a into ``build/kernels/``
    and return the library's path."""
    path, log = build_library(CLUSTER_SOURCE, "mmk_wavenet_cluster")
    if log:
        _ClusterKernel.build_log = log
    return path


def _cluster_library():
    if _ClusterKernel.lib is None:
        lib = ctypes.CDLL(str(build_cluster_kernel()))
        lib.mmk_wc_decode.argtypes = [ctypes.POINTER(_ClArgs), ctypes.c_int, ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.mmk_wc_decode.restype = ctypes.c_int
        lib.mmk_wc_args_size.argtypes = []
        lib.mmk_wc_args_size.restype = ctypes.c_int
        lib.mmk_wc_error_string.argtypes = [ctypes.c_int]
        lib.mmk_wc_error_string.restype = ctypes.c_char_p
        if lib.mmk_wc_args_size() != ctypes.sizeof(_ClArgs):
            raise RuntimeError("WcArgs layout differs between C and Python")
        _ClusterKernel.lib = lib
    return _ClusterKernel.lib


def _fill_cluster_args(a: _ClArgs, pack: WaveNetPack, plan: ClusterPlan) -> None:
    rows = 0
    for l, (d, r) in enumerate(zip(pack.dilations, pack.has_res)):
        a.ring_row[l], a.dil[l], a.has_res[l] = rows, d, int(r)
        rows += d
    for k, (d_in, d_out) in enumerate(pack.head_dims):
        a.head_in[k], a.head_out[k] = d_in, d_out
    a.D, a.Sk, a.Q = pack.dim, pack.skips_dim, pack.q_levels
    a.n_layers, a.n_head = len(pack.dilations), len(pack.head_dims)
    a.S, a.ow, a.skw, a.lgw = plan.S, plan.ow, plan.skw, plan.lgw
    a.tab_ints, a.wreg_floats, a.smem_bytes = plan.tab_ints, plan.wreg_floats, plan.smem_bytes
    a.n_slots, a.slot_floats = RING_SLOTS, SLOT_FLOATS
    a.min_temperature = pack.min_temperature


def clusters_that_fit(pack: WaveNetPack, cl: int) -> int:
    """The clusters of ``cl`` blocks the card runs at once at the cluster
    kernel's shared memory for the largest group
    (``cudaOccupancyMaxActiveClusters``), cached."""
    dev = pack.flat.device
    plan = cluster_plan(pack, cl, max(1, max_streams(pack, cl)))
    key = (str(dev), cl, plan.smem_bytes)
    if key not in _ClusterKernel.clusters:
        a = _ClArgs()
        _fill_cluster_args(a, pack, plan)
        n = ctypes.c_int(0)
        lib = _cluster_library()
        err = lib.mmk_wc_decode(ctypes.byref(a), cl, torch.cuda.current_stream(dev).cuda_stream,
                                ctypes.byref(n), 1)
        if err != 0:
            raise RuntimeError(f"wavenet cluster kernel query failed: "
                               f"{lib.mmk_wc_error_string(err).decode()}")
        _ClusterKernel.clusters[key] = n.value
    return _ClusterKernel.clusters[key]


def _launch_cluster(pack: WaveNetPack, prompt, state: WaveNetDecodeState, t0: int,
                    n_steps: int, out: torch.Tensor, out_t0: int, seed: int,
                    temperature: Temperature, cl: int, S: Optional[int] = None,
                    record=None) -> bool:
    """The cluster kernel on clusters of ``cl`` blocks, groups of ``S``
    streams (default: :func:`streams_a_group` over the clusters that fit);
    False when there are no steps to run.  ``record`` (a wrapper) gets the
    launch's ``last_barriers``, ``last_clusters``, ``last_cluster_size`` and
    ``last_streams``."""
    dev = pack.flat.device
    if dev.type != "cuda":
        raise ValueError(f"the cluster decode kernel runs on CUDA tensors, got {dev}")
    B, prior_t = prompt.shape
    D = pack.dim
    _check(pack.flat, "weights", torch.float32, pack.flat.shape, dev)
    _check(prompt, "prompt", torch.int32, (B, prior_t), dev)
    _check(state.tok, "state.tok", torch.int32, (B,), dev)
    _check(state.rings, "state.rings", torch.float32, (sum(pack.dilations), B, D), dev)
    _check(out, "out", torch.int32, (B, out.shape[1]), dev)
    if prior_t < 1 or t0 < 1 or n_steps < 0:
        raise ValueError("empty prompt, t0 below 1 or negative step count")
    temps = row_temperatures(temperature, B, dev)
    if S is None:
        S = streams_a_group(pack, cl, B, clusters_that_fit(pack, cl))
    cw, tabs, plan = cluster_layout(pack, cl, S)
    if not plan.fits:
        raise ValueError(f"the net is outside the cluster kernel's plan at {cl} blocks and {S}"
                         f" streams a group: {plan.why}")
    if n_steps == 0 or B == 0:
        return False
    lib = _cluster_library()
    a = _ClArgs()
    _fill_cluster_args(a, pack, plan)
    barriers = torch.zeros(1, dtype=torch.int64, device=dev)
    a.cw, a.tab = cw.data_ptr(), tabs.data_ptr()
    a.emb = pack.flat.data_ptr() + 4 * pack.offsets["emb"][0]
    a.prompt, a.tok, a.rings = prompt.data_ptr(), state.tok.data_ptr(), state.rings.data_ptr()
    a.out, a.barriers = out.data_ptr(), barriers.data_ptr()
    a.t0, a.out_t0, a.n_steps, a.out_len = t0, out_t0, n_steps, out.shape[1]
    a.B, a.prior_t = B, prior_t
    a.argmax = int(temps is None)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = None if temps is None else temps.tensor.data_ptr()
    clusters = ctypes.c_int(0)
    err = lib.mmk_wc_decode(ctypes.byref(a), cl, torch.cuda.current_stream(dev).cuda_stream,
                            ctypes.byref(clusters), 0)
    if err != 0:
        raise RuntimeError("wavenet cluster decode kernel launch failed: "
                           f"{lib.mmk_wc_error_string(err).decode()}")
    if record is not None:
        record.last_barriers, record.last_clusters = barriers, clusters.value
        record.last_cluster_size, record.last_streams = cl, S
    return True


def _kernel_for(pack: WaveNetPack, B: int, cl: Optional[int]) -> int:
    """0 for the block kernel, else the cluster size: ``cl`` when given (0
    forces the block kernel), else :func:`route`'s."""
    if cl is None:
        cl = route(pack, B)
    return cl or 0


def decode_single(pack: WaveNetPack, prompt: torch.Tensor, n_steps: int, seed: int,
                  temperature: Temperature, group: Optional[int] = None,
                  cl: Optional[int] = None) -> torch.Tensor:
    """K4's route: decode ``n_steps`` tokens after ``prompt`` (B, prior_t) in
    one launch, from zero rings.  Returns (B, n_steps) int32.  A CUDA batch
    takes the kernel :func:`route` names (``cl`` overrides it: 0 the block
    kernel, 16 the cluster kernel on clusters of 16)."""
    B, prior_t = prompt.shape
    temperature = row_temperatures(temperature, B, prompt.device)
    state = init_decode_state(pack, prompt)
    n = prior_t + n_steps - 1
    if prompt.device.type == "cpu":
        return decode_plain(pack, prompt, state, 1, n, prior_t, n_steps, seed, temperature)
    out = torch.empty(B, n_steps, dtype=torch.int32, device=prompt.device)
    prompt = prompt.to(torch.int32).contiguous()
    size = _kernel_for(pack, B, cl)
    if size:
        if _launch_cluster(pack, prompt, state, 1, n, out, prior_t, seed, temperature, size,
                           record=decode_single):
            decode_single.launches += 1
            decode_single.launches_cluster += 1
    elif _launch(pack, prompt, state, 1, n, out, prior_t, seed, temperature, group):
        decode_single.launches += 1
    return out


def decode_chunk(pack: WaveNetPack, prompt: torch.Tensor, state: WaveNetDecodeState, t0: int,
                 n_steps: int, seed: int, temperature: Temperature,
                 group: Optional[int] = None, cl: Optional[int] = None) -> torch.Tensor:
    """K5's route: run steps ``t0 .. t0+n_steps-1`` on ``state`` (updated in
    place).  Returns the chunk's tokens, (B, n_steps) int32: column j holds
    position ``t0 + j`` (the prompt's token where ``t0 + j < prior_t``).  A
    CUDA batch takes the kernel :func:`route` names (``cl`` as
    :func:`decode_single`'s)."""
    B = prompt.shape[0]
    temperature = row_temperatures(temperature, B, prompt.device)
    if prompt.device.type == "cpu":
        return decode_plain(pack, prompt, state, t0, n_steps, t0, n_steps, seed, temperature)
    out = torch.empty(B, n_steps, dtype=torch.int32, device=prompt.device)
    size = _kernel_for(pack, B, cl)
    if size:
        if _launch_cluster(pack, prompt, state, t0, n_steps, out, t0, seed, temperature, size,
                           record=decode_chunk):
            decode_chunk.launches += 1
            decode_chunk.launches_cluster += 1
    elif _launch(pack, prompt, state, t0, n_steps, out, t0, seed, temperature, group):
        decode_chunk.launches += 1
    return out


decode_single.launches = 0  # both kernels' launches
decode_chunk.launches = 0
decode_single.launches_cluster = 0  # the cluster kernel's
decode_chunk.launches_cluster = 0
# the last cluster launch of each wrapper: the cluster barriers block 0 passed
# in its first group's steps (a (1,) device tensor), the clusters that fitted,
# their size and the streams a group
for _w in (decode_single, decode_chunk):
    _w.last_barriers, _w.last_clusters, _w.last_cluster_size, _w.last_streams = None, 0, 0, 0
