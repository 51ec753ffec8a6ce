"""JukeBox tier-pyramid decode: three CUDA kernels, their wrapper and their plain twin.

The kernels replace the TPU kernel
``make_jukebox_pallas_decoder`` (K8, ``mimikit_tpu/ops/pallas_decode.py:2386``,
gate ``supports_pallas_jukebox`` ``:2227``, pack ``jukebox_weight_pack``
``:2286``): the whole autoregressive loop in one launch.  Each step reads
the (B, W) lead window — the last W - 1 tokens and a never-read placeholder
for the position being predicted — linearises it as (tok / Q - 0.5) * 2 and,
for each upper tier i of frame size f: frames the span
``[fs0 - f, W - f)`` into n_i frames, runs the framed dense, adds the tier
above's up-sampled rows and the frame-relative PE, then the post-norm
decoder layers (causal self-attention, causal cross-attention on the tier's
PE'd input, a Mish or ReLU FFN, three layer norms), tanh and the linear
up-sampler; the bottom tier's framed conv reads the last fs_b real tokens
(window slots W - 1 - fs_b .. W - 2) plus the last up-sampled row; the Mish
head divides its logits by max(sigmoid(extra logit), min_temperature), then
by the temperature plus Gumbel noise when sampling; the argmax token fills
the placeholder and the window moves on by one.

Three kernels compute that step, on the same pack, window and noise:

* the cluster kernel (``csrc/jukebox_cluster.cu``): one stream on a
  thread-block cluster of 8 or 16 blocks, each holding its slice
  of every product's weights in its shared memory (:func:`cluster_plan`,
  laid out by :func:`cluster_layout`), the activations exchanged through
  distributed shared memory;
* the group kernel (``csrc/jukebox_group.cu``): a group of S streams on a
  cluster of 4, 8 or 16 blocks, the same slices (:func:`group_plan`, whose
  activations grow with S), each product and exchange shared by the group;
* the block kernel (``csrc/jukebox_decode.cu``): one stream a block, the
  weights read from L2.

:func:`decode_pyramid` routes a CUDA window (:func:`route`) of at most
``_K8_CLUSTER_MAX_B`` streams, of a net whose plan fits, to the cluster
kernel (clusters of 16 blocks up to 7 streams, of 8 up to 15:
``K8_CLUSTER_ROUTE``), wider ones up to ``K8_GROUP_ROUTE``'s limit (60) to
the group kernel (clusters of 8, S from the clusters that fit:
:func:`streams_a_group`), wider batches to the block kernel: by B and the
widths alone, so a stream keeps one kernel.

This module holds:

* :func:`supports_kernel_decode`, the scope gate (``supports_pallas_jukebox``
  plus the block kernel's own limits);
* :func:`jukebox_weight_pack`, the kernel's view of the weights;
* :func:`lead_window`, the (B, W) window of a padded prompt;
* :func:`pyramid_scores` (a batch of windows at once, for teacher forcing)
  and :func:`decode_pyramid_plain`, the plain twin;
* :func:`cluster_plan`, :func:`group_plan`, :func:`cluster_layout` and
  :func:`group_layout`, the cluster and group kernels' residency plans and
  their relaid weights;
* :func:`decode_pyramid`, the counted wrapper (``launches``, every kernel;
  ``launches_cluster`` and ``launches_group``, those two kernels'), which
  leaves the advanced window in place, so a stream carries it from one
  launch to the next.

Not carried over: the per-row bias tiling of ``jukebox_weight_pack``
(``pallas_decode.py:2289-2307``), which works around a Mosaic layout rule,
and the ``pltpu.roll`` framing and frame-major row order (``:2417-2423,
2536-2559``), Mosaic layout choices; the kernel's rows are a stream's frames
in order.  What bounds each kernel on an H100, and what its design does
about it, is in the source note of its ``.cu`` file.  The wrapper's rule: a
CPU tensor takes the plain twin, a CUDA tensor launches a kernel or raises;
there is no fallback.  Each kernel is built with ``nvcc`` at first use into
``build/kernels/`` (:mod:`.nvcc`), as a library of its own; nothing is
compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses as dtc
import functools
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .noise import gumbel_noise
from .nvcc import CSRC, build_library
from .samplernn_decode import SMEM_PER_BLOCK, _check, _head_is_plain_mish
from .transformer_decode import LAYER_KINDS, _attend_causal, layer_norm

__all__ = ["jukebox_weight_pack", "JukeBoxPack"]

THREADS = 512  # a block's threads, JB_THREADS in the .cu
MAX_TIERS = 4  # upper tiers, JB_MAX_TIERS
MAX_HEAD = 8  # head layers, JB_MAX_HEAD
MAX_ROWS = 8  # rows one pass of a product keeps in registers, JB_MAXR
MAX_COLS = 2048  # columns of the widest product, JB_MAXN
SOURCE = CSRC / "jukebox_decode.cu"
# decode_pyramid's route (chip_smoke.py's jukebox_route_sweep times both kernels,
# at both cluster sizes, at B = 1 .. 64): (the most streams, the cluster size) in
# order, the first that admits B and whose plan fits the net; beyond the last,
# the block kernel.  A cluster decodes one stream at a time: 7 clusters of 16
# blocks fit on an H100 at jukebox3's shared memory, 15 of 8.
K8_CLUSTER_ROUTE = ((7, 16), (15, 8))
_K8_CLUSTER_MAX_B = K8_CLUSTER_ROUTE[-1][0]
# past it, the group kernel's route (a group of streams a cluster,
# csrc/jukebox_group.cu), (the most streams, the cluster size) in order, the first
# that admits B and where a group of one stream fits; beyond the last, the block
# kernel.  From the same sweep, which times the group kernel at each cluster size:
# on an H100 at jukebox3's widths groups of up to 4 streams on the 15 clusters of 8
# that fit (B <= 60) beat the block kernel, groups of 5 lose to it
K8_GROUP_ROUTE = ((60, 8),)


def _r4(n: int) -> int:
    return -(-n // 4) * 4


# -- scope gate (pallas_decode.py:2227-2283) -------------------------------------

def _geometry(cfg, W: int):
    """(frame sizes, frames of each upper tier, up-sampling of each)."""
    fs = tuple(int(f) for f in cfg.frame_sizes)
    span = W - fs[0]
    n_frames = tuple(span // f for f in fs[:-1])
    t_up = tuple(f // (fs[i + 1] if i < len(fs) - 2 else 1) for i, f in enumerate(fs[:-1]))
    return fs, n_frames, t_up


def smem_floats(W: int, rows: int, d: int, ff: int, L: int, head_width: int) -> int:
    """A block's dynamic shared memory in floats (``jb_smem_floats`` in the
    ``.cu``): the products' partial sums, the window and its linearised
    values, a tier's activations for ``rows`` frames, the head's rows."""
    return (MAX_ROWS * MAX_COLS + 2 * _r4(W) + rows * (8 * d + 2 * L * d + ff)
            + 2 * _r4(max(d, head_width)) + 2 * (THREADS // 32))


def supports_kernel_decode(net) -> bool:
    """True for the standard JukeBox that the kernel decodes: the nets
    :func:`_standard_jukebox` admits, within the kernel's own limits
    (:func:`_fits`).  A standard net beyond those limits (at jukebox3's
    widths, a window of more than 384 tokens: tier 1's frames then outgrow a
    block's shared memory) takes the window re-feed route, 50 to 65 times
    slower a step on an H100 at those widths (``chip_smoke.py`` times both
    routes); a warning says so, once for each net shape."""
    if not _standard_jukebox(net):
        return False
    cfg = net.config
    W = net._window_len()
    _, n_frames, t_up = _geometry(cfg, W)
    t_mod = cfg.io_spec.targets[0].module
    head_dims = [(cfg.model_dim, t_mod.hidden_dim)] + [(t_mod.hidden_dim, t_mod.hidden_dim)] * (
        t_mod.n_hidden_layers) + [(t_mod.hidden_dim, _r4(cfg.io_spec.targets[0].elem_type.size + 1))]
    if (t_mod.hidden_dim % 4 == 0 and cfg.positional_encoding >= max(n_frames)
            and _fits(W, cfg.model_dim, cfg.feedforward_dim, cfg.num_layers, n_frames, t_up,
                      head_dims)):
        return True
    warnings.warn(
        f"this JukeBox (window {W}, model_dim {cfg.model_dim}, feedforward_dim "
        f"{cfg.feedforward_dim}, head width {t_mod.hidden_dim}, frames {n_frames}) is outside the "
        "tier-pyramid kernel's limits (see ops.jukebox_decode.supports_kernel_decode): it decodes "
        "through the window re-feed route, one forward a step", stacklevel=2)
    return False


def _standard_jukebox(net) -> bool:
    """The scope of the TPU kernel's gate: framed-linear mu-law inputs, Mish
    or ReLU post-norm tier blocks with sinusoidal PE, linear up-samplers, the
    framed-conv bottom tier and one learned-temperature plain-Mish MLP head
    with a categorical objective; no ``ref_compat`` (its Conv1dResampler
    scramble), weight norm, final norm, pre-norm or dropout."""
    from ..features.functionals import Discrete
    from ..modules.io import FramedLinearIO, MLPIO

    if type(net).__name__ != "JukeBox":
        return False
    cfg = net.config
    if cfg.ref_compat or cfg.weight_norm or cfg.with_layer_norm or cfg.norm_first or cfg.dropout:
        return False
    if cfg.positional_encoding is None or str(cfg.layer_activation) not in ("Mish", "ReLU"):
        return False
    if cfg.model_dim % cfg.n_heads or len(cfg.frame_sizes) < 2:
        return False
    fs, _, _ = _geometry(cfg, net._window_len())
    span = net._window_len() - fs[0]
    if span <= 0:
        return False
    for i, f in enumerate(fs[:-1]):
        if span % f or f % (fs[i + 1] if i < len(fs) - 2 else 1):
            return False
    io = cfg.io_spec
    if len(io.inputs) != 1 or len(io.targets) != 1:
        return False
    if not isinstance(io.inputs[0].elem_type, Discrete):
        return False
    if not isinstance(io.inputs[0].module, FramedLinearIO):
        return False
    act = getattr(io.inputs[0].module, "activation", None)
    if act is not None and str(getattr(act, "act", "Identity")) != "Identity":
        return False
    t_mod = io.targets[0].module
    if not isinstance(t_mod, MLPIO) or t_mod.min_temperature is None:
        return False
    if not _head_is_plain_mish(t_mod) or getattr(t_mod, "weight_norm", False):
        return False
    return str(getattr(io.targets[0].objective, "objective_type", "")) == "categorical_dist"


def _fits(W: int, d: int, ff: int, L: int, n_frames, t_up, head_dims) -> bool:
    """The kernel's own limits: ``model_dim``, ``feedforward_dim`` (and the
    head's hidden width, checked by the gate) multiples of 4 (16-byte
    loads); at most ``MAX_TIERS`` upper tiers and ``MAX_HEAD`` head layers;
    every product at most ``MAX_COLS`` columns (3d, 2·layers·d, ff, each
    inner up-sampler's t·d, the head's widths); a block's shared memory
    (:func:`smem_floats`).  The gate adds a PE table of at least each
    tier's frames."""
    head_width = max(w for dims in head_dims for w in dims)
    widths = [3 * d, 2 * L * d, ff, head_width] + [t * d for t in t_up[:-1]]
    return (d % 4 == 0 and ff % 4 == 0 and len(n_frames) <= MAX_TIERS
            and len(head_dims) <= MAX_HEAD and max(widths) <= MAX_COLS
            and 4 * smem_floats(W, max(n_frames), d, ff, L, head_width) <= SMEM_PER_BLOCK)


# -- weight pack -------------------------------------------------------------------

@dtc.dataclass
class JukeBoxPack:
    """The kernel's view of a JukeBox: every weight in one flat f32 buffer
    and each tensor's (offset, shape) in it, with the static sizes.  Upper
    tier i's tensors are ``win.i``/``bin.i`` (framed dense, (f, d)),
    ``pe.i`` (its n_i frames' PE rows), layer l's ``<kind>.i.l``
    (``LAYER_KINDS``, ``layer_strides[i]`` floats after layer l - 1's),
    ``wckv.i``/``bckv.i`` (every layer's cross [Wk | Wv], (d, 2Ld)),
    ``wup.i``/``bup.i`` (the up-sampler, (d, t·d)); then the bottom conv
    ``wbot`` (fs_b, d), ``bbot``, and the head ``wh{k}``/``bh{k}``, the last
    layer's columns padded with zeros to a multiple of 4."""

    flat: torch.Tensor
    offsets: dict
    dim: int
    n_heads: int
    ff: int
    n_layers: int
    window: int
    frames: Tuple[int, ...]
    n_frames: Tuple[int, ...]
    t_up: Tuple[int, ...]
    q_levels: int
    head_dims: Tuple[Tuple[int, int], ...]
    min_temperature: float
    mish_ffn: bool
    layer_strides: Tuple[int, ...]

    @property
    def n_up(self) -> int:
        return len(self.frames) - 1

    def view(self, name: str) -> torch.Tensor:
        off, shape = self.offsets[name]
        n = int(np.prod(shape))
        return self.flat[off : off + n].view(shape)

    def layer(self, i: int, l: int):
        """Tier i's layer l's tensors in ``LAYER_KINDS`` order."""
        return [self.view(f"{k}.{i}.{l}") for k in LAYER_KINDS]


@torch.no_grad()
def jukebox_weight_pack(net) -> JukeBoxPack:
    """Flatten ``net``'s weights into the kernel's layout, on its device.
    Every product is ``x @ W`` (K, N) row-major; each tensor starts at a
    multiple of 4 floats."""
    from ..networks.transformers import sinusoidal_pe

    cfg = net.config
    d, L, W = cfg.model_dim, cfg.num_layers, net._window_len()
    fs, n_frames, t_up = _geometry(cfg, W)
    pe = torch.from_numpy(sinusoidal_pe(cfg.positional_encoding, d))
    parts, offsets, pos = [], {}, 0

    def add(name, x):
        nonlocal pos
        x = x.detach().to(torch.float32).contiguous()
        offsets[name] = (pos, tuple(x.shape))
        pad = -x.numel() % 4
        parts.append(x.reshape(-1))
        if pad:
            parts.append(x.new_zeros(pad))
        pos += x.numel() + pad

    strides = []
    for i, tier in enumerate(net.tiers[:-1]):
        dense = tier.input_module.heads[0][2]
        add(f"win.{i}", dense.weight.t())
        add(f"bin.{i}", dense.bias)
        add(f"pe.{i}", pe[: n_frames[i]].to(net.device))
        ckv_w, ckv_b = [], []
        for l, layer in enumerate(tier.model.layers):
            sa, ca = layer.self_attn, layer.multihead_attn
            for k, x in zip(LAYER_KINDS, (
                    sa.in_proj_weight.t(), sa.in_proj_bias, sa.out_proj.weight.t(), sa.out_proj.bias,
                    ca.in_proj_weight[:d].t(), ca.in_proj_bias[:d], ca.out_proj.weight.t(),
                    ca.out_proj.bias, layer.norm1.weight, layer.norm1.bias, layer.norm2.weight,
                    layer.norm2.bias, layer.norm3.weight, layer.norm3.bias,
                    layer.linear1.weight.t(), layer.linear1.bias, layer.linear2.weight.t(),
                    layer.linear2.bias)):
                add(f"{k}.{i}.{l}", x)
            ckv_w.append(ca.in_proj_weight[d:].t())  # (d, 2d): [Wk | Wv]
            ckv_b.append(ca.in_proj_bias[d:])
        stride = offsets[f"wqkv.{i}.1"][0] - offsets[f"wqkv.{i}.0"][0] if L > 1 else 0
        for l in range(1, L):  # every layer lies one stride after the one before
            for k in LAYER_KINDS:
                assert offsets[f"{k}.{i}.{l}"][0] == offsets[f"{k}.{i}.0"][0] + l * stride
        strides.append(stride)
        add(f"wckv.{i}", torch.cat(ckv_w, 1))
        add(f"bckv.{i}", torch.cat(ckv_b))
        add(f"wup.{i}", tier.up_sampler.fc.weight.t())
        add(f"bup.{i}", tier.up_sampler.fc.bias)
    conv = net.tiers[-1].input_module.heads[0][2][2].cv  # (d, 1, fs_b)
    add("wbot", conv.weight[:, 0, :].t())
    add("bbot", conv.bias)
    mlp = net.output_modules[0].estimator[0]
    linears = list(mlp.fc)[0::2]
    head_dims = []
    for k, lin in enumerate(linears):
        wt, b = lin.weight.t(), lin.bias
        out = _r4(lin.out_features)
        if out != lin.out_features:
            wt = F.pad(wt, (0, out - lin.out_features))
            b = F.pad(b, (0, out - lin.out_features))
        add(f"wh{k}", wt)
        add(f"bh{k}", b)
        head_dims.append((lin.in_features, out))
    return JukeBoxPack(
        flat=torch.cat(parts), offsets=offsets, dim=d, n_heads=cfg.n_heads,
        ff=cfg.feedforward_dim, n_layers=L, window=W, frames=fs, n_frames=n_frames, t_up=t_up,
        q_levels=linears[-1].out_features - 1, head_dims=tuple(head_dims),
        min_temperature=float(mlp.min_temperature),
        mish_ffn=str(cfg.layer_activation) == "Mish", layer_strides=tuple(strides),
    )


def lead_window(x: torch.Tensor, W: int) -> torch.Tensor:
    """The (B, W) int32 lead window after the tokens ``x`` (B, T >= W - 1):
    the last W - 1 tokens, then the never-read placeholder slot for the
    position being predicted (``_lead_window``, ``transformers.py:943-953``)."""
    tail = x[:, x.shape[1] - (W - 1):].to(torch.int32)
    return torch.cat([tail, tail.new_zeros(x.shape[0], 1)], 1).contiguous()


# -- the plain twin ----------------------------------------------------------------

def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _head(pack: JukeBoxPack, x: torch.Tensor) -> torch.Tensor:
    """(N, d) bottom rows -> (N, Q) scores: the Mish MLP, logits[:Q] /
    max(sigmoid(logits[Q]), min_temperature)."""
    n = len(pack.head_dims)
    for k in range(n):
        x = torch.addmm(pack.view(f"bh{k}"), x, pack.view(f"wh{k}"))
        if k < n - 1:
            x = _mish(x)
    Q = pack.q_levels
    return x[:, :Q] / torch.clamp_min(torch.sigmoid(x[:, Q : Q + 1]), pack.min_temperature)


@torch.no_grad()
def pyramid_scores(pack: JukeBoxPack, win: torch.Tensor) -> torch.Tensor:
    """The K8 step without its sampling: (N, W) lead windows -> (N, Q)
    scores of the position each window's placeholder stands for."""
    N, W = win.shape
    d, nH = pack.dim, pack.n_heads
    act = _mish if pack.mish_ffn else torch.relu
    lin = (win.to(torch.float32) / pack.q_levels - 0.5) * 2
    fs0 = pack.frames[0]
    x_up = None
    for i in range(pack.n_up):
        f, n, t = pack.frames[i], pack.n_frames[i], pack.t_up[i]
        frames = lin[:, fs0 - f : fs0 - f + n * f].reshape(N, n, f)
        x = torch.matmul(frames, pack.view(f"win.{i}")) + pack.view(f"bin.{i}")
        if x_up is not None:
            x = x + x_up
        x = x + pack.view(f"pe.{i}")
        mkv = torch.matmul(x, pack.view(f"wckv.{i}")) + pack.view(f"bckv.{i}")
        for l in range(pack.n_layers):
            (wqkv, bqkv, wo, bo, wcq, bcq, wco, bco,
             g1, b1_, g2, b2_, g3, b3_, w1, b1, w2, b2) = pack.layer(i, l)
            qkv = torch.matmul(x, wqkv) + bqkv
            a = _attend_causal(qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], nH)
            x = layer_norm(x + (torch.matmul(a, wo) + bo), g1, b1_)
            q = torch.matmul(x, wcq) + bcq
            kv = mkv[..., 2 * l * d : 2 * (l + 1) * d]
            a = _attend_causal(q, kv[..., :d], kv[..., d:], nH)
            x = layer_norm(x + (torch.matmul(a, wco) + bco), g2, b2_)
            h = act(torch.matmul(x, w1) + b1)
            x = layer_norm(x + (torch.matmul(h, w2) + b2), g3, b3_)
        x = torch.tanh(x)
        wup, bup = pack.view(f"wup.{i}"), pack.view(f"bup.{i}")
        if i < pack.n_up - 1:  # next-tier frame m is chunk m % t of frame m // t
            x_up = (torch.matmul(x, wup) + bup).reshape(N, n * t, d)
        else:  # the bottom reads the last chunk of the last frame only
            x_up = torch.addmm(bup[(t - 1) * d :], x[:, -1], wup[:, (t - 1) * d :])
    fb = pack.frames[-1]
    bot = torch.addmm(pack.view("bbot"), lin[:, W - 1 - fb : W - 1], pack.view("wbot")) + x_up
    return _head(pack, bot)


@torch.no_grad()
def decode_pyramid_plain(pack: JukeBoxPack, window: torch.Tensor, t0: int, n_steps: int,
                         seed: int, temperature: Optional[float]) -> torch.Tensor:
    """The plain PyTorch twin of the kernel: ``n_steps`` tokens from the
    (B, W) lead ``window``, the first at absolute position ``t0``; sampling
    adds the noise of (seed, position, stream, class).  Advances ``window``
    in place.  Returns (B, n_steps) int32."""
    B, W = window.shape
    out = torch.zeros(B, n_steps, dtype=torch.int32, device=window.device)
    for i in range(n_steps):
        s = pyramid_scores(pack, window)
        if temperature is not None:
            s = s / temperature + gumbel_noise(seed, t0 + i, B, pack.q_levels, window.device)
        tok = torch.argmax(s, dim=-1).to(torch.int32)
        out[:, i] = tok
        window.copy_(torch.cat([window[:, 1 : W - 1], tok[:, None], torch.zeros_like(tok)[:, None]],
                               1))
    return out


# -- the cluster kernel's residency plan --------------------------------------------

CLUSTER_SOURCE = CSRC / "jukebox_cluster.cu"
CLUSTER_SIZES = (8, 16)  # the cluster sizes jukebox_cluster.cu instantiates
GROUP_SOURCE = CSRC / "jukebox_group.cu"
GROUP_SIZES = (4, 8, 16)  # the cluster sizes jukebox_group.cu instantiates
GROUP_SLOT_FLOATS = 4096  # the group kernel's ring slot (16 KB: half the pieces of 8 KB)
K8_CLUSTER_SIZE = 16  # the size a launch takes when none is named (a single stream's)
RING_SLOTS = 4  # JC ring: streamed pieces in flight
SLOT_FLOATS = 2048  # floats a ring slot holds (8 KB)
TAB_HEADER = 4  # ints before a rank's unit table: base, loaded floats, pieces, units
RED_FLOATS = 4096  # a product's partial sums (JC_RED)
# the order in which kinds of product stream when a block's slices outgrow its
# shared memory: every layer's q|k|v first, then the FFN's, ..., so that the
# streamed pieces spread over the step and each copy is issued stages ahead
STREAM_ORDER = ("qkv", "w1", "w2", "ckv", "wo", "co", "cq", "up", "fd", "h0", "h1", "h2", "h3",
                "h4", "h5", "h6", "h7", "bot")


Geometry = Tuple  # (d, n_heads, ff, layers, W, Q, frames, n_frames, t_up, head_dims)


def geometry(pack: JukeBoxPack) -> Geometry:
    """The widths a residency plan depends on, as a hashable tuple."""
    return (pack.dim, pack.n_heads, pack.ff, pack.n_layers, pack.window, pack.q_levels,
            tuple(pack.frames), tuple(pack.n_frames), tuple(pack.t_up),
            tuple(tuple(x) for x in pack.head_dims))


@dtc.dataclass(frozen=True)
class ClusterUnit:
    """One product of a step as the cluster splits it: ``src`` (K, N) in the
    pack, its bias ``bias`` (and, for a framed dense, the PE rows ``pe``),
    and for each rank the pack columns of its slice, in the order the
    kernel writes them (a multiple of 4; possibly none)."""

    name: str
    src: str
    bias: str
    K: int
    N: int
    cols: Tuple[Tuple[int, ...], ...]
    pe: Optional[str] = None
    pe_rows: int = 0


@dtc.dataclass(frozen=True)
class ClusterPlan:
    """Where each rank of a cluster of ``cl`` blocks keeps its slice of each
    product (:func:`cluster_plan`).  ``resident[r][u]``: unit u's slice lies
    in rank r's shared memory for the whole launch, else it streams through
    the ring, in pieces of whole column quads of at most ``SLOT_FLOATS``.
    ``small[r]``: floats of its layer norms, biases and PE rows (always
    resident); ``act_floats``: the activations, scratch, table and barriers,
    laid out alike in every block, for ``S`` streams a cluster (the group
    kernel's; 1 for the cluster kernel); ``smem_bytes``: one block's dynamic
    shared memory; ``fits`` False (with ``why``) where the kernel cannot run
    the net at this cluster size and group."""

    cl: int
    units: Tuple[ClusterUnit, ...]
    resident: Tuple[Tuple[bool, ...], ...]
    small: Tuple[int, ...]
    ymax: int
    tab_ints: int
    act_floats: int
    wreg_floats: int
    smem_bytes: int
    fits: bool
    why: str = ""
    S: int = 1
    slot_floats: int = SLOT_FLOATS

    def slice_floats(self, u: int, r: int) -> int:
        unit = self.units[u]
        return unit.K * len(unit.cols[r])

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
            per = max(1, self.slot_floats // (4 * unit.K))
            out += [(u, q0, min(per, q - q0)) for q0 in range(0, q, per)]
        return out


def _split(n: int, cl: int, r: int) -> Tuple[int, int]:
    """Rank r's share [lo, hi) of n items over cl ranks (jc_split in the .cu)."""
    return r * n // cl, (r + 1) * n // cl


def _heads(nH: int, cl: int, r: int) -> Tuple[int, int, int, int]:
    """(first head, heads, ranks a head, this rank's part of the head's rows)
    of rank r: heads are whole within a block; with more ranks than heads,
    cl / nH ranks share a head and split its query rows."""
    hpr, rph = max(1, nH // cl), max(1, cl // nH)
    return (r // rph) * hpr, hpr, rph, r % rph


def _units(g: Geometry, cl: int) -> Tuple[ClusterUnit, ...]:
    """Every product of a step, in the order the kernel runs them."""
    d, nH, ff, L, W, Q, fs, n_frames, t_up, head_dims = g
    dH = d // nH
    rng = lambda lo, hi: tuple(range(lo, hi))  # noqa: E731

    def quads(n):  # rank r's columns of an n-column output split in quads
        return tuple(rng(4 * _split(n // 4, cl, r)[0], 4 * _split(n // 4, cl, r)[1])
                     for r in range(cl))

    def heads(offsets):  # rank r's head columns at each offset
        out = []
        for r in range(cl):
            h0, hpr, _, _ = _heads(nH, cl, r)
            out.append(sum((rng(o + h0 * dH, o + (h0 + hpr) * dH) for o in offsets), ()))
        return tuple(out)

    dcols, n_up = quads(d), len(fs) - 1
    units = []
    for i in range(n_up):
        units.append(ClusterUnit(f"fd.{i}", f"win.{i}", f"bin.{i}", fs[i], d, dcols, f"pe.{i}",
                                 n_frames[i]))
        if i > 0:
            t = t_up[i - 1]
            cols = tuple(sum((tuple(c * d + x for x in dcols[r]) for c in range(t)), ())
                         for r in range(cl))
            units.append(ClusterUnit(f"up.{i - 1}", f"wup.{i - 1}", f"bup.{i - 1}", d, t * d,
                                     cols))
        for l in range(L):
            if l == 0:
                for l2 in range(L):
                    units.append(ClusterUnit(f"ckv.{i}.{l2}", f"wckv.{i}", f"bckv.{i}", d,
                                             2 * L * d, heads((2 * l2 * d, (2 * l2 + 1) * d))))
            lay = lambda k: f"{k}.{i}.{l}"  # noqa: E731
            units += [
                ClusterUnit(lay("qkv"), lay("wqkv"), lay("bqkv"), d, 3 * d,
                            heads((0, d, 2 * d))),
                ClusterUnit(lay("wo"), lay("wo"), lay("bo"), d, d, dcols),
                ClusterUnit(lay("cq"), lay("wcq"), lay("bcq"), d, d, heads((0,))),
                ClusterUnit(lay("co"), lay("wco"), lay("bco"), d, d, dcols),
                ClusterUnit(lay("w1"), lay("w1"), lay("b1"), d, ff, quads(ff)),
                ClusterUnit(lay("w2"), lay("w2"), lay("b2"), ff, d, dcols),
            ]
    t = t_up[-1]
    units.append(ClusterUnit("bot", "wbot", "bbot", fs[-1], d, dcols))
    units.append(ClusterUnit(f"up.{n_up - 1}", f"wup.{n_up - 1}", f"bup.{n_up - 1}", d, t * d,
                             tuple(tuple((t - 1) * d + x for x in dcols[r]) for r in range(cl))))
    for k, (k_in, k_out) in enumerate(head_dims):
        units.append(ClusterUnit(f"h{k}", f"wh{k}", f"bh{k}", k_in, k_out, quads(k_out)))
    return tuple(units)


def act_floats(g: Geometry, cl: int, ymax: int, tab_ints: int, S: int = 1) -> int:
    """Floats of the buffers laid out alike in every block (``jc_carve``,
    and ``jg_carve`` for a group of S streams): the exchanged rows (x0, h,
    att, ffh, two head rows), the local ones (normed rows, the block's q|k|v
    and every layer's cross k|v, two product outputs), the window, each for
    every stream of the group; the partial sums, the argmax's partials, the
    unit table and the ring's barriers."""
    d, nH, ff, L, W, Q, fs, n_frames, t_up, head_dims = g
    R = max(n_frames)
    _, hpr, _, _ = _heads(nH, cl, 0)
    dHo = hpr * (d // nH)
    hw = _r4(max([d] + [w for dims in head_dims for w in dims]))
    per_stream = (4 * R * d + R * ff + 2 * hw + R * 3 * dHo + R * 2 * L * dHo + 2 * R * ymax
                  + 2 * _r4(W))
    return S * per_stream + RED_FLOATS + 32 + _r4(tab_ints) + _r4(2 * (RING_SLOTS + 1))


@functools.lru_cache(maxsize=None)
def _plan(g: Geometry, cl: int, S: int = 1, sizes: Tuple[int, ...] = CLUSTER_SIZES,
          slot_floats: int = SLOT_FLOATS) -> ClusterPlan:
    d, nH, ff, L, W, Q, fs, n_frames, t_up, head_dims = g
    units = _units(g, cl) if nH % cl == 0 or cl % nH == 0 else ()
    n_up, dH = len(fs) - 1, d // nH
    small = []
    for r in range(cl):
        s = n_up * L * 3 * 2 * d
        for unit in units:
            s += len(unit.cols[r]) * (1 + unit.pe_rows)
        small.append(s)
    ymax = max((len(c) for unit in units for c in unit.cols), default=4)
    slices = [[unit.K * len(unit.cols[r]) for unit in units] for r in range(cl)]
    # the table has room for every unit streamed: its size may not depend on the choice
    most_pieces = max((sum(-(-len(unit.cols[r]) // 4 // max(1, slot_floats // (4 * unit.K)))
                           for unit in units) for r in range(cl)), default=0)
    tab_ints = TAB_HEADER + 3 * len(units) + 2 * most_pieces
    act = act_floats(g, cl, ymax, tab_ints, S)
    budget = SMEM_PER_BLOCK // 4 - act - RING_SLOTS * slot_floats
    resident = []
    for r in range(cl):
        row, over = [True] * len(units), small[r] + sum(slices[r]) - budget
        for kind in STREAM_ORDER:  # stream kind by kind, each in step order, until the rest fits
            for u, unit in enumerate(units):
                if over > 0 and unit.name.split(".")[0] == kind and slices[r][u]:
                    row[u] = False
                    over -= slices[r][u]
        resident.append(tuple(row))
    wreg = _r4(max((small[r] + sum(f for f, k in zip(slices[r], resident[r]) if k)
                    for r in range(cl)), default=0))
    smem = 4 * (act + wreg + RING_SLOTS * slot_floats)
    why = ""
    if cl not in sizes:
        why = f"cluster size {cl} is not one of {sizes}"
    elif S < 1:
        why = f"a group of {S} streams"
    elif not units:
        why = f"{nH} heads do not divide among {cl} blocks, nor {cl} blocks among them"
    elif dH % 4:
        why = f"a head's width {dH} is not a multiple of 4"
    elif any(4 * unit.K > slot_floats for unit in units):
        why = "a product's depth outgrows a ring slot"
    elif max(n_frames) > 32 or MAX_ROWS * ymax > RED_FLOATS:
        why = "a tier's frames outgrow a warp's attention, or a slice the partial sums"
    elif min(budget - s for s in small) < 0 or smem > SMEM_PER_BLOCK:
        why = f"{smem} bytes of shared memory a block"
    return ClusterPlan(cl=cl, units=units, resident=tuple(resident), small=tuple(small),
                       ymax=ymax, tab_ints=tab_ints, act_floats=act, wreg_floats=wreg,
                       smem_bytes=smem, fits=not why, why=why, S=S, slot_floats=slot_floats)


def cluster_plan(pack: JukeBoxPack, cl: Optional[int] = None) -> ClusterPlan:
    """The residency plan of ``pack``'s net on a cluster of ``cl`` blocks, a
    pure function of its widths and ``cl``: for every product of a step, in
    step order, each rank's column slice (whole heads for q|k|v, the cross
    q and the cross k|v; an even share of column quads for the rest), its
    bytes, and whether it stays in the rank's shared memory (first fit in
    232,448 bytes less the activations, the table and a ring of
    ``RING_SLOTS`` x ``SLOT_FLOATS``) or streams through the ring; what
    streams is chosen kind by kind in ``STREAM_ORDER`` (every layer's q|k|v
    first), each kind in step order, until the rest fits, so that the
    streamed pieces spread over the step.  ``cl`` defaults to
    ``K8_CLUSTER_SIZE``."""
    return _plan(geometry(pack), cl or K8_CLUSTER_SIZE)


def _layout_np(plan: ClusterPlan, g: Geometry, offsets: Tuple):
    """(index into the pack's flat weights of every float of the relaid
    buffer, (cl, tab_ints) int32 tables).  Rank r's region: its layer norms
    (tier, layer, norm: scale then offset), each unit's bias slice (a framed
    dense's PE rows after it), its resident slices, then its streamed pieces;
    a resident slice, and each piece of a streamed one (whole column quads),
    is k-major: row k's columns together."""
    d, nH, ff, L, W, Q, fs, n_frames, t_up, head_dims = g
    off = dict((name, (o, shape)) for name, o, shape in offsets)
    n_up = len(fs) - 1
    parts, tabs, base = [], np.zeros((plan.cl, plan.tab_ints), np.int32), 0

    def slice_idx(unit, cols, q0, nq):  # quads q0 .. q0 + nq of the slice, k-major
        o, _ = off[unit.src]
        c = np.asarray(cols, np.int64)[4 * q0 : 4 * (q0 + nq)]
        return (o + np.arange(unit.K)[:, None] * unit.N + c[None, :]).ravel()

    for r in range(plan.cl):
        idx = [off[f"{k}_{x}.{i}.{l}"][0] + np.arange(d) for i in range(n_up) for l in range(L)
               for k in ("ln1", "ln2", "ln3") for x in ("w", "b")]
        pos, rows = n_up * L * 6 * d, []
        for u, unit in enumerate(plan.units):
            cols = np.asarray(unit.cols[r], np.int64)
            rows.append([0, pos, len(cols) // 4])
            idx.append(off[unit.bias][0] + cols)
            pos += len(cols)
            if unit.pe is not None:
                pe = off[unit.pe][0] + np.arange(unit.pe_rows)[:, None] * d + cols
                idx.append(pe.ravel())
                pos += unit.pe_rows * len(cols)
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
        parts.append(np.concatenate([region, np.zeros(-len(region) % 4, np.int64)]))
        base += len(parts[-1])
    return np.concatenate(parts), tabs


@functools.lru_cache(maxsize=16)
def _layout_cached(g: Geometry, cl: int, offsets: Tuple, S: int, sizes: Tuple[int, ...],
                   slot_floats: int):
    return _layout_np(_plan(g, cl, S, sizes, slot_floats), g, offsets)


_LAYOUT_ON_DEVICE = {}


def _relaid(pack: JukeBoxPack, cl: int, S: int, sizes: Tuple[int, ...], slot: int):
    """(relaid weights, tables, plan) of ``pack`` for a plan's arguments, on
    the pack's device: one gather of the pack's flat weights, by an index
    cached for the net's widths and layout; kept on the pack."""
    cache = pack.__dict__.setdefault("_cluster", {})
    if (cl, S, sizes, slot) not in cache:
        g = geometry(pack)
        offsets = tuple(sorted((k, o, tuple(s)) for k, (o, s) in pack.offsets.items()))
        key = (g, cl, S, sizes, slot, offsets, str(pack.flat.device))
        if key not in _LAYOUT_ON_DEVICE:
            idx, tabs = _layout_cached(g, cl, offsets, S, sizes, slot)
            _LAYOUT_ON_DEVICE[key] = (torch.from_numpy(idx).to(pack.flat.device),
                                      torch.from_numpy(tabs).to(pack.flat.device))
        idx, tabs = _LAYOUT_ON_DEVICE[key]
        cache[(cl, S, sizes, slot)] = (pack.flat.index_select(0, idx), tabs,
                                       _plan(g, cl, S, sizes, slot))
    return cache[(cl, S, sizes, slot)]


def cluster_layout(pack: JukeBoxPack, cl: Optional[int] = None):
    """(relaid weights, tables, plan) of ``pack`` for the cluster kernel on
    clusters of ``cl`` blocks (default ``K8_CLUSTER_SIZE``)."""
    return _relaid(pack, cl or K8_CLUSTER_SIZE, 1, CLUSTER_SIZES, SLOT_FLOATS)


def group_layout(pack: JukeBoxPack, cl: int, S: int):
    """(relaid weights, tables, plan) of ``pack`` for the group kernel on
    clusters of ``cl`` blocks, groups of ``S`` streams (:func:`group_plan`)."""
    return _relaid(pack, cl, S, GROUP_SIZES, GROUP_SLOT_FLOATS)


# -- the kernel: build, bind, launch -------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``JbArgs`` in ``csrc/jukebox_decode.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("window", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("off_in_w", ctypes.c_longlong * MAX_TIERS),
        ("off_in_b", ctypes.c_longlong * MAX_TIERS),
        ("off_pe", ctypes.c_longlong * MAX_TIERS),
        ("off_ckv_w", ctypes.c_longlong * MAX_TIERS),
        ("off_ckv_b", ctypes.c_longlong * MAX_TIERS),
        ("off_up_w", ctypes.c_longlong * MAX_TIERS),
        ("off_up_b", ctypes.c_longlong * MAX_TIERS),
        ("off_layer", (ctypes.c_longlong * len(LAYER_KINDS)) * MAX_TIERS),
        ("layer_stride", ctypes.c_longlong * MAX_TIERS),
        ("off_bot_w", ctypes.c_longlong),
        ("off_bot_b", ctypes.c_longlong),
        ("off_wh", ctypes.c_longlong * MAX_HEAD),
        ("off_bh", ctypes.c_longlong * MAX_HEAD),
        ("t0", ctypes.c_longlong),
        ("frame", ctypes.c_int * (MAX_TIERS + 1)),
        ("n_frames", ctypes.c_int * MAX_TIERS),
        ("t_up", ctypes.c_int * MAX_TIERS),
        ("head_in", ctypes.c_int * MAX_HEAD),
        ("head_out", ctypes.c_int * MAX_HEAD),
        ("n_up", ctypes.c_int),
        ("B", ctypes.c_int),
        ("n_steps", ctypes.c_int),
        ("W", ctypes.c_int),
        ("d", ctypes.c_int),
        ("n_heads", ctypes.c_int),
        ("ff", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("Q", ctypes.c_int),
        ("n_head", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("head_width", ctypes.c_int),
        ("mish_ffn", ctypes.c_int),
        ("argmax", ctypes.c_int),
        ("seed", ctypes.c_uint),
        ("temperature", ctypes.c_float),
        ("min_temperature", ctypes.c_float),
        ("inv_sqrt_dh", ctypes.c_float),
    ]


def _fill_args(a, pack: JukeBoxPack) -> None:
    off = lambda name: pack.offsets[name][0]  # noqa: E731
    for i in range(pack.n_up):
        a.off_in_w[i], a.off_in_b[i], a.off_pe[i] = off(f"win.{i}"), off(f"bin.{i}"), off(f"pe.{i}")
        a.off_ckv_w[i], a.off_ckv_b[i] = off(f"wckv.{i}"), off(f"bckv.{i}")
        a.off_up_w[i], a.off_up_b[i] = off(f"wup.{i}"), off(f"bup.{i}")
        for k, kind in enumerate(LAYER_KINDS):
            a.off_layer[i][k] = off(f"{kind}.{i}.0")
        a.layer_stride[i] = pack.layer_strides[i]
        a.n_frames[i], a.t_up[i] = pack.n_frames[i], pack.t_up[i]
    for i, f in enumerate(pack.frames):
        a.frame[i] = f
    a.off_bot_w, a.off_bot_b = off("wbot"), off("bbot")
    for k, (d_in, d_out) in enumerate(pack.head_dims):
        a.off_wh[k], a.off_bh[k] = off(f"wh{k}"), off(f"bh{k}")
        a.head_in[k], a.head_out[k] = d_in, d_out
    a.n_up, a.W, a.d, a.n_heads, a.ff = pack.n_up, pack.window, pack.dim, pack.n_heads, pack.ff
    a.n_layers, a.Q, a.n_head = pack.n_layers, pack.q_levels, len(pack.head_dims)
    a.rows = max(pack.n_frames)
    a.head_width = max(w for dims in pack.head_dims for w in dims)
    a.mish_ffn = int(pack.mish_ffn)
    a.min_temperature = pack.min_temperature
    a.inv_sqrt_dh = float(np.float32(1.0 / np.sqrt(pack.dim // pack.n_heads)))


def _check_pack(pack: JukeBoxPack, dev) -> None:
    _check(pack.flat, "weights", torch.float32, pack.flat.shape, dev)
    if not _fits(pack.window, pack.dim, pack.ff, pack.n_layers, pack.n_frames, pack.t_up,
                 pack.head_dims):
        raise ValueError("the net is outside the tier-pyramid kernel's limits")


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_kernel() -> Path:
    """Compile ``csrc/jukebox_decode.cu`` for sm_90a into ``build/kernels/``
    (see :mod:`.nvcc`) and return the library's path."""
    path, log = build_library(SOURCE, "mmk_jukebox")
    if log:
        _Kernel.build_log = log
    return path


def _library():
    if _Kernel.lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        lib.mmk_jb_decode.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.mmk_jb_decode.restype = ctypes.c_int
        lib.mmk_jb_args_size.argtypes = []
        lib.mmk_jb_args_size.restype = ctypes.c_int
        lib.mmk_jb_error_string.argtypes = [ctypes.c_int]
        lib.mmk_jb_error_string.restype = ctypes.c_char_p
        if lib.mmk_jb_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("JbArgs layout differs between C and Python")
        _Kernel.lib = lib
    return _Kernel.lib


def _launch(pack: JukeBoxPack, window: torch.Tensor, t0: int, n_steps: int, seed: int,
            temperature: Optional[float]) -> torch.Tensor:
    dev = pack.flat.device
    if dev.type != "cuda":
        raise ValueError(f"the tier-pyramid decode kernel runs on CUDA tensors, got {dev}")
    B = window.shape[0]
    _check_pack(pack, dev)
    _check(window, "window", torch.int32, (B, pack.window), dev)
    if temperature is not None and not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    out = torch.empty(B, n_steps, dtype=torch.int32, device=dev)
    if n_steps == 0 or B == 0:
        return out
    lib = _library()
    a = _Args()
    _fill_args(a, pack)
    a.B, a.n_steps, a.t0 = B, n_steps, t0
    a.argmax = int(temperature is None)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = 1.0 if temperature is None else float(temperature)
    a.w, a.window, a.out = pack.flat.data_ptr(), window.data_ptr(), out.data_ptr()
    err = lib.mmk_jb_decode(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("tier-pyramid decode kernel launch failed: "
                           f"{lib.mmk_jb_error_string(err).decode()}")
    decode_pyramid.launches += 1
    return out


# -- the cluster kernel: build, bind, launch ---------------------------------------------

class _ClArgs(ctypes.Structure):
    """Mirror of ``JcArgs`` in ``csrc/jukebox_cluster.cu``."""

    _fields_ = [
        ("cw", ctypes.c_void_p),
        ("tab", ctypes.c_void_p),
        ("window", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("barriers", ctypes.c_void_p),
        ("t0", ctypes.c_longlong),
        ("frame", ctypes.c_int * (MAX_TIERS + 1)),
        ("n_frames", ctypes.c_int * MAX_TIERS),
        ("t_up", ctypes.c_int * MAX_TIERS),
        ("head_in", ctypes.c_int * MAX_HEAD),
        ("head_out", ctypes.c_int * MAX_HEAD),
        *[(name, ctypes.c_int) for name in (
            "n_up", "B", "n_steps", "W", "d", "n_heads", "ff", "n_layers", "Q", "n_head", "rows",
            "head_width", "ymax", "tab_ints", "wreg_floats", "n_slots", "slot_floats",
            "smem_bytes", "mish_ffn", "argmax")],
        ("seed", ctypes.c_uint),
        ("temperature", ctypes.c_float),
        ("min_temperature", ctypes.c_float),
        ("inv_sqrt_dh", ctypes.c_float),
    ]


class _ClusterKernel:
    """The cluster kernel's library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_cluster_kernel() -> Path:
    """Compile ``csrc/jukebox_cluster.cu`` for sm_90a into ``build/kernels/``
    and return the library's path."""
    path, log = build_library(CLUSTER_SOURCE, "mmk_jukebox_cluster")
    if log:
        _ClusterKernel.build_log = log
    return path


def _cluster_library():
    if _ClusterKernel.lib is None:
        lib = ctypes.CDLL(str(build_cluster_kernel()))
        lib.mmk_jc_decode.argtypes = [ctypes.POINTER(_ClArgs), ctypes.c_int, ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
        lib.mmk_jc_decode.restype = ctypes.c_int
        lib.mmk_jc_args_size.argtypes = []
        lib.mmk_jc_args_size.restype = ctypes.c_int
        lib.mmk_jc_error_string.argtypes = [ctypes.c_int]
        lib.mmk_jc_error_string.restype = ctypes.c_char_p
        if lib.mmk_jc_args_size() != ctypes.sizeof(_ClArgs):
            raise RuntimeError("JcArgs layout differs between C and Python")
        _ClusterKernel.lib = lib
    return _ClusterKernel.lib


def _launch_cluster(pack: JukeBoxPack, window: torch.Tensor, t0: int, n_steps: int, seed: int,
                    temperature: Optional[float], cl: Optional[int] = None) -> torch.Tensor:
    dev = pack.flat.device
    if dev.type != "cuda":
        raise ValueError(f"the cluster tier-pyramid kernel runs on CUDA tensors, got {dev}")
    B = window.shape[0]
    _check_pack(pack, dev)
    _check(window, "window", torch.int32, (B, pack.window), dev)
    if temperature is not None and not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    cl = cl or K8_CLUSTER_SIZE
    cw, tabs, plan = cluster_layout(pack, cl)
    if not plan.fits:
        raise ValueError(f"the net is outside the cluster kernel's plan at {cl} blocks: {plan.why}")
    out = torch.empty(B, n_steps, dtype=torch.int32, device=dev)
    if n_steps == 0 or B == 0:
        return out
    lib = _cluster_library()
    a = _ClArgs()
    b = _Args()
    _fill_args(b, pack)
    for name in ("frame", "n_frames", "t_up", "head_in", "head_out"):
        getattr(a, name)[:] = getattr(b, name)[:]
    for name in ("n_up", "W", "d", "n_heads", "ff", "n_layers", "Q", "n_head", "rows",
                 "head_width", "mish_ffn", "min_temperature", "inv_sqrt_dh"):
        setattr(a, name, getattr(b, name))
    a.ymax, a.tab_ints, a.wreg_floats = plan.ymax, plan.tab_ints, plan.wreg_floats
    a.n_slots, a.slot_floats, a.smem_bytes = RING_SLOTS, SLOT_FLOATS, plan.smem_bytes
    a.B, a.n_steps, a.t0 = B, n_steps, t0
    a.argmax = int(temperature is None)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = 1.0 if temperature is None else float(temperature)
    barriers = torch.zeros(1, dtype=torch.int64, device=dev)
    a.cw, a.tab, a.window, a.out = cw.data_ptr(), tabs.data_ptr(), window.data_ptr(), out.data_ptr()
    a.barriers = barriers.data_ptr()
    clusters = ctypes.c_int(0)
    err = lib.mmk_jc_decode(ctypes.byref(a), cl, torch.cuda.current_stream(dev).cuda_stream,
                            ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError("cluster tier-pyramid decode kernel launch failed: "
                           f"{lib.mmk_jc_error_string(err).decode()}")
    decode_pyramid.launches += 1
    decode_pyramid.launches_cluster += 1
    decode_pyramid.last_barriers = barriers
    decode_pyramid.last_clusters = clusters.value
    decode_pyramid.last_cluster_size = cl
    return out


# -- the group kernel: S streams a cluster -------------------------------------------------

class _GpArgs(ctypes.Structure):
    """Mirror of ``JgArgs`` in ``csrc/jukebox_group.cu``."""

    _fields_ = [
        ("cw", ctypes.c_void_p),
        ("tab", ctypes.c_void_p),
        ("window", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("barriers", ctypes.c_void_p),
        ("t0", ctypes.c_longlong),
        ("frame", ctypes.c_int * (MAX_TIERS + 1)),
        ("n_frames", ctypes.c_int * MAX_TIERS),
        ("t_up", ctypes.c_int * MAX_TIERS),
        ("head_in", ctypes.c_int * MAX_HEAD),
        ("head_out", ctypes.c_int * MAX_HEAD),
        *[(name, ctypes.c_int) for name in (
            "n_up", "B", "S", "n_steps", "W", "d", "n_heads", "ff", "n_layers", "Q", "n_head",
            "rows", "head_width", "ymax", "tab_ints", "wreg_floats", "n_slots", "slot_floats",
            "smem_bytes", "mish_ffn", "argmax")],
        ("seed", ctypes.c_uint),
        ("temperature", ctypes.c_float),
        ("min_temperature", ctypes.c_float),
        ("inv_sqrt_dh", ctypes.c_float),
    ]


class _GroupKernel:
    """The group kernel's library (one per process), its compiler output and
    the clusters that fit, by (device, cluster size, shared memory)."""

    lib = None
    build_log = ""
    clusters = {}


def build_group_kernel() -> Path:
    """Compile ``csrc/jukebox_group.cu`` for sm_90a into ``build/kernels/``
    and return the library's path."""
    path, log = build_library(GROUP_SOURCE, "mmk_jukebox_group")
    if log:
        _GroupKernel.build_log = log
    return path


def _group_library():
    if _GroupKernel.lib is None:
        lib = ctypes.CDLL(str(build_group_kernel()))
        lib.mmk_jg_decode.argtypes = [ctypes.POINTER(_GpArgs), ctypes.c_int, ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.mmk_jg_decode.restype = ctypes.c_int
        lib.mmk_jg_args_size.argtypes = []
        lib.mmk_jg_args_size.restype = ctypes.c_int
        lib.mmk_jg_error_string.argtypes = [ctypes.c_int]
        lib.mmk_jg_error_string.restype = ctypes.c_char_p
        if lib.mmk_jg_args_size() != ctypes.sizeof(_GpArgs):
            raise RuntimeError("JgArgs layout differs between C and Python")
        _GroupKernel.lib = lib
    return _GroupKernel.lib


def group_plan(pack: JukeBoxPack, cl: int, S: int) -> ClusterPlan:
    """The group kernel's residency plan of ``pack``'s net on clusters of
    ``cl`` blocks (``GROUP_SIZES``) for groups of ``S`` streams: the
    cluster kernel's column slices, whose activations (``act_floats``) grow
    with S, so that fewer slices stay resident."""
    return _plan(geometry(pack), cl, S, GROUP_SIZES, GROUP_SLOT_FLOATS)


def max_streams(pack: JukeBoxPack, cl: int) -> int:
    """The most streams a group whose plan fits at ``cl`` blocks (0: none)."""
    S = 0
    while S < 64 and group_plan(pack, cl, S + 1).fits:
        S += 1
    return S


def _fill_group_args(a: _GpArgs, pack: JukeBoxPack, plan: ClusterPlan) -> None:
    b = _Args()
    _fill_args(b, pack)
    for name in ("frame", "n_frames", "t_up", "head_in", "head_out"):
        getattr(a, name)[:] = getattr(b, name)[:]
    for name in ("n_up", "W", "d", "n_heads", "ff", "n_layers", "Q", "n_head", "rows",
                 "head_width", "mish_ffn", "min_temperature", "inv_sqrt_dh"):
        setattr(a, name, getattr(b, name))
    a.S, a.ymax, a.tab_ints, a.wreg_floats = plan.S, plan.ymax, plan.tab_ints, plan.wreg_floats
    a.n_slots, a.slot_floats, a.smem_bytes = RING_SLOTS, plan.slot_floats, plan.smem_bytes


def clusters_that_fit(pack: JukeBoxPack, cl: int) -> int:
    """The clusters of ``cl`` blocks the card runs at once at the group
    kernel's shared memory for the largest group
    (``cudaOccupancyMaxActiveClusters``), cached."""
    dev = pack.flat.device
    plan = group_plan(pack, cl, max(1, max_streams(pack, cl)))
    key = (str(dev), cl, plan.smem_bytes)
    if key not in _GroupKernel.clusters:
        a = _GpArgs()
        _fill_group_args(a, pack, plan)
        n = ctypes.c_int(0)
        err = _group_library().mmk_jg_decode(
            ctypes.byref(a), cl, torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(n), 1)
        if err != 0:
            raise RuntimeError("group tier-pyramid kernel query failed: "
                               f"{_group_library().mmk_jg_error_string(err).decode()}")
        _GroupKernel.clusters[key] = n.value
    return _GroupKernel.clusters[key]


def streams_a_group(pack: JukeBoxPack, cl: int, B: int, clusters: int) -> int:
    """S: B streams spread over the clusters that fit, at most the plan's
    largest group (more groups then wait for a cluster)."""
    return max(1, min(max_streams(pack, cl), -(-B // clusters)))


def _launch_group(pack: JukeBoxPack, window: torch.Tensor, t0: int, n_steps: int, seed: int,
                  temperature: Optional[float], cl: int, S: Optional[int] = None
                  ) -> torch.Tensor:
    """The group kernel on clusters of ``cl`` blocks, groups of ``S``
    streams (default: :func:`streams_a_group` over the clusters that fit)."""
    dev = pack.flat.device
    if dev.type != "cuda":
        raise ValueError(f"the group tier-pyramid kernel runs on CUDA tensors, got {dev}")
    B = window.shape[0]
    _check_pack(pack, dev)
    _check(window, "window", torch.int32, (B, pack.window), dev)
    if temperature is not None and not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if S is None:
        S = streams_a_group(pack, cl, B, clusters_that_fit(pack, cl))
    cw, tabs, plan = group_layout(pack, cl, S)
    if not plan.fits:
        raise ValueError(f"the net is outside the group kernel's plan at {cl} blocks and"
                         f" {S} streams a group: {plan.why}")
    out = torch.empty(B, n_steps, dtype=torch.int32, device=dev)
    if n_steps == 0 or B == 0:
        return out
    lib = _group_library()
    a = _GpArgs()
    _fill_group_args(a, pack, plan)
    a.B, a.n_steps, a.t0 = B, n_steps, t0
    a.argmax = int(temperature is None)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = 1.0 if temperature is None else float(temperature)
    barriers = torch.zeros(1, dtype=torch.int64, device=dev)
    a.cw, a.tab, a.window, a.out = cw.data_ptr(), tabs.data_ptr(), window.data_ptr(), out.data_ptr()
    a.barriers = barriers.data_ptr()
    clusters = ctypes.c_int(0)
    err = lib.mmk_jg_decode(ctypes.byref(a), cl, torch.cuda.current_stream(dev).cuda_stream,
                            ctypes.byref(clusters), 0)
    if err != 0:
        raise RuntimeError("group tier-pyramid decode kernel launch failed: "
                           f"{lib.mmk_jg_error_string(err).decode()}")
    decode_pyramid.launches += 1
    decode_pyramid.launches_group += 1
    decode_pyramid.last_barriers = barriers
    decode_pyramid.last_clusters = clusters.value
    decode_pyramid.last_cluster_size = cl
    decode_pyramid.last_streams = S
    return out


def decode_pyramid(pack: JukeBoxPack, window: torch.Tensor, t0: int, n_steps: int, seed: int,
                   temperature: Optional[float]) -> torch.Tensor:
    """K8's route: decode ``n_steps`` tokens from the (B, W) int32 lead
    ``window`` in one launch, the first at absolute position ``t0`` (its
    noise keyed by that position).  Returns (B, n_steps) int32 and leaves
    the advanced window in ``window``.  A CUDA window goes where
    :func:`route` names: the cluster kernel (``csrc/jukebox_cluster.cu``) up
    to ``_K8_CLUSTER_MAX_B`` streams, the group kernel
    (``csrc/jukebox_group.cu``) up to ``K8_GROUP_ROUTE``'s limit, the block
    kernel (``csrc/jukebox_decode.cu``) beyond or for a net outside the
    plans: the route depends on B and the widths only, so every chunk of a
    stream takes one kernel."""
    if window.device.type == "cpu":
        return decode_pyramid_plain(pack, window, t0, n_steps, seed, temperature)
    kernel, cl = route(pack, window.shape[0])
    if kernel == "cluster":
        return _launch_cluster(pack, window, t0, n_steps, seed, temperature, cl=cl)
    if kernel == "group":
        return _launch_group(pack, window, t0, n_steps, seed, temperature, cl)
    return _launch(pack, window, t0, n_steps, seed, temperature)


def route(pack: JukeBoxPack, B: int) -> Tuple[str, Optional[int]]:
    """(kernel, cluster size) :func:`decode_pyramid` launches B streams of
    ``pack``'s net with (on a CUDA window): ``"cluster"`` where
    ``K8_CLUSTER_ROUTE`` names B and the cluster kernel's plan fits, else
    ``"group"`` where ``K8_GROUP_ROUTE`` names B and a group of one stream
    fits, else ``("block", None)``.  It depends on B and the widths only, so
    every chunk of a stream takes one kernel."""
    for most, cl in K8_CLUSTER_ROUTE:
        if B <= most and cluster_plan(pack, cl).fits:
            return "cluster", cl
    for most, cl in K8_GROUP_ROUTE:
        if B <= most and max_streams(pack, cl) > 0:
            return "group", cl
    return "block", None


def cluster_size_for(pack: JukeBoxPack, B: int) -> Optional[int]:
    """The cluster size :func:`decode_pyramid` launches B streams of
    ``pack``'s net with on the cluster kernel (on a CUDA window), from
    ``K8_CLUSTER_ROUTE``; None for another kernel."""
    kernel, cl = route(pack, B)
    return cl if kernel == "cluster" else None


def uses_cluster_kernel(pack: JukeBoxPack, B: int) -> bool:
    """Whether :func:`decode_pyramid` sends B streams of ``pack``'s net to
    the cluster kernel (on a CUDA window)."""
    return cluster_size_for(pack, B) is not None


decode_pyramid.launches = 0  # the three kernels' launches
decode_pyramid.launches_cluster = 0  # the cluster kernel's
decode_pyramid.launches_group = 0  # the group kernel's
# the cluster barriers block 0 passed in its first stream's (group's) steps in
# the last cluster or group launch (a (1,) device tensor), the clusters that
# fitted on the card, their size, and the group kernel's streams a group
decode_pyramid.last_barriers = None
decode_pyramid.last_clusters = 0
decode_pyramid.last_cluster_size = 0
decode_pyramid.last_streams = 0
