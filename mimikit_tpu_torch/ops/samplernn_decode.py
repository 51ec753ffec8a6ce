"""SampleRNN decode: the hand-written CUDA kernel, its wrappers and its plain twin.

The kernel (``csrc/samplernn_decode.cu``) replaces the TPU kernels
``make_samplernn_pallas_decoder`` (K1, ``mimikit_tpu/ops/pallas_decode.py:148``)
and ``make_samplernn_pallas_chunked`` (K2, ``pallas_decode.py:868``).  Both
computed the same step; K2 only carried the state in and out.  Here one
state-carrying CUDA entry serves both, behind two counted wrappers:

* :func:`decode_single` — K1's route: builds the state from the prompt and
  runs the whole decode in one launch;
* :func:`decode_chunk` — K2's route: runs ``n_steps`` steps from absolute
  step ``t0`` on a caller-held :class:`DecodeState`.

On CUDA tensors both launch the cluster kernel (``csrc/samplernn_cluster.cu``:
a group of streams on a thread-block cluster, each block holding its slices
of the weights in shared memory; :func:`cluster_plan`,
:func:`cluster_layout`) where ``K2_CLUSTER_ROUTE`` names B, other batches the
block kernel.  The route depends on B and the net's widths only, so every
chunk of a stream takes one kernel.

What bounds the kernel on an H100, and what its design does about it, is in
the source note at the top of the ``.cu`` file.

The wrappers' rule: a CPU tensor takes the plain PyTorch twin
(:func:`decode_plain`, a step loop over ``SampleRNN.decode_step``); a CUDA
tensor launches the kernel or raises.  There is no fallback.

The kernel is built from the checkout's sources with ``nvcc`` at first use
into ``build/kernels/`` (a shared library with a C interface, loaded with
``ctypes``) — nothing is compiled or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses as dtc
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..modules.activations import mish
from .noise import gumbel_noise
from .nvcc import CSRC, build_library
from .temperature import Temperature, row_temperatures

__all__ = [
    "supports_kernel_decode",
    "samplernn_weight_pack",
    "SampleRNNPack",
    "DecodeState",
    "init_decode_state",
    "gumbel_noise",
    "decode_plain",
    "decode_single",
    "decode_chunk",
    "build_kernel",
    "K2_CLUSTER_ROUTE",
    "ClusterPlan",
    "cluster_plan",
    "cluster_layout",
    "cluster_size_for",
    "build_cluster_kernel",
]

MAX_TIERS = 8
MAX_HEAD = 4
SOURCE = CSRC / "samplernn_decode.cu"


# -- scope gate (pallas_decode.py:65-100) --------------------------------------

def _head_is_plain_mish(t_mod) -> bool:
    act = getattr(t_mod, "activation", None)
    return (
        act is not None
        and str(getattr(act, "act", "")) == "Mish"
        and not getattr(act, "scaled", False)
        and not getattr(act, "static", False)
    )


def supports_kernel_decode(net) -> bool:
    """True when ``net`` is a SampleRNN in the kernel's configuration: LSTM
    tiers with one layer and zero h0, summed single discrete framed-linear
    input, one learned-temperature Mish MLP head with at most two hidden
    layers, a categorical objective."""
    from ..features.functionals import Discrete
    from ..modules.io import FramedLinearIO, MLPIO

    cfg = net.config
    if str(cfg.rnn_class) != "lstm" or cfg.n_rnn != 1:
        return False
    if str(cfg.h0_init) != "zeros" or cfg.weight_norm:
        return False
    if str(cfg.inputs_mode) != "sum" or not 2 <= len(cfg.frame_sizes) <= MAX_TIERS:
        return False
    io = cfg.io_spec
    if len(io.inputs) != 1 or len(io.targets) != 1:
        return False
    if not isinstance(io.inputs[0].elem_type, Discrete):
        return False
    if not isinstance(io.inputs[0].module, FramedLinearIO):
        return False
    t_mod = io.targets[0].module
    if not isinstance(t_mod, MLPIO) or t_mod.min_temperature is None:
        return False
    if not _head_is_plain_mish(t_mod) or t_mod.n_hidden_layers not in (0, 1, 2):
        return False
    return str(io.targets[0].objective.objective_type) == "categorical_dist"


# -- weight pack (pallas_decode.py:103-144) ------------------------------------

@dtc.dataclass
class SampleRNNPack:
    """The kernel's view of a SampleRNN: every weight in one flat buffer
    (float32, or bfloat16 for the bf16 route), each tensor's (offset, shape)
    in it, and the static sizes the kernel reads.  ``net`` is kept for the
    f32 plain twin (the CPU route)."""

    net: object
    flat: torch.Tensor
    offsets: dict
    frame_sizes: Tuple[int, ...]
    up_factors: Tuple[int, ...]
    hidden_dim: int
    q_levels: int
    head_dims: Tuple[Tuple[int, int], ...]
    min_temperature: float

    def view(self, name: str) -> torch.Tensor:
        """The tensor ``name``, in the pack's dtype (a view of ``flat``)."""
        off, shape = self.offsets[name]
        return self.flat[off : off + math.prod(shape)].view(shape)


@torch.no_grad()
def samplernn_weight_pack(net, dtype: torch.dtype = torch.float32) -> SampleRNNPack:
    """Flatten ``net``'s weights into the kernel's layout, on ``net``'s
    device, stored in ``dtype``: float32, or bfloat16 (the bf16 route,
    ``MMK_PALLAS_BF16=1``: half the weight bytes, each product's input
    rounded to bf16 and summed in f32; ``pallas_decode.py:103-145,179-187``).

    Per non-bottom tier i: ``win{i}`` (fs_i, H), ``bin{i}`` (H), ``wx{i}``
    = [W_ih^T; W_hh^T] (2H, 4H) [gate order i|f|g|o], ``bx{i}`` = b_ih + b_hh
    (4H), ``wup{i}`` (H, up_i*H), ``bup{i}``; then ``wbot`` (fs_-1, H),
    ``bbot``; then the head chain ``wh{k}``/``bh{k}`` (the last layer emits
    Q+1 logits, the extra one being the learned temperature).  Each tensor
    starts at a multiple of 16 bytes.  Every tensor is summed or concatenated
    in f32 and then cast, so a bf16 pack holds the f32 pack's values rounded
    once.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the decode kernel takes float32 or bfloat16 weights, not {dtype}")
    align = 16 // torch.empty((), dtype=dtype).element_size()
    parts, offsets = [], {}
    pos = 0

    def add(name, x):
        nonlocal pos
        x = x.detach().to(torch.float32).to(dtype).contiguous()
        offsets[name] = (pos, tuple(x.shape))
        pad = -x.numel() % align
        parts.append(x.reshape(-1))
        if pad:
            parts.append(x.new_zeros(pad))
        pos += x.numel() + pad

    fs = tuple(net.frame_sizes)
    for i in range(len(fs) - 1):
        tier = net.tiers[i]
        lin = tier.input_module.heads[0][2]
        add(f"win{i}", lin.weight.t())
        add(f"bin{i}", lin.bias)
        rnn = tier.rnn
        add(f"wx{i}", torch.cat([rnn.weight_ih_l0.t(), rnn.weight_hh_l0.t()], 0))
        add(f"bx{i}", rnn.bias_ih_l0 + rnn.bias_hh_l0)
        add(f"wup{i}", tier.up_sampler.fc.weight.t())
        add(f"bup{i}", tier.up_sampler.fc.bias)
    cv = net.tiers[-1].input_module.heads[0][2][2].cv
    add("wbot", cv.weight.reshape(cv.weight.shape[0], -1).t())
    add("bbot", cv.bias)
    mlp = net.output_modules[0].estimator[0]
    linears = list(mlp.fc)[0::2]
    for k, lin in enumerate(linears):
        add(f"wh{k}", lin.weight.t())
        add(f"bh{k}", lin.bias)
    return SampleRNNPack(
        net=net,
        flat=torch.cat(parts),
        offsets=offsets,
        frame_sizes=fs,
        up_factors=tuple(net.up_factors),
        hidden_dim=net.config.hidden_dim,
        q_levels=linears[-1].out_features - 1,
        head_dims=tuple((l.in_features, l.out_features) for l in linears),
        min_temperature=float(mlp.min_temperature),
    )


# -- decode state --------------------------------------------------------------

@dtc.dataclass
class DecodeState:
    """What one decode carries from step to step, for B streams:
    ``win`` (B, rf) int32 sample window, oldest first; ``h``/``c``
    (n_tiers-1, n_rnn, B, H) LSTM carries; ``cache`` (B, sum(up), H) each
    tier's upsampled outputs, tier i in rows ``sum(up[:i]) .. +up[i]``."""

    win: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor
    cache: torch.Tensor


def init_decode_state(net, prompt: torch.Tensor, generator=None) -> DecodeState:
    """State before step ``rf``: the first ``rf`` prompt samples, initial
    carries per the net's ``h0_init``, zero caches."""
    from ..modules.rnn import init_rnn_carry

    cfg = net.config
    B, H = prompt.shape[0], cfg.hidden_dim
    n = len(net.frame_sizes) - 1
    carries = [
        init_rnn_carry(cfg.n_rnn, B, H, str(cfg.h0_init), prompt.device, generator)
        for _ in range(n)
    ]
    h = torch.stack([torch.stack([h for _, h in tier]) for tier in carries])
    c = torch.stack([torch.stack([c for c, _ in tier]) for tier in carries])
    return DecodeState(
        win=prompt[:, : net.rf].to(torch.int32).clone(),  # a copy: written in place
        h=h.contiguous(),
        c=c.contiguous(),
        cache=torch.zeros(B, sum(net.up_factors), H, device=prompt.device),
    )


# -- the plain twin ------------------------------------------------------------

def _dense_bf16(pack: SampleRNNPack, x: torch.Tensor, w: str, b: str,
                acc: torch.dtype = torch.float32) -> torch.Tensor:
    """A product of the bf16 route: the input rounded to bf16, the bf16
    weights and bias read exactly, the products summed in ``acc`` (f32, as
    the kernel sums), the result f32."""
    y = x.to(torch.bfloat16).to(acc) @ pack.view(w).to(acc) + pack.view(b).to(acc)
    return y.float()


def _step_bf16(pack: SampleRNNPack, t: int, win: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor, cache: torch.Tensor,
               acc: torch.dtype = torch.float32) -> torch.Tensor:
    """One step of the bf16 route (``pallas_decode.py:219-266`` with
    ``weight_dtype="bf16"``) on the state tensors, updated in place: ``win``
    (B, rf) int64, ``h``/``c`` (n_tiers-1, B, H), ``cache`` (B, sum(up), H).
    The frame tier's gates take [x | h] through one product, as the kernel
    does; its products sum in ``acc``.  Returns the (B, Q) logits after the
    learned temperature."""
    fs, up, H = pack.frame_sizes, pack.up_factors, pack.hidden_dim
    rf, Q = fs[0], pack.q_levels
    xf = (win.float() / Q - 0.5) * 2.0
    rows = [0]
    for u in up:
        rows.append(rows[-1] + u)
    for i in range(len(fs) - 1):
        f = fs[i]
        if t % f:
            continue
        x = _dense_bf16(pack, xf[:, rf - f :], f"win{i}", f"bin{i}", acc)
        if i > 0:
            x = x + cache[:, rows[i - 1] + (t // f) % up[i - 1]]
        g = _dense_bf16(pack, torch.cat([x, h[i]], 1), f"wx{i}", f"bx{i}", acc)
        gi, gf = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H : 2 * H])
        gg, go = torch.tanh(g[:, 2 * H : 3 * H]), torch.sigmoid(g[:, 3 * H :])
        c[i] = gf * c[i] + gi * gg
        h[i] = go * torch.tanh(c[i])
        cache[:, rows[i] : rows[i + 1]] = _dense_bf16(
            pack, h[i], f"wup{i}", f"bup{i}", acc).view(-1, up[i], H)
    x = _dense_bf16(pack, xf[:, rf - fs[-1] :], "wbot", "bbot", acc)
    x = x + cache[:, rows[-2] + t % fs[-2]]
    n = len(pack.head_dims)
    for k in range(n - 1):
        x = mish(_dense_bf16(pack, x, f"wh{k}", f"bh{k}", acc))
    logits = _dense_bf16(pack, x, f"wh{n - 1}", f"bh{n - 1}", acc)
    return logits[:, :Q] / torch.clamp_min(torch.sigmoid(logits[:, Q : Q + 1]),
                                           pack.min_temperature)


@torch.no_grad()
def decode_plain(model, prompt: torch.Tensor, state: DecodeState, t0: int,
                 n_steps: int, out_t0: int, out_len: int, seed: int,
                 temperature: Temperature, return_scores: bool = False,
                 accumulate: torch.dtype = torch.float32):
    """The plain PyTorch twin of the kernel: ``n_steps`` steps from absolute
    step ``t0``, the same sampling rule and noise, teacher-forcing while ``t
    < prior_t``.  ``model`` is the SampleRNN, or its pack: a float32 pack and
    the net step through ``net.decode_step``, a bfloat16 pack through the
    bf16 route's step (:func:`_step_bf16`), its products summed in
    ``accumulate`` (f32, as the kernel sums; float64 sums in another order,
    which measures how far the order alone moves the bf16 route's scores).
    ``state`` is updated in place.
    Returns ``out`` (B, out_len) int32 holding the tokens of steps ``out_t0
    ..``; with ``return_scores`` also the (n_steps, B, Q) scores the argmax
    ran over (tempered logits, plus noise when sampling)."""
    bf16 = isinstance(model, SampleRNNPack) and model.flat.dtype == torch.bfloat16
    net = model.net if isinstance(model, SampleRNNPack) else model
    B, prior_t = prompt.shape
    temps = row_temperatures(temperature, B, prompt.device)
    n_t = len(net.frame_sizes) - 1
    rows = [0]
    for u in net.up_factors:
        rows.append(rows[-1] + u)
    win = state.win.to(torch.int64)
    if bf16:
        h, c, cache = state.h[:, 0].clone(), state.c[:, 0].clone(), state.cache.clone()
    else:
        hidden = tuple(
            tuple((state.c[i, l], state.h[i, l]) for l in range(state.h.shape[1]))
            for i in range(n_t)
        )
        tier_out = tuple(state.cache[:, rows[i] : rows[i + 1]] for i in range(n_t))
    out = torch.zeros(B, out_len, dtype=torch.int32, device=prompt.device)
    scores_all = []
    for i in range(n_steps):
        t = t0 + i
        if bf16:
            scores = _step_bf16(model, t, win, h, c, cache, accumulate)
        else:
            logits, hidden, tier_out = net.decode_step(t, (win,), hidden, tier_out)
            scores = logits[0]
        if temps is not None:
            scores = scores / temps.column() + gumbel_noise(
                seed, t, B, scores.shape[-1], scores.device
            )
        tok = torch.argmax(scores, dim=-1)
        if t < prior_t:
            tok = prompt[:, t].to(torch.int64)
        if 0 <= t - out_t0 < out_len:
            out[:, t - out_t0] = tok.to(torch.int32)
        if return_scores:
            scores_all.append(scores)
        win = torch.cat([win[:, 1:], tok[:, None]], dim=1)
    state.win.copy_(win)
    if bf16:
        state.h[:, 0].copy_(h)
        state.c[:, 0].copy_(c)
        state.cache.copy_(cache)
    else:
        for i in range(n_t):
            for l, (c_, h_) in enumerate(hidden[i]):
                state.c[i, l].copy_(c_)
                state.h[i, l].copy_(h_)
            state.cache[:, rows[i] : rows[i + 1]].copy_(tier_out[i])
    if return_scores:
        return out, torch.stack(scores_all)
    return out


# -- the kernel: build, bind, launch -------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``SrnnDecodeArgs`` in ``csrc/samplernn_decode.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("prompt", ctypes.c_void_p),
        ("win", ctypes.c_void_p),
        ("h", ctypes.c_void_p),
        ("c", ctypes.c_void_p),
        ("cache", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("t0", ctypes.c_longlong),
        ("out_t0", ctypes.c_longlong),
        ("off_win", ctypes.c_longlong * MAX_TIERS),
        ("off_bin", ctypes.c_longlong * MAX_TIERS),
        ("off_wx", ctypes.c_longlong * MAX_TIERS),
        ("off_bx", ctypes.c_longlong * MAX_TIERS),
        ("off_wup", ctypes.c_longlong * MAX_TIERS),
        ("off_bup", ctypes.c_longlong * MAX_TIERS),
        ("off_wbot", ctypes.c_longlong),
        ("off_bbot", ctypes.c_longlong),
        ("off_wh", ctypes.c_longlong * MAX_HEAD),
        ("off_bh", ctypes.c_longlong * MAX_HEAD),
        ("n_steps", ctypes.c_int),
        ("out_len", ctypes.c_int),
        ("B", ctypes.c_int),
        ("H", ctypes.c_int),
        ("Q", ctypes.c_int),
        ("rf", ctypes.c_int),
        ("prior_t", ctypes.c_int),
        ("n_tiers", ctypes.c_int),
        ("n_head", ctypes.c_int),
        ("argmax", ctypes.c_int),
        ("group", ctypes.c_int),
        ("dstride", ctypes.c_int),
        ("cache_rows", ctypes.c_int),
        ("seed", ctypes.c_uint),
        ("temperature", ctypes.c_void_p),
        ("min_temperature", ctypes.c_float),
        ("bf16", ctypes.c_int),
        ("fs", ctypes.c_int * MAX_TIERS),
        ("up", ctypes.c_int * MAX_TIERS),
        ("cache_row", ctypes.c_int * MAX_TIERS),
        ("head_in", ctypes.c_int * MAX_HEAD),
        ("head_out", ctypes.c_int * MAX_HEAD),
    ]


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_kernel() -> Path:
    """Compile ``csrc/samplernn_decode.cu`` for sm_90a into
    ``build/kernels/`` (see :mod:`.nvcc`) and return the library's path."""
    path, log = build_library(SOURCE, "mmk_samplernn")
    if log:
        _Kernel.build_log = log
    return path


def _library():
    if _Kernel.lib is None:
        path = build_kernel()
        lib = ctypes.CDLL(str(path))
        lib.mmk_samplernn_decode.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.mmk_samplernn_decode.restype = ctypes.c_int
        lib.mmk_samplernn_args_size.argtypes = []
        lib.mmk_samplernn_args_size.restype = ctypes.c_int
        lib.mmk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mmk_cuda_error_string.restype = ctypes.c_char_p
        if lib.mmk_samplernn_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("SrnnDecodeArgs layout differs between C and Python")
        _Kernel.lib = lib
    return _Kernel.lib


SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may use on sm_90


def _group_for(B: int, device, smem_per_stream: int) -> int:
    """Streams per block: the fewest (1, 2, 4 or 8) that keep the grid within
    one block per SM, and whose shared memory fits a block.  A step's latency
    barely depends on the group, so spreading the streams over the SMs is
    what shortens a wide decode (chip_smoke.py --bench measures each group)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = 1
    while g < 8 and -(-B // g) > sms and 2 * g * smem_per_stream <= SMEM_PER_BLOCK:
        g *= 2
    return g


def _check(x: torch.Tensor, name: str, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(pack: SampleRNNPack, prompt, state: DecodeState, n_steps: int,
                  out: torch.Tensor, what: str) -> None:
    """Raise unless a decode kernel (``what``) takes these tensors."""
    dev = pack.flat.device
    if dev.type != "cuda":
        raise ValueError(f"the {what} runs on CUDA tensors, got {dev}")
    fs, up, H = pack.frame_sizes, pack.up_factors, pack.hidden_dim
    B, prior_t = prompt.shape
    rf, n_t = fs[0], len(fs) - 1
    if pack.flat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weights have dtype {pack.flat.dtype}, expected float32 or bfloat16")
    _check(pack.flat, "weights", pack.flat.dtype, pack.flat.shape, dev)
    _check(prompt, "prompt", torch.int32, (B, prior_t), dev)
    _check(state.win, "state.win", torch.int32, (B, rf), dev)
    _check(state.h, "state.h", torch.float32, (n_t, 1, B, H), dev)
    _check(state.c, "state.c", torch.float32, (n_t, 1, B, H), dev)
    _check(state.cache, "state.cache", torch.float32, (B, sum(up), H), dev)
    _check(out, "out", torch.int32, (B, out.shape[1]), dev)
    if prior_t < rf or n_steps < 0 or len(pack.head_dims) > MAX_HEAD:
        raise ValueError("prompt shorter than rf, negative step count or head too deep")


def _launch(pack: SampleRNNPack, prompt, state: DecodeState, t0: int, n_steps: int,
            out: torch.Tensor, out_t0: int, seed: int, temperature: Temperature,
            group: Optional[int] = None) -> bool:
    """Launch the kernel on ``state`` and ``out``; False when there are no
    steps to run (nothing is launched)."""
    _check_launch(pack, prompt, state, n_steps, out, "decode kernel")
    temps = row_temperatures(temperature, prompt.shape[0], pack.flat.device)
    if n_steps == 0:
        return False
    dev = pack.flat.device
    fs, up, H, Q = pack.frame_sizes, pack.up_factors, pack.hidden_dim, pack.q_levels
    B, prior_t = prompt.shape
    rf, n_t = fs[0], len(fs) - 1
    lib = _library()
    a = _Args()
    a.w, a.prompt, a.win = pack.flat.data_ptr(), prompt.data_ptr(), state.win.data_ptr()
    a.h, a.c, a.cache = state.h.data_ptr(), state.c.data_ptr(), state.cache.data_ptr()
    a.out = out.data_ptr()
    a.t0, a.out_t0 = t0, out_t0
    for i in range(n_t):
        a.off_win[i] = pack.offsets[f"win{i}"][0]
        a.off_bin[i] = pack.offsets[f"bin{i}"][0]
        a.off_wx[i] = pack.offsets[f"wx{i}"][0]
        a.off_bx[i] = pack.offsets[f"bx{i}"][0]
        a.off_wup[i] = pack.offsets[f"wup{i}"][0]
        a.off_bup[i] = pack.offsets[f"bup{i}"][0]
    a.off_wbot, a.off_bbot = pack.offsets["wbot"][0], pack.offsets["bbot"][0]
    for k, (d_in, d_out) in enumerate(pack.head_dims):
        a.off_wh[k], a.off_bh[k] = pack.offsets[f"wh{k}"][0], pack.offsets[f"bh{k}"][0]
        a.head_in[k], a.head_out[k] = d_in, d_out
    a.n_steps, a.out_len, a.B, a.H, a.Q = n_steps, out.shape[1], B, H, Q
    a.rf, a.prior_t, a.n_tiers, a.n_head = rf, prior_t, len(fs), len(pack.head_dims)
    a.argmax = int(temps is None)
    widest = max(4 * H, Q + 1, *(d for dims in pack.head_dims for d in dims))
    a.dstride = -(-widest // 4) * 4
    # per stream: three rows of dstride floats and the window, as the kernel lays out
    a.group = group or _group_for(B, dev, 4 * (3 * a.dstride + rf))
    a.cache_rows = sum(up)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = None if temps is None else temps.tensor.data_ptr()
    a.min_temperature = pack.min_temperature
    a.bf16 = int(pack.flat.dtype == torch.bfloat16)
    row = 0
    for i in range(len(fs)):
        a.fs[i] = fs[i]
        if i < n_t:
            a.up[i], a.cache_row[i] = up[i], row
            row += up[i]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mmk_samplernn_decode(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(
            f"samplernn decode kernel launch failed: {lib.mmk_cuda_error_string(err).decode()}"
        )
    return True


# -- the cluster kernel's plan -------------------------------------------------

CLUSTER_SOURCE = CSRC / "samplernn_cluster.cu"
CLUSTER_SIZES = (8, 16)  # the cluster sizes samplernn_cluster.cu instantiates
CLUSTER_THREADS = 256  # SC_THREADS
SLOT_BYTES = 16384  # a ring slot of streamed weights
MAX_SLOTS = 8
MIN_RED_FLOATS = 4096  # the partial sums' floats at least (more slices of K)
# per weight dtype, (most B, cluster size) in order: decode_chunk launches B
# streams of a net whose plan fits with clusters of the first entry that
# admits B; a wider batch takes the block kernel.  chip_smoke.py's sweep
# times the three choices on both packs (NVIDIA H100 80GB HBM3, 700 W;
# SampleRNN-3; PERF.md §6): clusters of 16 win while a group holds few
# streams, clusters of 8 from B=128 (f32) or B=64 (bf16, whose products
# cost less a stream) to 256, the block kernel at B=512.
K2_CLUSTER_ROUTE = {
    torch.float32: ((64, 16), (256, 8)),
    torch.bfloat16: ((16, 16), (256, 8)),
}


@dtc.dataclass(frozen=True)
class ClusterUnit:
    """One product of a step as the cluster splits it: the pack's ``src``
    (K, N) and ``bias``, and for each rank the pack columns of its slice in
    the order the kernel computes them (-1: a zero column that pads the
    last head layer's slice to a whole quad)."""

    name: str
    src: str
    bias: str
    K: int
    N: int
    cols: Tuple[Tuple[int, ...], ...]
    resident: bool


@dtc.dataclass(frozen=True)
class ClusterPlan:
    """Where each rank of a cluster of ``cl`` blocks keeps its slices, and a
    block's shared memory for groups of ``S`` streams (:func:`cluster_plan`).

    A rank's region of the relaid weights (elements of the pack's dtype,
    each run at a multiple of 16 bytes, alike for every rank): the bottom's
    framed dense whole (``wbot``, ``bbot``), the bias slices of every unit,
    the resident slices (the head layers, k-major: row k's columns
    together); ``n_resident`` elements so far, copied into shared memory
    once a launch; then the streamed slices (each tier's gates and
    up-sampler, k-major), copied through a ring of ``n_slots`` slots of
    ``slot_elems`` in pieces of whole rows when the tier fires.
    ``offsets[name]`` is a run's first element in the region; ``region``
    the region's length.  ``fits`` False (with ``why``) where the kernel
    cannot run the net at this cluster size."""

    cl: int
    S: int
    units: Tuple[ClusterUnit, ...]
    offsets: dict
    n_resident: int
    region: int
    red_floats: int
    n_slots: int
    slot_elems: int
    smem_bytes: int
    fits: bool
    why: str = ""

    def pieces(self, u: int) -> Tuple[Tuple[int, int], ...]:
        """A streamed unit's pieces: (first row, rows) each."""
        unit = self.units[u]
        nb = len(unit.cols[0])
        kp = 4 * max(1, self.slot_elems // nb // 4)
        return tuple((k, min(kp, unit.K - k)) for k in range(0, unit.K, kp))


def _r4(n: int) -> int:
    return -(-n // 4) * 4


Geometry = Tuple  # (H, Q, frame sizes, up factors, head dims, element size)


def geometry(pack: SampleRNNPack) -> Geometry:
    """The widths a cluster plan depends on, as a hashable tuple."""
    return (pack.hidden_dim, pack.q_levels, tuple(pack.frame_sizes), tuple(pack.up_factors),
            tuple(tuple(d) for d in pack.head_dims), pack.flat.element_size())


def _units(g: Geometry, cl: int) -> Tuple[ClusterUnit, ...]:
    """Every sliced product of a step, in the kernel's order of runs: the
    tiers' gates and up-samplers (streamed), the head layers (resident)."""
    H, Q, fs, up, head_dims, _ = g
    Hb, nt = H // cl, len(fs) - 1
    units = []
    for i in range(nt):
        units.append(ClusterUnit(
            f"wx{i}", f"wx{i}", f"bx{i}", 2 * H, 4 * H,
            tuple(tuple(gi * H + r * Hb + u for gi in range(4) for u in range(Hb))
                  for r in range(cl)), False))
        units.append(ClusterUnit(
            f"wup{i}", f"wup{i}", f"bup{i}", H, up[i] * H,
            tuple(tuple(c * H + r * Hb + u for c in range(up[i]) for u in range(Hb))
                  for r in range(cl)), False))
    for k, (k_in, k_out) in enumerate(head_dims):
        if k < len(head_dims) - 1:
            nb = k_out // cl
            cols = tuple(tuple(range(r * nb, (r + 1) * nb)) for r in range(cl))
        else:
            ql = Q // cl
            cols = tuple(tuple(range(r * ql, (r + 1) * ql)) + (Q, -1, -1, -1) for r in range(cl))
        units.append(ClusterUnit(f"wh{k}", f"wh{k}", f"bh{k}", k_in, k_out, cols, True))
    return tuple(units)


def smem_bytes(g: Geometry, cl: int, S: int, red_floats: int, n_resident: int,
               n_slots: int) -> int:
    """One block's dynamic shared memory, as ``sc_carve`` lays it out: the
    [x | h] rows, the partial sums, the units' c, h and cache columns, the
    candidates, the window (its tokens and its samples as products read
    them), the resident load's barrier, the resident elements and the
    ring."""
    H, _, fs, up, _, esize = g
    Hb, nt = H // cl, len(fs) - 1
    floats = (S * (2 * H + 4) + _r4(red_floats) + 2 * _r4(nt * S * Hb)
              + _r4(sum(S * u * Hb for u in up)) + _r4(cl * S * 2) + 2 * _r4(S * fs[0]) + 4)
    return 4 * floats + -(-n_resident * esize // 16) * 16 + n_slots * (SLOT_BYTES // esize) * esize


@functools.lru_cache(maxsize=None)
def _plan(g: Geometry, cl: int, S: int) -> ClusterPlan:
    H, Q, fs, _, head_dims, esize = g
    align = 16 // esize
    slot_elems = SLOT_BYTES // esize
    units = _units(g, cl) if cl in CLUSTER_SIZES and H % cl == 0 else ()
    offsets, pos = {}, 0

    def run(name, n):
        nonlocal pos
        offsets[name] = pos
        pos += -(-n // align) * align

    run("wbot", fs[-1] * H)
    run("bbot", H)
    for unit in units:
        run(unit.bias, len(unit.cols[0]))
    for unit in units:
        if unit.resident:
            run(unit.src, unit.K * len(unit.cols[0]))
    n_resident = pos
    for unit in units:
        if not unit.resident:
            run(unit.src, unit.K * len(unit.cols[0]))
    nb_max = max((len(unit.cols[0]) for unit in units), default=4)
    red = _r4(max(S * nb_max, MIN_RED_FLOATS))
    n_slots = MAX_SLOTS
    while n_slots > 0 and smem_bytes(g, cl, S, red, n_resident, n_slots) > SMEM_PER_BLOCK:
        n_slots -= 1
    smem = smem_bytes(g, cl, S, red, n_resident, n_slots)
    why = ""
    hidden = [w for dims in head_dims for w in dims][1:-1]
    if cl not in CLUSTER_SIZES:
        why = f"cluster size {cl} is not one of {CLUSTER_SIZES}"
    elif H % (8 * cl) or Q % (4 * cl):
        why = f"H {H} is not a multiple of {8 * cl}, or Q {Q} of {4 * cl}"
    elif head_dims[0][0] != H or any(w != H for w in hidden):
        why = "a hidden head layer is not as wide as the tiers"
    elif len(head_dims) > MAX_HEAD or len(fs) > MAX_TIERS:
        why = "too many head layers or tiers"
    elif any(fs[0] % f for f in fs):
        why = "a frame size does not divide the first"
    elif (nb_max // 4) * -(-S // 8) > CLUSTER_THREADS:
        why = f"{S} streams a group outgrow a product's tasks"
    elif n_slots < 2:
        why = f"{smem} bytes of shared memory a block leave no room for the ring"
    return ClusterPlan(cl=cl, S=S, units=units, offsets=offsets, n_resident=n_resident,
                       region=pos, red_floats=red, n_slots=n_slots, slot_elems=slot_elems,
                       smem_bytes=smem, fits=not why, why=why)


def cluster_plan(pack: SampleRNNPack, cl: int, S: int = 1) -> ClusterPlan:
    """The plan of ``pack``'s net on clusters of ``cl`` blocks, groups of
    ``S`` streams: a pure function of its widths, the pack's dtype, ``cl``
    and ``S``.  Each rank owns H / cl hidden units of every tier (their four
    gates' columns and their columns of each up-sampled cache row) and 1 / cl
    of each head layer's columns (the last layer's Q / cl logits, and the
    temperature logit, which every rank computes)."""
    return _plan(geometry(pack), cl, S)


def max_streams(pack: SampleRNNPack, cl: int) -> int:
    """The most streams a group whose plan fits (0: none)."""
    S = 0
    while S < 256 and _plan(geometry(pack), cl, S + 1).fits:
        S += 1
    return S


def _layout_np(plan: ClusterPlan, g: Geometry, offsets: Tuple, n_flat: int) -> np.ndarray:
    """The index into the pack's flat weights (``n_flat``: a zero) of every
    element of the relaid buffer: rank r's region at ``r * plan.region``."""
    off = dict((name, (o, shape)) for name, o, shape in offsets)
    H = g[0]
    idx = np.full((plan.cl, plan.region), n_flat, np.int64)

    def put(r, name, values):
        o = plan.offsets[name]
        idx[r, o : o + len(values)] = values

    def cols_of(name, cols):
        o, _ = off[name]
        c = np.asarray(cols, np.int64)
        return np.where(c >= 0, o + c, n_flat)

    for r in range(plan.cl):
        put(r, "wbot", off["wbot"][0] + np.arange(g[2][-1] * H))
        put(r, "bbot", off["bbot"][0] + np.arange(H))
        for unit in plan.units:
            put(r, unit.bias, cols_of(unit.bias, unit.cols[r]))
            c = np.asarray(unit.cols[r], np.int64)
            rows = off[unit.src][0] + np.arange(unit.K)[:, None] * unit.N + c[None, :]
            put(r, unit.src, np.where(c[None, :] >= 0, rows, n_flat).ravel())
    return idx.ravel()


@functools.lru_cache(maxsize=8)
def _layout_cached(g: Geometry, cl: int, offsets: Tuple, n_flat: int) -> np.ndarray:
    return _layout_np(_plan(g, cl, 1), g, offsets, n_flat)


def cluster_layout(pack: SampleRNNPack, cl: int) -> torch.Tensor:
    """The relaid weights of ``pack`` for clusters of ``cl`` blocks (every
    rank's region, one after the other), on the pack's device: one gather of
    the pack's flat weights by an index cached for the net's widths; kept on
    the pack.  The region does not depend on the streams a group."""
    cache = pack.__dict__.setdefault("_cluster", {})
    if cl not in cache:
        offsets = tuple(sorted((k, o, tuple(s)) for k, (o, s) in pack.offsets.items()))
        idx = _layout_cached(geometry(pack), cl, offsets, pack.flat.numel())
        flat = torch.cat([pack.flat, pack.flat.new_zeros(1)])
        cache[cl] = flat.index_select(0, torch.from_numpy(idx).to(pack.flat.device))
    return cache[cl]


def cluster_size_for(pack: SampleRNNPack, B: int) -> Optional[int]:
    """The cluster size :func:`decode_chunk` launches B streams of
    ``pack``'s net with (on CUDA tensors), from ``K2_CLUSTER_ROUTE`` at the
    pack's dtype; None for the block kernel."""
    for most, cl in K2_CLUSTER_ROUTE[pack.flat.dtype]:
        if B <= most:
            return cl if cl is not None and max_streams(pack, cl) > 0 else None
    return None


class _ScArgs(ctypes.Structure):
    """Mirror of ``ScArgs`` in ``csrc/samplernn_cluster.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("cw", ctypes.c_void_p),
        ("prompt", ctypes.c_void_p),
        ("win", ctypes.c_void_p),
        ("h", ctypes.c_void_p),
        ("c", ctypes.c_void_p),
        ("cache", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("t0", ctypes.c_longlong),
        ("out_t0", ctypes.c_longlong),
        ("off_win", ctypes.c_longlong * MAX_TIERS),
        ("off_bin", ctypes.c_longlong * MAX_TIERS),
        ("region", ctypes.c_longlong),
        ("o_wbot", ctypes.c_int),
        ("o_bbot", ctypes.c_int),
        ("o_bx", ctypes.c_int * MAX_TIERS),
        ("o_bup", ctypes.c_int * MAX_TIERS),
        ("o_wx", ctypes.c_int * MAX_TIERS),
        ("o_wup", ctypes.c_int * MAX_TIERS),
        ("o_bh", ctypes.c_int * MAX_HEAD),
        ("o_wh", ctypes.c_int * MAX_HEAD),
        *[(name, ctypes.c_int) for name in (
            "n_resident", "n_steps", "out_len", "B", "H", "Q", "rf", "prior_t", "n_tiers",
            "n_head", "argmax", "S", "red_floats", "n_slots", "slot_elems", "smem_bytes",
            "cache_rows")],
        ("seed", ctypes.c_uint),
        ("temperature", ctypes.c_void_p),
        ("min_temperature", ctypes.c_float),
        ("bf16", ctypes.c_int),
        ("fs", ctypes.c_int * MAX_TIERS),
        ("up", ctypes.c_int * MAX_TIERS),
        ("cache_row", ctypes.c_int * MAX_TIERS),
        ("head_in", ctypes.c_int * MAX_HEAD),
        ("head_out", ctypes.c_int * MAX_HEAD),
    ]


class _ClusterKernel:
    """The cluster kernel's library (one per process), its compiler output,
    and the clusters that fit, by (device, cluster size, dtype)."""

    lib = None
    build_log = ""
    clusters = {}


def build_cluster_kernel() -> Path:
    """Compile ``csrc/samplernn_cluster.cu`` for sm_90a into
    ``build/kernels/`` and return the library's path."""
    path, log = build_library(CLUSTER_SOURCE, "mmk_samplernn_cluster")
    if log:
        _ClusterKernel.build_log = log
    return path


def _cluster_library():
    if _ClusterKernel.lib is None:
        lib = ctypes.CDLL(str(build_cluster_kernel()))
        lib.mmk_sc_decode.argtypes = [ctypes.POINTER(_ScArgs), ctypes.c_int, ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.mmk_sc_decode.restype = ctypes.c_int
        lib.mmk_sc_args_size.argtypes = []
        lib.mmk_sc_args_size.restype = ctypes.c_int
        lib.mmk_sc_error_string.argtypes = [ctypes.c_int]
        lib.mmk_sc_error_string.restype = ctypes.c_char_p
        if lib.mmk_sc_args_size() != ctypes.sizeof(_ScArgs):
            raise RuntimeError("ScArgs layout differs between C and Python")
        _ClusterKernel.lib = lib
    return _ClusterKernel.lib


def _fill_cluster_args(a: _ScArgs, pack: SampleRNNPack, plan: ClusterPlan) -> None:
    fs, up, H = pack.frame_sizes, pack.up_factors, pack.hidden_dim
    n_t = len(fs) - 1
    o = plan.offsets
    a.region = plan.region
    a.o_wbot, a.o_bbot = o["wbot"], o["bbot"]
    row = 0
    for i in range(len(fs)):
        a.fs[i] = fs[i]
        if i < n_t:
            a.off_win[i], a.off_bin[i] = pack.offsets[f"win{i}"][0], pack.offsets[f"bin{i}"][0]
            a.o_bx[i], a.o_bup[i] = o[f"bx{i}"], o[f"bup{i}"]
            a.o_wx[i], a.o_wup[i] = o[f"wx{i}"], o[f"wup{i}"]
            a.up[i], a.cache_row[i] = up[i], row
            row += up[i]
    for k, (d_in, d_out) in enumerate(pack.head_dims):
        a.o_bh[k], a.o_wh[k] = o[f"bh{k}"], o[f"wh{k}"]
        a.head_in[k], a.head_out[k] = d_in, d_out
    a.n_resident, a.S, a.red_floats = plan.n_resident, plan.S, plan.red_floats
    a.n_slots, a.slot_elems, a.smem_bytes = plan.n_slots, plan.slot_elems, plan.smem_bytes
    a.H, a.Q, a.rf, a.n_tiers, a.n_head = H, pack.q_levels, fs[0], len(fs), len(pack.head_dims)
    a.cache_rows = sum(up)
    a.min_temperature = pack.min_temperature
    a.bf16 = int(pack.flat.dtype == torch.bfloat16)


def clusters_that_fit(pack: SampleRNNPack, cl: int) -> int:
    """The clusters of ``cl`` blocks the card runs at once at the largest
    group's shared memory (``cudaOccupancyMaxActiveClusters``), cached."""
    dev = pack.flat.device
    key = (str(dev), cl, pack.flat.dtype)
    if key not in _ClusterKernel.clusters:
        plan = cluster_plan(pack, cl, max_streams(pack, cl))
        a = _ScArgs()
        _fill_cluster_args(a, pack, plan)
        n = ctypes.c_int(0)
        err = _cluster_library().mmk_sc_decode(
            ctypes.byref(a), cl, torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(n), 1)
        if err != 0:
            raise RuntimeError("cluster decode kernel query failed: "
                               f"{_cluster_library().mmk_sc_error_string(err).decode()}")
        _ClusterKernel.clusters[key] = n.value
    return _ClusterKernel.clusters[key]


def streams_a_group(pack: SampleRNNPack, cl: int, B: int, clusters: int) -> int:
    """S: B streams spread over the clusters that fit, at most the plan's
    largest group (more groups then wait for a cluster)."""
    return max(1, min(max_streams(pack, cl), -(-B // clusters)))


def _launch_cluster(pack: SampleRNNPack, prompt, state: DecodeState, t0: int, n_steps: int,
                    out: torch.Tensor, out_t0: int, seed: int, temperature: Temperature,
                    cl: int, counts) -> bool:
    """Launch the cluster kernel on ``state`` and ``out``; False when there
    are no steps to run.  The wrapper ``counts`` (``decode_single`` or
    ``decode_chunk``) keeps the launch's clusters, their size and the
    streams a group."""
    _check_launch(pack, prompt, state, n_steps, out, "cluster decode kernel")
    temps = row_temperatures(temperature, prompt.shape[0], pack.flat.device)
    dev = pack.flat.device
    B, prior_t = prompt.shape
    if max_streams(pack, cl) == 0:
        raise ValueError(f"the net is outside the cluster kernel's plan at {cl} blocks: "
                         f"{cluster_plan(pack, cl).why}")
    if n_steps == 0:
        return False
    clusters = clusters_that_fit(pack, cl)
    plan = cluster_plan(pack, cl, streams_a_group(pack, cl, B, clusters))
    cw = cluster_layout(pack, cl)
    lib = _cluster_library()
    a = _ScArgs()
    _fill_cluster_args(a, pack, plan)
    a.w, a.cw, a.prompt = pack.flat.data_ptr(), cw.data_ptr(), prompt.data_ptr()
    a.win, a.h, a.c = state.win.data_ptr(), state.h.data_ptr(), state.c.data_ptr()
    a.cache, a.out = state.cache.data_ptr(), out.data_ptr()
    a.t0, a.out_t0 = t0, out_t0
    a.n_steps, a.out_len, a.B, a.prior_t = n_steps, out.shape[1], B, prior_t
    a.argmax = int(temps is None)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = None if temps is None else temps.tensor.data_ptr()
    n = ctypes.c_int(0)
    err = lib.mmk_sc_decode(ctypes.byref(a), cl, torch.cuda.current_stream(dev).cuda_stream,
                            ctypes.byref(n), 0)
    if err != 0:
        raise RuntimeError(
            f"cluster decode kernel launch failed: {lib.mmk_sc_error_string(err).decode()}")
    counts.last_clusters, counts.last_cluster_size, counts.last_streams = n.value, cl, plan.S
    return True


def _routed_launch(counts, pack: SampleRNNPack, prompt, state: DecodeState, t0: int,
                   n_steps: int, out: torch.Tensor, out_t0: int, seed: int,
                   temperature: Temperature, group: Optional[int], cl: Optional[int]):
    """Launch the kernel ``cl`` picks (None: the route, :func:`cluster_size_for`;
    8 or 16: the cluster kernel at that size; 0: the block kernel, ``group``
    streams a block) and count the launch on the wrapper ``counts``."""
    if cl is None:
        cl = cluster_size_for(pack, prompt.shape[0]) or 0
    if cl:
        launched = _launch_cluster(pack, prompt, state, t0, n_steps, out, out_t0, seed,
                                   temperature, cl, counts)
        counts.launches_cluster += int(launched)
    else:
        launched = _launch(pack, prompt, state, t0, n_steps, out, out_t0, seed, temperature,
                           group)
    if launched:
        counts.launches += 1
        counts.launches_bf16 += int(pack.flat.dtype == torch.bfloat16)


def decode_single(pack: SampleRNNPack, prompt: torch.Tensor, n_steps: int, seed: int,
                  temperature: Temperature, group: Optional[int] = None,
                  cl: Optional[int] = None) -> torch.Tensor:
    """K1's route: decode ``n_steps`` tokens after ``prompt`` (B, prior_t) in
    one launch.  Returns (B, n_steps) int32.  On CUDA tensors ``cl`` picks
    the kernel as :func:`decode_chunk`'s does: None the route
    (:func:`cluster_size_for`), 8 or 16 the cluster kernel at that size, 0
    the block kernel (``group`` streams a block)."""
    B, prior_t = prompt.shape
    rf = pack.frame_sizes[0]
    temperature = row_temperatures(temperature, B, prompt.device)
    state = init_decode_state(pack.net, prompt)
    n = prior_t + n_steps - rf
    if prompt.device.type == "cpu":
        return decode_plain(pack, prompt, state, rf, n, prior_t, n_steps, seed, temperature)
    out = torch.empty(B, n_steps, dtype=torch.int32, device=prompt.device)
    _routed_launch(decode_single, pack, prompt.to(torch.int32).contiguous(), state, rf, n, out,
                   prior_t, seed, temperature, group, cl)
    return out


def decode_chunk(pack: SampleRNNPack, prompt: torch.Tensor, state: DecodeState, t0: int,
                 n_steps: int, seed: int, temperature: Temperature,
                 group: Optional[int] = None, cl: Optional[int] = None) -> torch.Tensor:
    """K2's route: run steps ``t0 .. t0+n_steps-1`` on ``state`` (updated in
    place).  Returns the chunk's tokens, (B, n_steps) int32 — prompt tokens
    where ``t < prior_t``.  On CUDA tensors ``cl`` picks the kernel: None
    the route (:func:`cluster_size_for`), 8 or 16 the cluster kernel at that
    size, 0 the block kernel (``group`` streams a block)."""
    B = prompt.shape[0]
    temperature = row_temperatures(temperature, B, prompt.device)
    if prompt.device.type == "cpu":
        return decode_plain(pack, prompt, state, t0, n_steps, t0, n_steps, seed, temperature)
    out = torch.empty(B, n_steps, dtype=torch.int32, device=prompt.device)
    _routed_launch(decode_chunk, pack, prompt, state, t0, n_steps, out, t0, seed, temperature,
                   group, cl)
    return out


# kernel launches: all of them, those of the bf16 instantiation, and those
# of the cluster kernel; the last cluster launch: the clusters that fitted,
# their size, the streams a group
for _wrapper in (decode_single, decode_chunk):
    _wrapper.launches = _wrapper.launches_bf16 = _wrapper.launches_cluster = 0
    _wrapper.last_clusters = _wrapper.last_cluster_size = _wrapper.last_streams = 0
