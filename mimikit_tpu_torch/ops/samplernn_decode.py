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
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..modules.activations import mish
from .noise import gumbel_noise
from .nvcc import CSRC, build_library

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
        win=prompt[:, : net.rf].to(torch.int32).contiguous(),
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
                 temperature: Optional[float], return_scores: bool = False,
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
        if temperature is not None:
            scores = scores / temperature + gumbel_noise(
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
        ("temperature", ctypes.c_float),
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


def _launch(pack: SampleRNNPack, prompt, state: DecodeState, t0: int, n_steps: int,
            out: torch.Tensor, out_t0: int, seed: int, temperature: Optional[float],
            group: Optional[int] = None) -> bool:
    """Launch the kernel on ``state`` and ``out``; False when there are no
    steps to run (nothing is launched)."""
    dev = pack.flat.device
    if dev.type != "cuda":
        raise ValueError(f"the decode kernel runs on CUDA tensors, got {dev}")
    fs, up, H, Q = pack.frame_sizes, pack.up_factors, pack.hidden_dim, pack.q_levels
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
    if temperature is not None and not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if n_steps == 0:
        return False
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
    a.argmax = int(temperature is None)
    widest = max(4 * H, Q + 1, *(d for dims in pack.head_dims for d in dims))
    a.dstride = -(-widest // 4) * 4
    # per stream: three rows of dstride floats and the window, as the kernel lays out
    a.group = group or _group_for(B, dev, 4 * (3 * a.dstride + rf))
    a.cache_rows = sum(up)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = 1.0 if temperature is None else float(temperature)
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


def decode_single(pack: SampleRNNPack, prompt: torch.Tensor, n_steps: int, seed: int,
                  temperature: Optional[float], group: Optional[int] = None) -> torch.Tensor:
    """K1's route: decode ``n_steps`` tokens after ``prompt`` (B, prior_t) in
    one launch.  Returns (B, n_steps) int32."""
    B, prior_t = prompt.shape
    rf = pack.frame_sizes[0]
    state = init_decode_state(pack.net, prompt)
    n = prior_t + n_steps - rf
    if prompt.device.type == "cpu":
        return decode_plain(pack, prompt, state, rf, n, prior_t, n_steps, seed, temperature)
    out = torch.empty(B, n_steps, dtype=torch.int32, device=prompt.device)
    if _launch(pack, prompt.to(torch.int32).contiguous(), state, rf, n, out, prior_t, seed,
               temperature, group):
        decode_single.launches += 1
        decode_single.launches_bf16 += int(pack.flat.dtype == torch.bfloat16)
    return out


def decode_chunk(pack: SampleRNNPack, prompt: torch.Tensor, state: DecodeState, t0: int,
                 n_steps: int, seed: int, temperature: Optional[float],
                 group: Optional[int] = None) -> torch.Tensor:
    """K2's route: run steps ``t0 .. t0+n_steps-1`` on ``state`` (updated in
    place).  Returns the chunk's tokens, (B, n_steps) int32 — prompt tokens
    where ``t < prior_t``."""
    B = prompt.shape[0]
    if prompt.device.type == "cpu":
        return decode_plain(pack, prompt, state, t0, n_steps, t0, n_steps, seed, temperature)
    out = torch.empty(B, n_steps, dtype=torch.int32, device=prompt.device)
    if _launch(pack, prompt, state, t0, n_steps, out, t0, seed, temperature, group):
        decode_chunk.launches += 1
        decode_chunk.launches_bf16 += int(pack.flat.dtype == torch.bfloat16)
    return out


# kernel launches, all of them and those of the bf16 instantiation
decode_single.launches = decode_single.launches_bf16 = 0
decode_chunk.launches = decode_chunk.launches_bf16 = 0
