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

What bounds the kernel on an H100, and what its design does about it, is in
the source note at the top of the ``.cu`` file.

The wrappers' rule: a CPU tensor takes the plain PyTorch twin
(:func:`decode_plain`); a CUDA tensor launches the kernel or raises.  There is
no fallback.  The kernel is built with ``nvcc`` at first use into
``build/kernels/`` (see :mod:`.nvcc`) — nothing is compiled or imported when
this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses as dtc
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .noise import gumbel_noise
from .nvcc import CSRC, build_library
from .samplernn_decode import SMEM_PER_BLOCK, _check, _head_is_plain_mish

__all__ = ["wavenet_weight_pack", "WaveNetPack", "WaveNetDecodeState"]

MAX_LAYERS = 64
MAX_HEAD = 8
THREADS = 1024  # a block's threads, WN_THREADS in the .cu file
GROUPS = (1, 2, 4, 8, 16)  # the streams a block can own
SOURCE = CSRC / "wavenet_decode.cu"


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
        tok=prompt[:, 0].to(torch.int32).contiguous(),
        rings=torch.zeros(sum(pack.dilations), B, pack.dim, device=prompt.device),
        dilations=pack.dilations,
    )


# -- the plain twin ----------------------------------------------------------------

@torch.no_grad()
def decode_plain(pack: WaveNetPack, prompt: torch.Tensor, state: WaveNetDecodeState, t0: int,
                 n_steps: int, out_t0: int, out_len: int, seed: int,
                 temperature: Optional[float], return_scores: bool = False):
    """The plain PyTorch twin of the kernel: ``n_steps`` steps from absolute
    step ``t0`` with the kernel's arithmetic, sampling rule and noise,
    teacher-forcing while ``t < prior_t``.  ``state`` is updated in place.
    Returns ``out`` (B, out_len) int32 holding the tokens of steps
    ``out_t0 ..``; with ``return_scores`` also the (n_steps, B, Q) scores the
    argmax ran over (tempered logits, plus noise when sampling)."""
    B, prior_t = prompt.shape
    D, S, Q = pack.dim, pack.skips_dim, pack.q_levels
    dev = prompt.device
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
        if temperature is not None:
            scores = scores / temperature + gumbel_noise(seed, t, B, Q, dev)
        tok = prompt[:, t] if t < prior_t else torch.argmax(scores, dim=-1)
        if 0 <= t - out_t0 < out_len:
            out[:, t - out_t0] = tok.to(torch.int32)
        if return_scores:
            scores_all.append(scores)
    state.tok.copy_(tok)
    if return_scores:
        return out, torch.stack(scores_all)
    return out


# -- the kernel: build, bind, launch -------------------------------------------------

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
        ("temperature", ctypes.c_float),
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
            out: torch.Tensor, out_t0: int, seed: int, temperature: Optional[float],
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
    if temperature is not None and not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
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
    a.argmax, a.group = int(temperature is None), group
    a.ds, a.red = ds, red
    a.seed = seed & 0xFFFFFFFF
    a.temperature = 1.0 if temperature is None else float(temperature)
    a.min_temperature = pack.min_temperature
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mmk_wavenet_decode(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(
            f"wavenet decode kernel launch failed: {lib.mmk_wavenet_error_string(err).decode()}"
        )
    return True


def decode_single(pack: WaveNetPack, prompt: torch.Tensor, n_steps: int, seed: int,
                  temperature: Optional[float], group: Optional[int] = None) -> torch.Tensor:
    """K4's route: decode ``n_steps`` tokens after ``prompt`` (B, prior_t) in
    one launch, from zero rings.  Returns (B, n_steps) int32."""
    B, prior_t = prompt.shape
    state = init_decode_state(pack, prompt)
    n = prior_t + n_steps - 1
    if prompt.device.type == "cpu":
        return decode_plain(pack, prompt, state, 1, n, prior_t, n_steps, seed, temperature)
    out = torch.empty(B, n_steps, dtype=torch.int32, device=prompt.device)
    if _launch(pack, prompt.to(torch.int32).contiguous(), state, 1, n, out, prior_t, seed,
               temperature, group):
        decode_single.launches += 1
    return out


def decode_chunk(pack: WaveNetPack, prompt: torch.Tensor, state: WaveNetDecodeState, t0: int,
                 n_steps: int, seed: int, temperature: Optional[float],
                 group: Optional[int] = None) -> torch.Tensor:
    """K5's route: run steps ``t0 .. t0+n_steps-1`` on ``state`` (updated in
    place).  Returns the chunk's tokens, (B, n_steps) int32: column j holds
    position ``t0 + j`` (the prompt's token where ``t0 + j < prior_t``)."""
    B = prompt.shape[0]
    if prompt.device.type == "cpu":
        return decode_plain(pack, prompt, state, t0, n_steps, t0, n_steps, seed, temperature)
    out = torch.empty(B, n_steps, dtype=torch.int32, device=prompt.device)
    if _launch(pack, prompt, state, t0, n_steps, out, t0, seed, temperature, group):
        decode_chunk.launches += 1
    return out


decode_single.launches = 0
decode_chunk.launches = 0
