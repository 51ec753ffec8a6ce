"""SimpleTransformer KV-ring stream decode: the CUDA kernel, its wrapper and its plain twin.

The kernel (``csrc/transformer_kv.cu``) replaces the TPU kernel
``make_transformer_kv_ring_pallas`` (K7, ``mimikit_tpu/ops/pallas_decode.py:1693``);
its plain twin :func:`decode_chunk_plain` is the port of that kernel's oracle,
``make_transformer_kv_ring_decoder`` (``:1478-1651``).  O(1) work a step:
iteration t pushes the token at s = t - 1 (the prompt's while s < prior_t,
else the carried token) with the absolute sinusoidal PE of s; per layer the
self-attention's K/V (from the layer's input) and the cross-attention's K/V
(from the PE'd input x0) are written into ring slot s % rf, then the layer
attends over the min(t, rf) valid slots; post-norm blocks, the head and the
sampling as in K6; rows before ``prior_t`` echo the prompt.  The state (token
carry and rings) is carried across calls, so a stream is one state and any
chunking of its steps.  This is PARITY.md #10: streaming-transformer
semantics, not the window re-feed's.

The weights are :func:`~.transformer_decode.transformer_weight_pack`'s: its
fused self q|k|v and all-layer cross k|v are what ``transformer_kv_weight_fuse``
(``:1654-1689``) builds.  Noise is the port's counter hash of (seed, absolute
step, stream, class), so the twin draws the kernel's noise and every
chunking draws the same tokens.

The wrapper's rule: a CPU tensor takes the plain twin, a CUDA tensor launches
the kernel or raises.  What bounds the kernel on an H100, and what its design
does about it, is in the source note of the ``.cu`` file.
"""
from __future__ import annotations

import ctypes
import dataclasses as dtc
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .noise import gumbel_noise
from .nvcc import CSRC, build_library
from .temperature import Temperature, row_temperatures
from .samplernn_decode import SMEM_PER_BLOCK, _check
from .transformer_decode import (
    _NEG,
    LAYER_KINDS,
    MAX_HEAD,
    TransformerPack,
    addmm_in,
    check_pack,
    fill_weight_args,
    dot_input,
    head_scores,
    layer_norm,
)

__all__ = ["TransformerKVState"]

SOURCE = CSRC / "transformer_kv.cu"


@dtc.dataclass
class TransformerKVState:
    """What a KV stream carries between calls, for B streams: ``tok`` (B,)
    int32, the token at the position before the next call's first step, and
    ``ring`` (L, B, rf, 4d) f32, slot s % rf of layer l holding
    [self K | self V | cross K | cross V] of the latest position s with that
    remainder."""

    tok: torch.Tensor
    ring: torch.Tensor


def init_kv_state(pack: TransformerPack, prompt: torch.Tensor) -> TransformerKVState:
    """State before step 1: the carry is ``prompt[:, 0]``, the rings zero."""
    B = prompt.shape[0]
    return TransformerKVState(
        tok=prompt[:, 0].to(torch.int32).clone(),  # a copy: the carry is written in place
        ring=torch.zeros(pack.n_layers, B, pack.rf, 4 * pack.dim, device=prompt.device),
    )


def pe_rows(start: int, n: int, d: int, device) -> torch.Tensor:
    """(n, d) absolute sinusoidal PE of positions start .. start + n - 1, in
    f32 as the oracle computes it (``pallas_decode.py:1525-1534``)."""
    div = np.exp(np.arange(0, d, 2).astype(np.float32) * (-np.log(10000.0) / d))
    div = torch.as_tensor(div, dtype=torch.float32, device=device)
    ang = torch.arange(start, start + n, device=device).to(torch.float32)[:, None] * div[None]
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)[:, : d // 2]
    return pe


def _attend_ring(q, K, V, vcount: int, n_heads: int):
    """q (B, d); K, V (B, rf, d) -> (B, d): slots below ``vcount`` valid, the
    scores scaled by 1/sqrt(dH) after the product (as the oracle scales)."""
    B, rf, d = K.shape
    dH = d // n_heads
    s = torch.einsum("bhd,brhd->bhr", q.reshape(B, n_heads, dH), K.reshape(B, rf, n_heads, dH))
    s = s * np.float32(1.0 / np.sqrt(dH))
    s = s.masked_fill(torch.arange(rf, device=q.device) >= vcount, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhr,brhd->bhd", p, V.reshape(B, rf, n_heads, dH)).reshape(B, d)


@torch.no_grad()
def decode_chunk_plain(pack: TransformerPack, prompt_T: torch.Tensor, state: TransformerKVState,
                       t0: int, n_steps: int, seed: int, temperature: Temperature,
                       return_scores: bool = False, accumulate: torch.dtype = torch.float32):
    """The plain PyTorch twin of the kernel (the oracle's step): steps ``t0 ..
    t0 + n_steps - 1`` on ``state`` (updated in place), teacher-forcing and
    echoing while ``t < prior_t``.  A bf16 pack is the bf16 route's twin
    (``pallas_decode.py:1716-1734``): its weights, biases, norm affines and
    embedding read as f32, each product's input rounded to bf16; the sums,
    the softmax, the norms' arithmetic, the PE rows and the rings stay f32.
    The products sum in ``accumulate`` (f32, as the kernel sums; float64 sums
    in another order, which measures how far the order alone moves the
    scores).  Returns (B, n_steps) int32, column i the token at position t0 +
    i; with ``return_scores`` also the (n_steps, B, Q) scores the argmax ran
    over."""
    prior_t, B = prompt_T.shape
    d, rf, L, Q = pack.dim, pack.rf, pack.n_layers, pack.q_levels
    dev = prompt_T.device
    temps = row_temperatures(temperature, B, dev)
    prompt_T = prompt_T.long()
    rnd, addmm = dot_input(pack), addmm_in(accumulate)
    emb, wckv, bckv = (pack.view(k).float() for k in ("emb", "wckv", "bckv"))
    pe = pe_rows(t0 - 1, n_steps, d, dev)
    ring = state.ring
    tok = state.tok.long()
    out = torch.zeros(B, n_steps, dtype=torch.int32, device=dev)
    all_scores = []
    for i in range(n_steps):
        t = t0 + i
        s = t - 1
        slot, vcount = s % rf, min(t, rf)
        x0 = emb[prompt_T[s] if s < prior_t else tok] + pe[i]
        ckv = addmm(bckv, rnd(x0), wckv)
        x = x0
        for l in range(L):
            (wqkv, bqkv, wo, bo, wcq, bcq, wco, bco,
             g1, b1_, g2, b2_, g3, b3_, w1, b1, w2, b2) = (w.float() for w in pack.layer(l))
            qkv = addmm(bqkv, rnd(x), wqkv)
            ring[l, :, slot, : 2 * d] = qkv[:, d:]
            a = _attend_ring(qkv[:, :d], ring[l, :, :, :d], ring[l, :, :, d : 2 * d], vcount,
                             pack.n_heads)
            x = layer_norm(x + addmm(bo, rnd(a), wo), g1, b1_)
            ring[l, :, slot, 2 * d :] = ckv[:, 2 * l * d : 2 * (l + 1) * d]
            q = addmm(bcq, rnd(x), wcq)
            a = _attend_ring(q, ring[l, :, :, 2 * d : 3 * d], ring[l, :, :, 3 * d :], vcount,
                             pack.n_heads)
            x = layer_norm(x + addmm(bco, rnd(a), wco), g2, b2_)
            h = torch.relu(addmm(b1, rnd(x), w1))
            x = layer_norm(x + addmm(b2, rnd(h), w2), g3, b3_)
        scores = head_scores(pack, x, accumulate)
        if temps is not None:
            scores = scores / temps.column() + gumbel_noise(seed, t, B, Q, dev)
        tok = prompt_T[t] if t < prior_t else torch.argmax(scores, dim=-1)
        out[:, i] = tok.to(torch.int32)
        if return_scores:
            all_scores.append(scores)
    state.tok.copy_(tok)
    if return_scores:
        return out, torch.stack(all_scores)
    return out


# -- the kernel: build, bind, launch -------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``TfKVArgs`` in ``csrc/transformer_kv.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("pe", ctypes.c_void_p),
        ("prompt_T", ctypes.c_void_p),
        ("tok", ctypes.c_void_p),
        ("ring", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("barriers", ctypes.c_void_p),
        ("off_emb", ctypes.c_longlong),
        ("off_ckv_w", ctypes.c_longlong),
        ("off_ckv_b", ctypes.c_longlong),
        ("off_lnf_w", ctypes.c_longlong),
        ("off_lnf_b", ctypes.c_longlong),
        ("off_layer", ctypes.c_longlong * len(LAYER_KINDS)),
        ("layer_stride", ctypes.c_longlong),
        ("off_wh", ctypes.c_longlong * MAX_HEAD),
        ("off_bh", ctypes.c_longlong * MAX_HEAD),
        ("t0", ctypes.c_longlong),
        ("head_in", ctypes.c_int * MAX_HEAD),
        ("head_out", ctypes.c_int * MAX_HEAD),
        ("B", ctypes.c_int),
        ("n_steps", ctypes.c_int),
        ("prior_t", ctypes.c_int),
        ("d", ctypes.c_int),
        ("n_heads", ctypes.c_int),
        ("ff", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("rf", ctypes.c_int),
        ("Q", ctypes.c_int),
        ("n_head", ctypes.c_int),
        ("final_ln", ctypes.c_int),
        ("argmax", ctypes.c_int),
        ("seed", ctypes.c_uint),
        ("temperature", ctypes.c_void_p),
        ("min_temperature", ctypes.c_float),
        ("inv_sqrt_dh", ctypes.c_float),
        ("bf16", ctypes.c_int),
    ]


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_kernel() -> Path:
    """Compile ``csrc/transformer_kv.cu`` for sm_90a into ``build/kernels/``
    (see :mod:`.nvcc`) and return the library's path."""
    path, log = build_library(SOURCE, "mmk_tf_kv")
    if log:
        _Kernel.build_log = log
    return path


def _library():
    if _Kernel.lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        lib.mmk_tf_kv_decode.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.mmk_tf_kv_decode.restype = ctypes.c_int
        lib.mmk_tf_kv_args_size.argtypes = []
        lib.mmk_tf_kv_args_size.restype = ctypes.c_int
        lib.mmk_tf_kv_scratch_floats.argtypes = [ctypes.POINTER(_Args)]
        lib.mmk_tf_kv_scratch_floats.restype = ctypes.c_longlong
        lib.mmk_tf_kv_smem_bytes.argtypes = [ctypes.POINTER(_Args)]
        lib.mmk_tf_kv_smem_bytes.restype = ctypes.c_longlong
        lib.mmk_tf_kv_error_string.argtypes = [ctypes.c_int]
        lib.mmk_tf_kv_error_string.restype = ctypes.c_char_p
        if lib.mmk_tf_kv_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("TfKVArgs layout differs between C and Python")
        _Kernel.lib = lib
    return _Kernel.lib


def decode_chunk(pack: TransformerPack, prompt_T: torch.Tensor, state: TransformerKVState,
                 t0: int, n_steps: int, temperature: Temperature, seed: int) -> torch.Tensor:
    """K7's route: run steps ``t0 .. t0 + n_steps - 1`` on ``state`` (updated
    in place) after ``prompt_T`` (prior_t, B).  Returns the chunk's tokens,
    (B, n_steps) int32: column i holds position ``t0 + i`` (the prompt's token
    where ``t0 + i < prior_t``)."""
    prior_t, B = prompt_T.shape
    dev = prompt_T.device
    temperature = row_temperatures(temperature, B, dev)
    if dev.type == "cpu":
        return decode_chunk_plain(pack, prompt_T, state, t0, n_steps, seed, temperature)
    check_pack(pack, dev, (torch.float32, torch.bfloat16))
    _check(prompt_T, "prompt_T", torch.int32, (prior_t, B), dev)
    _check(state.tok, "state.tok", torch.int32, (B,), dev)
    _check(state.ring, "state.ring", torch.float32,
           (pack.n_layers, B, pack.rf, 4 * pack.dim), dev)
    if prior_t < 1 or t0 < 1 or n_steps < 0:
        raise ValueError("empty prompt, t0 below 1 or negative step count")
    out = torch.empty(B, n_steps, dtype=torch.int32, device=dev)
    if n_steps == 0:
        return out
    pe = pe_rows(t0 - 1, n_steps, pack.dim, dev)
    lib = _library()
    a = _Args()
    fill_weight_args(a, pack)
    a.B, a.n_steps, a.prior_t, a.t0 = B, n_steps, prior_t, t0
    a.argmax = int(temperature is None)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = None if temperature is None else temperature.tensor.data_ptr()
    a.bf16 = int(pack.flat.dtype == torch.bfloat16)
    if lib.mmk_tf_kv_smem_bytes(ctypes.byref(a)) > SMEM_PER_BLOCK:
        raise ValueError("the net is outside the transformer kernels' limits")
    scratch = torch.empty(lib.mmk_tf_kv_scratch_floats(ctypes.byref(a)), device=dev)
    barriers = torch.zeros(1, dtype=torch.int64, device=dev)
    a.w, a.pe, a.prompt_T = pack.flat.data_ptr(), pe.data_ptr(), prompt_T.data_ptr()
    a.tok, a.ring, a.out = state.tok.data_ptr(), state.ring.data_ptr(), out.data_ptr()
    a.scratch, a.barriers = scratch.data_ptr(), barriers.data_ptr()
    err = lib.mmk_tf_kv_decode(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("transformer KV decode kernel launch failed: "
                           f"{lib.mmk_tf_kv_error_string(err).decode()}")
    decode_chunk.launches += 1
    decode_chunk.launches_bf16 += a.bf16
    decode_chunk.last_barriers = barriers
    return out


# kernel launches, all of them and those of the bf16 instantiation
decode_chunk.launches = decode_chunk.launches_bf16 = 0
# the grid barriers block 0 passed in the last launch, a (1,) device tensor:
# one before the first step, then 3L + 1 a step
decode_chunk.last_barriers = None
