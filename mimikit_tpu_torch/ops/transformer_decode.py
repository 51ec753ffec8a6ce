"""SimpleTransformer window-refeed decode: the CUDA kernel, its wrapper and its plain twin.

The kernel (``csrc/transformer_decode.cu``) replaces the TPU kernel
``make_transformer_pallas_decoder`` (K6, ``mimikit_tpu/ops/pallas_decode.py:1248``,
with ``_bd_masks``/``_bd_attend`` ``:1079-1139``): the whole autoregressive
loop in one launch.  Each step embeds the (B, rf) token window, adds the
window-relative sinusoidal PE, runs the post-norm decoder stack (causal
self-attention, causal cross-attention on the PE'd window, ReLU FFN, three
layer norms), an optional final norm, the Mish head on each stream's last
row, divides the logits by max(sigmoid(extra logit), min_temperature), then
by the temperature plus Gumbel noise when sampling, takes the argmax and
shifts the window.

This module holds:

* :func:`supports_kernel_decode`, the scope gate (``supports_pallas_transformer``,
  ``pallas_decode.py:1144-1179``);
* :func:`transformer_weight_pack`, the kernels' view of the weights — one
  layout for K6 and K7 (``transformer_weight_pack`` and
  ``transformer_kv_weight_fuse``, ``:1182-1244,1654-1689``): a layer's self
  q|k|v in one (d, 3d) product and every layer's cross k|v in one (d, 2Ld)
  product of the PE'd input;
* :func:`window_scores` and :func:`decode_window_plain`, the plain twin;
* :func:`decode_window`, the counted wrapper.

What bounds the kernel on an H100, and what its design does about it, is in
the source note at the top of the ``.cu`` file.  The wrapper's rule: a CPU
tensor takes the plain twin, a CUDA tensor launches the kernel or raises;
there is no fallback.  The kernel is built with ``nvcc`` at first use into
``build/kernels/`` (:mod:`.nvcc`); nothing is compiled or imported when this
module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses as dtc
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .noise import gumbel_noise
from .nvcc import CSRC, build_library
from .temperature import Temperature, row_temperatures
from .samplernn_decode import SMEM_PER_BLOCK, _check, _head_is_plain_mish

__all__ = ["transformer_weight_pack", "TransformerPack"]

THREADS = 256  # a block's threads, TF_THREADS in csrc/transformer_common.cuh
MAX_HEAD = 8
MAX_WIDTH = 4096  # every head layer's width at most this
QUERY_BLOCK = 8  # query rows a window-attention task, TF_QB
KEY_TILE = 64  # keys an attention tile, TF_KT
FFN_SLICE = 64  # FFN hidden units a task, TF_HS
COL_TILE = 64  # columns a q|k|v task, TF_TN
MAX_ROWS = 16  # rows a task at most, TF_R
TWIN_BATCH = 64  # teacher-forced positions the plain twin scores in one batch
SOURCE = CSRC / "transformer_decode.cu"
LAYER_KINDS = ("wqkv", "bqkv", "wo", "bo", "wcq", "bcq", "wco", "bco", "ln1_w", "ln1_b",
               "ln2_w", "ln2_b", "ln3_w", "ln3_b", "w1", "b1", "w2", "b2")
_NEG = torch.finfo(torch.float32).min


# -- scope gate (pallas_decode.py:1144-1179) -------------------------------------

def supports_kernel_decode(net, wbytes: int = 4) -> bool:
    """True for the standard SimpleTransformer that the kernels decode: the
    nets :func:`_standard_transformer` admits, within the kernels' own limits
    (:func:`_fits`) for weights of ``wbytes`` bytes (4, or 2 for K7's bf16
    pack).  A standard net beyond the f32 limits takes the batched window
    re-feed route, about 24 times slower a step at B=1 on an H100 at
    transformer8l's widths (``chip_smoke.py`` times both routes); one beyond
    the bf16 limits only streams through the f32 route.  A warning says so,
    once for each net shape."""
    if not _standard_transformer(net):
        return False
    cfg = net.config
    t_mod = cfg.io_spec.targets[0].module
    widths = (t_mod.hidden_dim, cfg.io_spec.targets[0].elem_type.size + 1)
    if _fits(cfg.model_dim, cfg.n_heads, cfg.feedforward_dim, t_mod.n_hidden_layers + 2, widths,
             wbytes):
        return True
    where = ("it decodes through the window re-feed route, one forward a step" if wbytes == 4
             else "MMK_DECODE_BF16=1 streams it through the f32 route instead")
    warnings.warn(
        f"this SimpleTransformer (model_dim {cfg.model_dim}, n_heads {cfg.n_heads},"
        f" feedforward_dim {cfg.feedforward_dim}, head widths {widths}) is outside the transformer"
        f" decode kernels' limits for {8 * wbytes}-bit weights (see"
        f" ops.transformer_decode.supports_kernel_decode): {where}", stacklevel=2)
    return False


def _standard_transformer(net) -> bool:
    """The scope of the TPU kernel's gate: post-norm ReLU blocks (the core's
    own), one embedding input, one learned-temperature plain-Mish MLP head,
    a categorical objective."""
    from ..features.functionals import Discrete
    from ..modules.io import EmbeddingIO, MLPIO

    if type(net).__name__ != "SimpleTransformer":
        return False
    cfg = net.config
    if cfg.model_dim % cfg.n_heads != 0:
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
    if getattr(t_mod, "weight_norm", False) or getattr(cfg, "weight_norm", False):
        return False
    return str(getattr(io.targets[0].objective, "objective_type", "")) == "categorical_dist"


def _fits(d: int, n_heads: int, ff: int, n_head_layers: int, head_widths,
          wbytes: int = 4) -> bool:
    """The kernels' limits for weights of ``wbytes`` bytes (4: f32, 2: the
    bf16 pack): d, ff and d / n_heads multiples of 16 / wbytes elements (4
    for f32, 8 for bf16: 16-byte loads and bulk copies), at most ``MAX_HEAD``
    head layers of at most ``MAX_WIDTH`` columns, and a block's shared memory
    (:func:`smem_bytes`) within what a block may use.  None depends on rf:
    attention stages its keys ``KEY_TILE`` at a time.  The largest task's
    weight slice, 4 d²/n_heads weights, sets the limit: in f32 with 8 heads
    d up to 256 fits (transformer8l's widths take 195 KB of the 227), with 4
    heads d up to 192."""
    m = 16 // wbytes
    if d % m or ff % m or (d // n_heads) % m:
        return False
    return (n_head_layers <= MAX_HEAD and max(head_widths) <= MAX_WIDTH
            and smem_bytes(d, n_heads, ff, max(*head_widths, d), wbytes) <= SMEM_PER_BLOCK)


def smem_bytes(d: int, n_heads: int, ff: int, head_width: int, wbytes: int = 4) -> int:
    """A block's dynamic shared memory in K6 (``tf_smem`` in
    ``csrc/transformer_common.cuh``; K7 needs no more) for weights of
    ``wbytes`` bytes: the weight buffer (the largest task's weight slice),
    its columns' biases and its fold's bias and norm (each in the weights'
    type), ``MAX_ROWS`` rows of x and of x0, the q|k|v, attention and
    FFN-hidden rows, one scratch region for the products' group sums, an
    attention task's tile of ``KEY_TILE`` keys and values with its queries,
    running maxima and sums and scores, or the head, and the weight buffer's
    mbarrier."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    m = 16 // wbytes  # weights in 16 bytes
    rw = lambda n: -(-n // m) * m  # noqa: E731
    as_floats = lambda n: r4(-(-n * wbytes // 4))  # noqa: E731  n weights, in whole floats
    dh, hs = d // n_heads, min(ff, FFN_SLICE)
    w = max(rw(3 * d * dh) + dh * d, rw(d * dh) + rw(2 * d * dh) + dh * d, rw(d * hs) + hs * d,
            d * COL_TILE)
    attn = (r4(KEY_TILE * (dh + 1)) + r4(KEY_TILE * dh) + r4(QUERY_BLOCK * dh)
            + r4(2 * QUERY_BLOCK) + (THREADS // 32) * KEY_TILE)
    w32 = -(-head_width // 32) * 32
    head = r4(d) + 2 * r4(head_width) + max(w32, THREADS) + 2 * (THREADS // 32)
    rows = MAX_ROWS * (2 * d + r4(3 * dh) + r4(dh) + r4(hs))
    bias = as_floats(max(3 * dh, COL_TILE, hs))
    return 4 * (as_floats(w) + bias + as_floats(3 * d) + rows
                + r4(max(THREADS * MAX_ROWS, attn, head)) + 4)


# -- weight pack ---------------------------------------------------------------------

@dtc.dataclass
class TransformerPack:
    """The kernels' view of a SimpleTransformer: every weight in one flat
    buffer (float32; bfloat16 for K7's bf16 route), each tensor's (offset,
    shape) in it, the static sizes, and the window's PE table (rf, d), f32.
    Layer l's tensors are named ``<kind>.<l>`` (``LAYER_KINDS``) and lie
    ``layer_stride`` elements after layer l-1's.  The
    matrices in ``blocked`` are stored as column blocks of the given width,
    each block (K, width) row-major, the blocks in column order (the last one
    narrower when the width does not divide N): a kernel task's column slice
    is then one contiguous run of memory, one bulk copy."""

    flat: torch.Tensor
    offsets: dict
    blocked: dict
    dim: int
    n_heads: int
    ff: int
    n_layers: int
    rf: int
    q_levels: int
    head_dims: Tuple[Tuple[int, int], ...]
    min_temperature: float
    final_ln: bool
    layer_stride: int
    pe_window: torch.Tensor

    def view(self, name: str) -> torch.Tensor:
        """The tensor ``name`` (a blocked matrix reassembled, as a copy)."""
        off, shape = self.offsets[name]
        n = int(np.prod(shape))
        if name not in self.blocked:
            return self.flat[off : off + n].view(shape)
        (K, N), bw = shape, self.blocked[name]
        full = N // bw
        cols = [self.flat[off : off + K * full * bw].view(full, K, bw).permute(1, 0, 2)
                .reshape(K, full * bw)]
        if N > full * bw:
            cols.append(self.flat[off + K * full * bw : off + n].view(K, N - full * bw))
        return torch.cat(cols, 1)

    def layer(self, l: int):
        """Layer l's tensors in ``LAYER_KINDS`` order."""
        return [self.view(f"{k}.{l}") for k in LAYER_KINDS]

    @property
    def wbytes(self) -> int:
        """Bytes a weight: 4 (f32) or 2 (bf16)."""
        return self.flat.element_size()


@torch.no_grad()
def transformer_weight_pack(net, dtype: torch.dtype = torch.float32) -> TransformerPack:
    """Flatten ``net``'s weights into the kernels' layout, on its device,
    stored in ``dtype``: float32 (K6 and K7), or bfloat16 (K7's bf16 route,
    ``MMK_DECODE_BF16=1``; ``pallas_decode.py:2200-2207`` casts every weight,
    bias, norm affine and the embedding table).  Each tensor is built in f32
    and cast once.

    ``emb`` (Q, d); per layer l: ``wqkv`` = [Wq | Wk | Wv] (d, 3d) of the
    self-attention and ``bqkv``, ``wo`` (d, d), ``bo``, the cross-attention's
    ``wcq`` (d, d), ``bcq``, ``wco``, ``bco``, the three norms, ``w1`` (d, ff),
    ``b1``, ``w2`` (ff, d), ``b2``; then ``wckv`` (d, 2Ld) holding layer l's
    cross [Wk | Wv] in columns 2ld .. 2(l+1)d, and ``bckv``; the final norm
    (``lnf_w``, ``lnf_b``) when the net has one; the head chain
    ``wh{k}``/``bh{k}``.  Every product is ``x @ W`` (K, N); ``wqkv``,
    ``wcq`` and ``wckv`` are stored in column blocks of a head's width, ``w1``
    in blocks of ``FFN_SLICE`` columns (the kernels' task slices), the rest
    row-major; each tensor starts at a multiple of 16 bytes."""
    from ..networks.transformers import sinusoidal_pe

    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the transformer kernels take float32 or bfloat16 weights, not {dtype}")
    align = 16 // torch.empty((), dtype=dtype).element_size()
    cfg = net.config
    d, L = cfg.model_dim, cfg.num_layers
    dh, hs = d // cfg.n_heads, min(cfg.feedforward_dim, FFN_SLICE)
    parts, offsets, blocked, pos = [], {}, {}, 0

    def add(name, x, block=None):
        nonlocal pos
        x = x.detach().to(torch.float32)
        offsets[name] = (pos, tuple(x.shape))
        if block is not None:
            blocked[name] = block
            K, N = x.shape
            full = N // block * block  # whole blocks, then the narrower last one
            x = torch.cat([x[:, :full].reshape(K, -1, block).transpose(0, 1).reshape(-1),
                           x[:, full:].reshape(-1)])
        x = x.to(dtype).contiguous()
        pad = -x.numel() % align
        parts.append(x.reshape(-1))
        if pad:
            parts.append(x.new_zeros(pad))
        pos += x.numel() + pad

    add("emb", net.input_module.heads[0][0].weight)
    ckv_w, ckv_b = [], []
    for l, layer in enumerate(net.model.layers):
        sa, ca = layer.self_attn, layer.multihead_attn
        add(f"wqkv.{l}", sa.in_proj_weight.t(), dh)
        add(f"bqkv.{l}", sa.in_proj_bias)
        add(f"wo.{l}", sa.out_proj.weight.t())
        add(f"bo.{l}", sa.out_proj.bias)
        add(f"wcq.{l}", ca.in_proj_weight[:d].t(), dh)
        add(f"bcq.{l}", ca.in_proj_bias[:d])
        add(f"wco.{l}", ca.out_proj.weight.t())
        add(f"bco.{l}", ca.out_proj.bias)
        for k, norm in enumerate((layer.norm1, layer.norm2, layer.norm3)):
            add(f"ln{k + 1}_w.{l}", norm.weight)
            add(f"ln{k + 1}_b.{l}", norm.bias)
        add(f"w1.{l}", layer.linear1.weight.t(), hs)
        add(f"b1.{l}", layer.linear1.bias)
        add(f"w2.{l}", layer.linear2.weight.t())
        add(f"b2.{l}", layer.linear2.bias)
        ckv_w.append(ca.in_proj_weight[d:].t())  # (d, 2d): [Wk | Wv]
        ckv_b.append(ca.in_proj_bias[d:])
    add("wckv", torch.cat(ckv_w, 1), dh)
    add("bckv", torch.cat(ckv_b))
    final_ln = net.model.norm is not None
    if final_ln:
        add("lnf_w", net.model.norm.weight)
        add("lnf_b", net.model.norm.bias)
    mlp = net.output_modules[0].estimator[0]
    linears = list(mlp.fc)[0::2]
    for k, lin in enumerate(linears):
        add(f"wh{k}", lin.weight.t())
        add(f"bh{k}", lin.bias)
    stride = offsets["wqkv.1"][0] - offsets["wqkv.0"][0] if L > 1 else 0
    for l in range(1, L):  # every layer lies one stride after the one before
        for k in LAYER_KINDS:
            assert offsets[f"{k}.{l}"][0] == offsets[f"{k}.0"][0] + l * stride
    flat = torch.cat(parts)
    return TransformerPack(
        flat=flat, offsets=offsets, blocked=blocked, dim=d, n_heads=cfg.n_heads,
        ff=cfg.feedforward_dim, n_layers=L, rf=cfg.rf, q_levels=linears[-1].out_features - 1,
        head_dims=tuple((lin.in_features, lin.out_features) for lin in linears),
        min_temperature=float(mlp.min_temperature), final_ln=final_ln, layer_stride=stride,
        pe_window=torch.from_numpy(sinusoidal_pe(cfg.rf, d)).to(flat.device),
    )


# -- the plain twin ----------------------------------------------------------------

def layer_norm(x, weight, bias, eps: float = 1e-5):
    """flax's LayerNorm (``pallas_decode.py:1317-1322``): var = max(0,
    E[x²] - E[x]²).  The network, both kernels and both plain twins use this
    formula.  A bf16 ``x`` is normed in f32 and the result rounded to bf16,
    as flax computes it with bf16 inputs and parameters."""
    dt = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    mean2 = (x * x).mean(-1, keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    return ((x - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(dt)


def dot_input(pack: TransformerPack):
    """How a product of the pack's kernels reads its input: as it is for an
    f32 pack, rounded to bf16 for a bf16 pack (``pallas_decode.py:1817``:
    every dot input ``.astype(dt)``; the products and sums stay f32)."""
    if pack.flat.dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def addmm_in(acc: torch.dtype):
    """``torch.addmm`` with the products summed in ``acc`` and the result in
    f32 (for f32, ``torch.addmm`` itself)."""
    if acc == torch.float32:
        return torch.addmm
    return lambda b, x, w: torch.addmm(b.to(acc), x.to(acc), w.to(acc)).float()


def head_scores(pack: TransformerPack, x: torch.Tensor,
                accumulate: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, d) rows after the last layer -> (N, Q) scores: the optional final
    norm, the Mish MLP, logits[:Q] / max(sigmoid(logits[Q]), min_temperature).
    A bf16 pack's weights are read as f32 and each product's input rounded
    to bf16; the products sum in ``accumulate``."""
    rnd, mm = dot_input(pack), addmm_in(accumulate)
    if pack.final_ln:
        x = layer_norm(x, pack.view("lnf_w").float(), pack.view("lnf_b").float())
    n = len(pack.head_dims)
    for k in range(n):
        x = mm(pack.view(f"bh{k}").float(), rnd(x), pack.view(f"wh{k}").float())
        if k < n - 1:
            x = x * torch.tanh(F.softplus(x))
    Q = pack.q_levels
    return x[:, :Q] / torch.clamp_min(torch.sigmoid(x[:, Q : Q + 1]), pack.min_temperature)


def _attend_causal(q, k, v, n_heads: int):
    """(N, rf, d) q, k, v -> (N, rf, d): causal attention per head, q scaled
    by 1/sqrt(dH) first (as K6 scales it), masked scores at finfo.min."""
    N, rf, d = q.shape
    dH = d // n_heads
    q = q.reshape(N, rf, n_heads, dH) * np.float32(1.0 / np.sqrt(dH))
    s = torch.einsum("nihd,njhd->nhij", q, k.reshape(N, rf, n_heads, dH))
    mask = torch.tril(torch.ones(rf, rf, dtype=torch.bool, device=q.device))
    p = torch.softmax(s.masked_fill(~mask, _NEG), dim=-1)
    return torch.einsum("nhij,njhd->nihd", p, v.reshape(N, rf, n_heads, dH)).reshape(N, rf, d)


@torch.no_grad()
def window_scores(pack: TransformerPack, win: torch.Tensor) -> torch.Tensor:
    """The K6 step without its sampling: (N, rf) token windows -> (N, Q)
    scores of the token after each window."""
    d, L = pack.dim, pack.n_layers
    x = pack.view("emb")[win.long()] + pack.pe_window
    mkv = torch.matmul(x, pack.view("wckv")) + pack.view("bckv")
    for l in range(L):
        (wqkv, bqkv, wo, bo, wcq, bcq, wco, bco,
         g1, b1_, g2, b2_, g3, b3_, w1, b1, w2, b2) = pack.layer(l)
        qkv = torch.matmul(x, wqkv) + bqkv
        a = _attend_causal(qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], pack.n_heads)
        x = layer_norm(x + (torch.matmul(a, wo) + bo), g1, b1_)
        q = torch.matmul(x, wcq) + bcq
        kv = mkv[..., 2 * l * d : 2 * (l + 1) * d]
        a = _attend_causal(q, kv[..., :d], kv[..., d:], pack.n_heads)
        x = layer_norm(x + (torch.matmul(a, wco) + bco), g2, b2_)
        h = torch.relu(torch.matmul(x, w1) + b1)
        x = layer_norm(x + (torch.matmul(h, w2) + b2), g3, b3_)
    return head_scores(pack, x[:, -1])


@torch.no_grad()
def decode_window_plain(pack: TransformerPack, tokens: torch.Tensor, t0: int, n_steps: int,
                        seed: int, temperature: Temperature, return_scores: bool = False):
    """The plain PyTorch twin of the kernel: the tokens at positions ``t0 ..
    t0 + n_steps - 1`` after ``tokens`` (B, T), position p read from the
    window of the rf tokens before it.  Positions below T are the given
    tokens (teacher forcing); their scores are computed ``TWIN_BATCH``
    positions at once.  Sampling adds the noise of (seed, p, stream, class).  Returns
    (B, n_steps) int32; with ``return_scores`` also the (n_steps, B, Q)
    scores the argmax ran over."""
    B, T = tokens.shape
    rf, Q = pack.rf, pack.q_levels
    temps = row_temperatures(temperature, B, tokens.device)
    if t0 < rf:
        raise ValueError(f"position {t0} has no full window of {rf} tokens")
    buf = torch.cat([tokens.long(), tokens.new_zeros(B, max(0, t0 + n_steps - T)).long()], 1)
    out = torch.zeros(B, n_steps, dtype=torch.int32, device=tokens.device)
    all_scores = []
    p, end = t0, t0 + n_steps
    while p < end:
        m = min(TWIN_BATCH, end - p, T - p) if p < T else 1
        wins = torch.stack([buf[:, q - rf : q] for q in range(p, p + m)])  # (m, B, rf)
        sc = window_scores(pack, wins.reshape(m * B, rf)).reshape(m, B, Q)
        for j in range(m):
            s = sc[j]
            if temps is not None:
                s = s / temps.column() + gumbel_noise(seed, p + j, B, Q, tokens.device)
            if p + j >= T:
                buf[:, p + j] = torch.argmax(s, dim=-1)
            out[:, p + j - t0] = buf[:, p + j].to(torch.int32)
            if return_scores:
                all_scores.append(s)
        p += m
    if return_scores:
        return out, torch.stack(all_scores)
    return out


# -- the kernel: build, bind, launch -------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``TfWindowArgs`` in ``csrc/transformer_decode.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("pe", ctypes.c_void_p),
        ("buf", ctypes.c_void_p),
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
    ]


def fill_weight_args(a, pack: TransformerPack) -> None:
    """The weight offsets and sizes both kernels' argument structs share."""
    a.off_emb = pack.offsets["emb"][0]
    a.off_ckv_w, a.off_ckv_b = pack.offsets["wckv"][0], pack.offsets["bckv"][0]
    if pack.final_ln:
        a.off_lnf_w, a.off_lnf_b = pack.offsets["lnf_w"][0], pack.offsets["lnf_b"][0]
    for i, k in enumerate(LAYER_KINDS):
        a.off_layer[i] = pack.offsets[f"{k}.0"][0]
    a.layer_stride = pack.layer_stride
    for k, (d_in, d_out) in enumerate(pack.head_dims):
        a.off_wh[k], a.off_bh[k] = pack.offsets[f"wh{k}"][0], pack.offsets[f"bh{k}"][0]
        a.head_in[k], a.head_out[k] = d_in, d_out
    a.d, a.n_heads, a.ff, a.n_layers = pack.dim, pack.n_heads, pack.ff, pack.n_layers
    a.rf, a.Q = pack.rf, pack.q_levels
    a.n_head, a.final_ln = len(pack.head_dims), int(pack.final_ln)
    a.min_temperature = pack.min_temperature
    a.inv_sqrt_dh = float(np.float32(1.0 / np.sqrt(pack.dim // pack.n_heads)))


def check_pack(pack: TransformerPack, dev, dtypes=(torch.float32,)) -> None:
    """Raise unless the pack lies on ``dev`` in one of ``dtypes`` and its
    net is inside the kernels' limits for that weight type."""
    if pack.flat.dtype not in dtypes:
        raise ValueError(f"weights have dtype {pack.flat.dtype}, expected one of {dtypes}")
    _check(pack.flat, "weights", pack.flat.dtype, pack.flat.shape, dev)
    widths = [w for dims in pack.head_dims for w in dims]
    if not _fits(pack.dim, pack.n_heads, pack.ff, len(pack.head_dims), widths, pack.wbytes):
        raise ValueError("the net is outside the transformer kernels' limits")


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_kernel() -> Path:
    """Compile ``csrc/transformer_decode.cu`` for sm_90a into
    ``build/kernels/`` (see :mod:`.nvcc`) and return the library's path."""
    path, log = build_library(SOURCE, "mmk_tf_window")
    if log:
        _Kernel.build_log = log
    return path


def _library():
    if _Kernel.lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        lib.mmk_tf_window_decode.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.mmk_tf_window_decode.restype = ctypes.c_int
        lib.mmk_tf_window_args_size.argtypes = []
        lib.mmk_tf_window_args_size.restype = ctypes.c_int
        lib.mmk_tf_window_scratch_floats.argtypes = [ctypes.POINTER(_Args)]
        lib.mmk_tf_window_scratch_floats.restype = ctypes.c_longlong
        lib.mmk_tf_window_smem_bytes.argtypes = [ctypes.POINTER(_Args)]
        lib.mmk_tf_window_smem_bytes.restype = ctypes.c_longlong
        lib.mmk_tf_error_string.argtypes = [ctypes.c_int]
        lib.mmk_tf_error_string.restype = ctypes.c_char_p
        if lib.mmk_tf_window_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("TfWindowArgs layout differs between C and Python")
        _Kernel.lib = lib
    return _Kernel.lib


def _launch(pack: TransformerPack, window: torch.Tensor, n_steps: int, t0: int, seed: int,
            temperature: Temperature) -> torch.Tensor:
    dev = pack.flat.device
    if dev.type != "cuda":
        raise ValueError(f"the window decode kernel runs on CUDA tensors, got {dev}")
    B, rf = window.shape
    check_pack(pack, dev)
    _check(window, "window", torch.int32, (B, pack.rf), dev)
    _check(pack.pe_window, "pe_window", torch.float32, (rf, pack.dim), dev)
    temps = row_temperatures(temperature, B, dev)
    buf = torch.cat([window, window.new_empty(B, n_steps)], 1).contiguous()
    if n_steps == 0:
        return buf[:, rf:]
    lib = _library()
    a = _Args()
    fill_weight_args(a, pack)
    a.B, a.n_steps, a.t0 = B, n_steps, t0
    a.argmax = int(temps is None)
    a.seed = seed & 0xFFFFFFFF
    a.temperature = None if temps is None else temps.tensor.data_ptr()
    widest = max(max(dims) for dims in pack.head_dims)
    if lib.mmk_tf_window_smem_bytes(ctypes.byref(a)) != smem_bytes(
            pack.dim, pack.n_heads, pack.ff, widest):
        raise RuntimeError("the window kernel's shared memory differs from the gate's count")
    scratch = torch.empty(lib.mmk_tf_window_scratch_floats(ctypes.byref(a)), device=dev)
    barriers = torch.zeros(1, dtype=torch.int64, device=dev)
    a.w, a.pe, a.buf, a.scratch = (pack.flat.data_ptr(), pack.pe_window.data_ptr(),
                                   buf.data_ptr(), scratch.data_ptr())
    a.barriers = barriers.data_ptr()
    err = lib.mmk_tf_window_decode(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("transformer window decode kernel launch failed: "
                           f"{lib.mmk_tf_error_string(err).decode()}")
    decode_window.launches += 1
    decode_window.last_barriers = barriers
    return buf[:, rf:]


def decode_window(pack: TransformerPack, prompt: torch.Tensor, n_steps: int, seed: int,
                  temperature: Temperature) -> torch.Tensor:
    """K6's route: decode ``n_steps`` tokens after ``prompt`` (B, prior_t >=
    rf) in one launch.  Returns (B, n_steps) int32; token i is position
    ``prior_t + i``, its noise keyed by that position."""
    B, prior_t = prompt.shape
    if prior_t < pack.rf:
        raise ValueError(f"the window decode needs a prompt of at least rf={pack.rf} tokens")
    if pack.flat.dtype != torch.float32:  # JAX's K6 has no bf16 variant either
        raise ValueError(f"the window decode takes a float32 pack, not {pack.flat.dtype}")
    if prompt.device.type == "cpu":
        return decode_window_plain(pack, prompt, prior_t, n_steps, seed, temperature)
    window = prompt[:, prior_t - pack.rf :].to(torch.int32).contiguous()
    return _launch(pack, window, n_steps, prior_t, seed, temperature)


decode_window.launches = 0
# the grid barriers block 0 passed in the last launch, a (1,) device tensor:
# one before the first step, then 4L + 1 a step
decode_window.last_barriers = None
