"""Ops below f32 that round, forward and backward, where JAX's ops round.

Under the bf16 training policy (``trainer_kwargs={"param_dtype":
"bfloat16"}``) the JAX package differentiates its forward with JAX's rules,
and XLA rounds the result of every op to bf16 (with
``--xla_allow_excess_precision=false``, the reference's setting).  PyTorch's
autograd has other backward formulas for the same ops (``tanh``'s one fused
``g (1 - y²)``, a bias gradient summed in f32 and rounded once), so the same
bf16 forward gives other gradients.  Each op here is an
``autograd.Function`` whose backward is the transpose JAX derives (the op by
op order of ``jax.make_jaxpr(jax.vjp(...))``), every op of it in the input's
dtype; :func:`xla_sum` sums in the order XLA's CPU backend does (its
tree-reduction rewrite: windows of 32 along each reduced dimension, the
padding split evenly before and after, until no dimension is longer than
32; each window, then the windows, in row-major order), every add rounded.
Where JAX computes in f32 inside an op (the softmax's sum, the layer norm's
statistics and its transpose, every product of bf16 operands) the f32 sums
follow XLA's CPU order too: a row reduction vectorised over one register's
lanes (:func:`_row_sum`), a product's terms in the partial sums its dot
kernel keeps (:func:`matmul`, whose rule ``tools/xla_dot_order.py`` holds to
``jax.lax.dot``).

The modules call these only below f32; in f32 they keep PyTorch's own ops.
The forward of each equals the module's bf16 forward before them (each op
rounded once, as XLA's), on every device, so the bf16 decode routes are
unchanged.  The JAX-rounded backward runs on CPU tensors, where the
reference's tests hold the port to JAX's loop.  On the card each op is the
same forward under PyTorch's autograd: a backward op by op, an add at a
time, would launch a kernel for each (SampleRNN-3's bf16 train step took
~107 ms on an NVIDIA H100 80GB HBM3 with the CPU's order, against ~11), and
JAX on a GPU does not round every op either unless excess precision is
turned off.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .xla_cpu_rsqrt import xla_rsqrt

__all__ = ["xla_sum", "bias_add", "sigmoid", "tanh", "mish", "learned_temperature",
           "embedding", "softmax", "layer_norm", "matmul", "linear",
           "attention_scores", "attention_mix"]

_WINDOW = 32


def _sequential(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Sum over ``dims`` (all dimensions before the rest, in order) one
    element at a time, row-major, each add rounded to x's dtype."""
    x = torch.movedim(x, list(dims), list(range(len(dims))))
    n = 1
    for d in range(len(dims)):
        n *= x.shape[d]
    x = x.reshape((n,) + x.shape[len(dims):])
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for i in range(n):
        acc = acc + x[i]
    return acc


def xla_sum(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``x`` summed over ``dims`` in x's dtype, in the order of XLA's CPU
    reduction (see the module note)."""
    dims = sorted(d % x.ndim for d in dims)
    if all(x.shape[d] <= _WINDOW for d in dims):
        return _sequential(x, dims)
    pad, shape, inner, outer = [], [], [], []
    for d in reversed(range(x.ndim)):
        p = (-x.shape[d]) % _WINDOW if d in dims and x.shape[d] > _WINDOW else 0
        pad += [p // 2, p - p // 2]
    x = torch.nn.functional.pad(x, pad)
    for d in range(x.ndim):
        if d in dims:
            w = _WINDOW if x.shape[d] > _WINDOW else x.shape[d]
            outer.append(d)
            shape += [x.shape[d] // w, w]
            inner.append(len(shape) - 1)
        else:
            shape.append(x.shape[d])
    part = _sequential(x.reshape(shape), inner)
    return xla_sum(part, outer)


def _bias(y: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    shape = [1] * y.ndim
    shape[dim % y.ndim] = -1
    return y + b.view(shape)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


class _BiasAdd(torch.autograd.Function):
    """``y + b`` along y's dimension ``dim``; b's gradient summed over the
    others by :func:`xla_sum`."""

    @staticmethod
    def forward(ctx, y, b, dim):
        ctx.dim = dim % y.ndim
        return _bias(y, b, dim)

    @staticmethod
    def backward(ctx, g):
        return g, xla_sum(g, [d for d in range(g.ndim) if d != ctx.dim]), None


def bias_add(y: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """flax's ``y += bias`` after a product (Dense, Conv) below f32, the
    channels along y's dimension ``dim`` (JAX's layout puts them last: the
    other dimensions keep their order, so the sum's order is JAX's)."""
    return _BiasAdd.apply(y, b, dim) if y.device.type == "cpu" else _bias(y, b, dim)


class _Sigmoid(torch.autograd.Function):
    """``1 / (1 + exp(-x))``, each op rounded (XLA's expansion of the
    logistic); backward ``g (y (1 - y))``."""

    @staticmethod
    def forward(ctx, x):
        y = _logistic(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Sigmoid.apply(x) if x.device.type == "cpu" else _logistic(x)


class _Tanh(torch.autograd.Function):
    """``tanh``; backward ``t + t y`` with ``t = g (1 - y)``."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        t = g * (1 - y)
        return t + t * y


def tanh(x: torch.Tensor) -> torch.Tensor:
    return _Tanh.apply(x) if x.device.type == "cpu" else torch.tanh(x)


class _Mish(torch.autograd.Function):
    """``x tanh(sp)``, ``sp = max(x, 0) + log1p(exp(-|x|))`` (JAX's
    ``logaddexp(x, 0)``); backward through the tanh as :func:`tanh`'s and
    through the softplus by its custom rule, ``exp(x - sp)``."""

    @staticmethod
    def forward(ctx, x):
        sp = _softplus(x)
        th = torch.tanh(sp)
        ctx.save_for_backward(x, sp, th)
        return x * th

    @staticmethod
    def backward(ctx, g):
        x, sp, th = ctx.saved_tensors
        bj = (x * g) * (1 - th)
        return g * th + (bj + bj * th) * torch.exp(x - sp)


def mish(x: torch.Tensor) -> torch.Tensor:
    return _Mish.apply(x) if x.device.type == "cpu" else x * torch.tanh(_softplus(x))


def _inv_square(v: torch.Tensor) -> torch.Tensor:
    """``v ** -2`` as XLA lowers JAX's ``integer_pow``: ``1 / (v v)``."""
    return 1 / (v * v)


class _Temperature(torch.autograd.Function):
    """``h[..., :-1] / max(sigmoid(h[..., -1:]), m)``; backward JAX's
    transpose (the division's ``-g x / y²`` summed by :func:`xla_sum`, the
    max's derivative, the logistic's ``d (1 - d)``)."""

    @staticmethod
    def forward(ctx, h, m):
        x = h[..., :-1]
        d = _logistic(h[..., -1:])
        lt = torch.clamp_min(d, m)
        ctx.save_for_backward(x, d, lt)
        ctx.m = m
        return x / lt

    @staticmethod
    def backward(ctx, g):
        x, d, lt = ctx.saved_tensors
        floor = torch.full_like(lt, ctx.m)
        dmax = (d == lt).to(g.dtype) / torch.where(floor == lt, 2.0, 1.0).to(g.dtype)
        w = -xla_sum((g * _inv_square(lt)) * x, [-1]).unsqueeze(-1)
        return torch.cat([g / lt, (w * dmax) * (d * (1 - d))], -1), None


def learned_temperature(h: torch.Tensor, min_temperature: float) -> torch.Tensor:
    if h.device.type == "cpu":
        return _Temperature.apply(h, min_temperature)
    return h[..., :-1] / torch.clamp_min(_logistic(h[..., -1:]), min_temperature)


class _Embedding(torch.autograd.Function):
    """``table[idx]``; the table's gradient accumulated in the table's dtype
    one update at a time, in the updates' order (XLA's scatter-add)."""

    @staticmethod
    def forward(ctx, idx, table):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = g.reshape(flat.shape[0], -1)
        out = torch.zeros(ctx.rows, g.shape[1], dtype=g.dtype, device=g.device)
        # the k-th occurrence of every index at once: distinct rows, in order
        order = torch.argsort(flat, stable=True)
        sorted_idx = flat[order]
        first = torch.searchsorted(sorted_idx, sorted_idx)
        rank = torch.empty_like(flat)
        rank[order] = torch.arange(flat.shape[0], device=flat.device) - first
        for k in range(int(rank.max()) + 1 if flat.numel() else 0):
            sel = rank == k
            out[flat[sel]] = out[flat[sel]] + g[sel]
        return None, out


def embedding(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if table.device.type == "cpu":
        return _Embedding.apply(idx, table)
    return torch.nn.functional.embedding(idx, table)


def _softmax(x: torch.Tensor):
    """The softmax's bf16 steps (``jax.nn.softmax``): the shifted scores and
    their exponentials rounded, the sum taken in f32 (``jnp.sum`` upcasts;
    :func:`_row_sum`) and rounded; returns (exponentials, sum, quotient)."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    s = _row_sum(e.float()).unsqueeze(-1).to(x.dtype)
    return e, s, e / s


class _Softmax(torch.autograd.Function):
    """Softmax over the last axis; backward JAX's transpose of its primal
    ops (the max a constant: ``stop_gradient``): ``(g / s - sum(g e / s²))
    e``, the sum in x's dtype by :func:`xla_sum`."""

    @staticmethod
    def forward(ctx, x):
        e, s, y = _softmax(x)
        ctx.save_for_backward(e, s)
        return y

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        t = -xla_sum((g * _inv_square(s)) * e, [-1]).unsqueeze(-1)
        return (g / s + t) * e


def softmax(x: torch.Tensor) -> torch.Tensor:
    """flax attention's ``jax.nn.softmax`` of scores below f32 (on the card
    the sum in PyTorch's order)."""
    if x.device.type == "cpu":
        return _Softmax.apply(x)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _lanes() -> int:
    """The f32 lanes of one of this CPU's vector registers: XLA's CPU
    backend sums a row of f32 in that many partial sums."""
    return 16 if torch.backends.cpu.get_cpu_capability().startswith("AVX512") else 8


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) summed over its last dimension as XLA's CPU backend
    vectorises a row reduction: partial sums, lane l taking elements l, l +
    lanes, ... in order; a row no longer than the lanes (one element a
    lane) then adds them in order; a longer one keeps its 16 lanes as two
    8-float registers, as LLVM's vectorizer interleaves XLA's fused row
    reductions at its 256-bit vector width, adds the registers lane by lane
    and halves the 8 lanes, 8 -> 4 -> 2 -> 1 (``llvm.vector.reduce.fadd``).
    A row longer than 32 is summed first in :func:`xla_sum`'s windows, each
    window so, then the windows' sums so.  Read off the layer norms'
    reductions of JukeBox's fused bf16 step (``--xla_dump_to``)."""
    lanes = _lanes()
    n = x.shape[-1]
    if n > _WINDOW:
        p = (-n) % _WINDOW
        x = torch.nn.functional.pad(x, [p // 2, p - p // 2])
        return _row_sum(_row_sum(x.reshape(*x.shape[:-1], -1, _WINDOW)))
    parts = [x[..., l::lanes] for l in range(min(lanes, n))]
    acc = []
    for p in parts:
        a = p[..., 0]
        for i in range(1, p.shape[-1]):
            a = a + p[..., i]
        acc.append(a)
    if n > lanes == 16:
        acc = [acc[8 + l] + acc[l] for l in range(8)]
        while len(acc) > 1:
            h = len(acc) // 2
            acc = [acc[l] + acc[l + h] for l in range(h)]
        return acc[0]
    out = acc[0]
    for a in acc[1:]:
        out = out + a
    return out


class _LayerNorm(torch.autograd.Function):
    """flax's ``LayerNorm`` of a bf16 ``x`` with bf16 scale and bias: the
    statistics and the normalisation in f32 (``mul = rsqrt(var + eps) *
    scale`` first, the rsqrt as XLA's CPU code computes it), rounded at the
    end; backward JAX's transpose op by op,
    the sums over a row by :func:`_row_sum` and over the rows by
    :func:`xla_sum`, the cotangent of x's two uses (the centred x and the
    statistics) rounded each and added in x's dtype."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        n = x.shape[-1]
        e = x.float()
        mean = _row_sum(e).unsqueeze(-1) / n
        var = _row_sum(e * e).unsqueeze(-1) / n - mean * mean
        var0 = torch.clamp_min(var, 0.0)
        c = e - mean
        v = var0 + eps
        r = xla_rsqrt(v)
        mul = r * w.float()
        ctx.save_for_backward(e, mean, var, var0, c, v, r, mul, w)
        return (c * mul + b.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        e, mean, var, var0, c, v, r, mul, w = ctx.saved_tensors
        n, dt = e.shape[-1], g.dtype
        lead = list(range(g.ndim - 1))
        g = g.float()
        db = xla_sum(g, lead).to(dt)
        gc = c * g
        gx = g * mul
        dw = xla_sum(r * gc, lead).to(dt)
        dr = _row_sum(gc * w.float()).unsqueeze(-1)
        dvar = dr * (-0.5 * (r / v))
        dmean = _row_sum(-gx).unsqueeze(-1)
        # max(var, 0)'s derivative: 1 where it passes var, halved at a tie
        dmax = (var == var0).float() / torch.where(var0 == 0, 2.0, 1.0)
        dvar = dvar * dmax
        dmean = dmean + (-dvar) * (2.0 * mean)
        dx = dmean / n + (dvar / n) * (2.0 * e)
        return gx.to(dt) + dx.to(dt), dw, db, None


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's ``LayerNorm`` below f32 with JAX's gradient, on CPU tensors
    (the caller keeps its own formula on the card)."""
    return _LayerNorm.apply(x, w, b, eps)


def _dot_lanes(m: int, n: int):
    """How XLA's CPU backend sums each element of an (m, k) by (k, n) f32
    product: (partial sums, whether they are added pairwise).  Partial sum
    l takes the terms l, l + lanes, ... in order, up to the last multiple of
    4; the rest follow one by one.  Read off jax.lax.dot on an AVX-512 CPU
    by cancelling probes (``tools/xla_dot_order.py``, which holds this rule
    to jax at m from 4 and k, n from 2 to 256)."""
    if m == 1:
        return 1, False
    if n == 1:
        return 8, True
    if n <= 16:
        return 4, True
    if m < 64 or n % 64 == 0:
        return 1, False
    if n % 64 == 32:
        return 2, False
    return 4, True


def matmul(a: torch.Tensor, b: torch.Tensor, lhs_transposed: bool = False) -> torch.Tensor:
    """``a @ b`` ((..., m, k) by (..., k, n)) of tensors below f32 as XLA's
    CPU backend computes it: the operands widened to f32, each element
    summed in the order :func:`_dot_lanes` names (in one partial sum where
    XLA reads ``a`` transposed, ``lhs_transposed``), the result rounded to
    a's dtype.  The terms of bf16 values are exact in f32, so the sum's
    order is the only freedom."""
    dt = a.dtype
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    lanes, pairwise = (1, False) if lhs_transposed else _dot_lanes(m, n)
    a, b = a.float(), b.float()
    term = lambda i: a[..., :, i, None] * b[..., i, None, :]  # noqa: E731
    # with partial sums, the terms past the last multiple of 4 come after them
    main = k - k % 4 if lanes > 1 else k
    parts = []
    for lane in range(min(lanes, main)):
        acc = term(lane)
        for i in range(lane + lanes, main, lanes):
            acc = acc + term(i)
        parts.append(acc)
    while len(parts) > 1:
        if pairwise:
            parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                     for i in range(0, len(parts), 2)]
        else:
            parts = [parts[0] + parts[1]] + parts[2:]
    acc = parts[0] if parts else None
    for i in range(main, k):
        acc = term(i) if acc is None else acc + term(i)
    return acc.to(dt)


class _Linear(torch.autograd.Function):
    """``x @ w.T`` (x (..., in), w (out, in)); forward and backward
    products by :func:`matmul`, each in the orientation XLA gives it: the
    rows by the inputs, the output cotangent by w, and w's cotangent as
    (out, rows) by (rows, in)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
        return matmul(g2, w).reshape(x.shape), matmul(g2.t(), x2)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, w)`` below f32 in XLA's order on CPU tensors (the
    caller keeps ``F.linear`` on the card)."""
    return _Linear.apply(x, w)


class _Scores(torch.autograd.Function):
    """``q @ k^T`` over (..., T, d) heads, the products in XLA's
    orientation: forward (Tq, d) by (d, Tk); q's cotangent (Tq, Tk) by
    (Tk, d), k's (Tk, Tq) by (Tq, d), the first read transposed."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return matmul(q, k.transpose(-1, -2))

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        return matmul(g, k), matmul(g.transpose(-1, -2), q, lhs_transposed=True)


class _Mix(torch.autograd.Function):
    """``p @ v`` (p (..., Tq, Tk), v (..., Tk, d)), computed as XLA does,
    transposed: forward (d, Tk) by (Tk, Tq); p's cotangent (Tq, d) by (d,
    Tk); v's, transposed, (d, Tq) by (Tq, Tk)."""

    @staticmethod
    def forward(ctx, p, v):
        ctx.save_for_backward(p, v)
        return matmul(v.transpose(-1, -2), p.transpose(-1, -2)).transpose(-1, -2)

    @staticmethod
    def backward(ctx, g):
        p, v = ctx.saved_tensors
        gt = g.transpose(-1, -2)
        return matmul(g, v.transpose(-1, -2)), matmul(gt, p).transpose(-1, -2)


def attention_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """flax attention's scores ``q k^T`` below f32 in XLA's order, on CPU
    tensors: q and k (..., heads, T, d)."""
    return _Scores.apply(q, k)


def attention_mix(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """flax attention's ``p v`` below f32 in XLA's order, on CPU tensors:
    p (..., heads, Tq, Tk), v (..., heads, Tk, d)."""
    return _Mix.apply(p, v)
