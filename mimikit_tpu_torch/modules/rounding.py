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

__all__ = ["xla_sum", "bias_add", "sigmoid", "tanh", "mish", "learned_temperature",
           "embedding"]

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
