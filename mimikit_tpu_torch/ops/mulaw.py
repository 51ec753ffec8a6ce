"""Centered mu-law quantise and dequantise: one Triton elementwise kernel.

The kernel replaces the TPU kernels ``_compress_call`` (K10a,
``mimikit_tpu/ops/pallas_kernels.py:58``, reached through ``mulaw_compress``
``:128``) and ``_expand_call`` (K10b, ``:94``, through ``mulaw_expand``
``:141``), with the arithmetic of their bodies (``:66-73,103-108``):

* compress: ``x_mu = sign(x) * log1p(mu * |x| * c) / log1p(mu * c)``, then
  ``(x_mu + 1) * (mu / 2) + 0.5`` truncated to int32;
* expand: ``y = q / mu * 2 - 1``, then
  ``sign(y) * (exp(|y| * log1p(mu * c)) - 1) / (mu * c)``;

with mu = q_levels - 1 and c the compression, the constants rounded to f32
once, as JAX rounds them.  Each is one pass over a flat array with no reuse,
so Triton serves as well as CUDA: a program owns a block of 1,024 elements
and masks the ragged tail (the TPU version pads to (1024, 128) tiles
instead).  Its divisions are IEEE (``div_rn``), as the twin's; the compiler
may still fuse a product and a sum, so an int can differ from the twin's
by one where the value before truncation lies within rounding of an
integer.  Bound on the card: bytes, one 4-byte read and one 4-byte write an
element.

As in the JAX package no production caller routes through it:
``MuLawCompress``/``MuLawExpand`` keep their own spelling
(``features/functionals.py``), whose products round differently
(``(x_mu + 1) / 2 * mu``), so an int can differ by one where the value before
truncation lies within rounding of an integer.

The wrappers' rule: a CPU tensor takes the plain twin, a CUDA tensor
launches the kernel or raises.  ``triton`` is imported, and the kernel
compiled, on the first launch — never when this module is imported.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["mulaw_compress", "mulaw_expand", "mulaw_compress_plain", "mulaw_expand_plain"]

BLOCK = 1024


def _constants(q_levels: int, compression: float):
    """(mu, mu / 2, log1p(mu c), mu c), each rounded to f32 as the Pallas
    bodies' Python-float constants are."""
    mu = q_levels - 1.0
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return f32(mu), f32(mu / 2.0), f32(np.log1p(mu * compression)), f32(mu * compression)


def compress_value(x: torch.Tensor, q_levels: int = 256, compression: float = 1.0) -> torch.Tensor:
    """The compress twin's f32 value before its truncation to int32."""
    mu, half_mu, log_denom, _ = _constants(q_levels, compression)
    x = x.to(torch.float32)
    x_mu = torch.sign(x) * torch.log1p(mu * torch.abs(x) * compression) / log_denom
    return (x_mu + 1.0) * half_mu + 0.5


def mulaw_compress_plain(x: torch.Tensor, q_levels: int = 256,
                         compression: float = 1.0) -> torch.Tensor:
    """The plain PyTorch twin of the compress kernel: f32 (...) -> int32."""
    return compress_value(x, q_levels, compression).to(torch.int32)


def mulaw_expand_plain(q: torch.Tensor, q_levels: int = 256,
                       compression: float = 1.0) -> torch.Tensor:
    """The plain PyTorch twin of the expand kernel: int (...) -> f32."""
    mu, _, log_term, mu_c = _constants(q_levels, compression)
    y = (q.to(torch.float32) / mu) * 2.0 - 1.0
    return torch.sign(y) * (torch.exp(torch.abs(y) * log_term) - 1.0) / mu_c


# The Triton source.  ``tl`` and ``libdevice`` are bound by ``_triton_kernel``
# on the first launch (the kernel is compiled then, reading these globals);
# until then they are None and nothing here touches triton.
tl = None
libdevice = None


def _mulaw_src(x_ptr, y_ptr, n, mu, half_mu, log_term, mu_c, compression,
               COMPRESS: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    if COMPRESS:
        x = tl.load(x_ptr + offs, mask=mask, other=0.0)
        sign = tl.where(x > 0, 1.0, tl.where(x < 0, -1.0, 0.0))
        x_mu = tl.math.div_rn(sign * libdevice.log1p(mu * tl.abs(x) * compression), log_term)
        tl.store(y_ptr + offs, ((x_mu + 1.0) * half_mu + 0.5).to(tl.int32), mask=mask)
    else:
        y = tl.math.div_rn(tl.load(x_ptr + offs, mask=mask, other=0).to(tl.float32), mu) * 2.0 - 1.0
        sign = tl.where(y > 0, 1.0, tl.where(y < 0, -1.0, 0.0))
        tl.store(y_ptr + offs, tl.math.div_rn(sign * (tl.exp(tl.abs(y) * log_term) - 1.0), mu_c),
                 mask=mask)


class _Kernel:
    """The jitted Triton kernel (one per process)."""

    fn = None


def _triton_kernel():
    global tl, libdevice
    if _Kernel.fn is None:
        import triton
        import triton.language
        from triton.language.extra import libdevice as _libdevice

        tl, libdevice = triton.language, _libdevice
        _Kernel.fn = triton.jit(_mulaw_src)
    return _Kernel.fn


def _launch(x: torch.Tensor, out_dtype, compress: bool, q_levels: int,
            compression: float) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the mu-law kernel runs on CUDA tensors, got {x.device}")
    flat = x.reshape(-1).to(torch.float32 if compress else torch.int32).contiguous()
    out = torch.empty(flat.shape, dtype=out_dtype, device=x.device)
    n = flat.numel()
    if n:
        mu, half_mu, log_term, mu_c = _constants(q_levels, compression)
        _triton_kernel()[(-(-n // BLOCK),)](flat, out, n, mu, half_mu, log_term, mu_c,
                                           float(compression), COMPRESS=compress, BLOCK=BLOCK,
                                           num_warps=4)
    return out.reshape(x.shape)


def mulaw_compress(x: torch.Tensor, q_levels: int = 256, compression: float = 1.0) -> torch.Tensor:
    """Centered mu-law quantiser: f32 (...) -> int32 class indices.  CPU
    tensors take :func:`mulaw_compress_plain`; CUDA tensors launch the
    Triton kernel."""
    if x.device.type == "cpu":
        return mulaw_compress_plain(x, q_levels, compression)
    out = _launch(x, torch.int32, True, q_levels, compression)
    if x.numel():
        mulaw_compress.launches += 1
    return out


def mulaw_expand(q: torch.Tensor, q_levels: int = 256, compression: float = 1.0) -> torch.Tensor:
    """Its inverse: int (...) class indices -> f32 in [-1, 1].  CPU tensors
    take :func:`mulaw_expand_plain`; CUDA tensors launch the Triton kernel."""
    if q.device.type == "cpu":
        return mulaw_expand_plain(q, q_levels, compression)
    out = _launch(q, torch.float32, False, q_levels, compression)
    if q.numel():
        mulaw_expand.launches += 1
    return out


mulaw_compress.launches = 0
mulaw_expand.launches = 0
