"""Fused categorical sampling: ``argmax(logits / t + Gumbel)`` per row.

A Triton kernel replaces the TPU kernel ``_categorical_call`` (K9,
``mimikit_tpu/ops/pallas_kernels.py:159``, reached through ``categorical``
``:196``), which ``CategoricalSampler(impl="pallas")`` calls.

The work is one pass over each (Q,) row of logits: scale by 1/t, add
Gumbel noise, take the row's argmax.  That is an elementwise pass and a row
reduction, so Triton serves as well as CUDA would: one program owns a row,
lanes past Q (Q padded to a power of two) are masked with -inf, as the JAX
wrapper pads its lanes, so they never win.  Bound on the card: bytes — each
logit is read once (4 B) and each index written once, against ~30 integer
and float operations a logit for the hash, the logs and the compare.

Noise: the port's counter hash keyed (seed, row, class) (:mod:`.noise`), so
the plain twin :func:`categorical_plain` draws the kernel's noise exactly.
The TPU kernel's bits came from the chip's own generator and are not
reproduced: draws match JAX's in distribution only.

The wrapper's rule: a CPU tensor takes the plain twin; a CUDA tensor
launches the kernel or raises.  ``triton`` is imported, and the kernel
compiled, on the first launch — never when this module is imported.
"""
from __future__ import annotations

import torch

from .noise import gumbel_rows, mix32_int

__all__ = ["categorical", "categorical_plain"]


def categorical_plain(logits: torch.Tensor, temperature: float, seed: int) -> torch.Tensor:
    """The plain PyTorch twin: (..., Q) logits -> (...,) int32 indices."""
    lead, Q = logits.shape[:-1], logits.shape[-1]
    flat = logits.reshape(-1, Q).to(torch.float32)
    scores = flat / temperature + gumbel_rows(seed, flat.shape[0], Q, flat.device)
    return torch.argmax(scores, dim=-1).to(torch.int32).reshape(lead)


# The Triton source.  ``tl`` and ``_mix32`` are bound by ``_triton_kernel``
# on the first launch (the kernel is compiled then, reading these globals);
# until then they are None and nothing here touches triton.
tl = None
_mix32 = None


def _mix32_src(x):
    x = x ^ (x >> 16)
    x = x * tl.full(x.shape, 0x7FEB352D, tl.uint32)
    x = x ^ (x >> 15)
    x = x * tl.full(x.shape, 0x846CA68B, tl.uint32)
    return x ^ (x >> 16)


def _categorical_src(logits_ptr, out_ptr, Q, stride, temperature, seed_key, BLOCK_Q: tl.constexpr):
    row = tl.program_id(0)
    q = tl.arange(0, BLOCK_Q)
    mask = q < Q
    x = tl.load(logits_ptr + row.to(tl.int64) * stride + q, mask=mask,
                other=float("-inf")).to(tl.float32)
    # seed_key = mix32(seed), computed by the wrapper (a uint32 in an int64)
    key = _mix32(tl.full((BLOCK_Q,), 0, tl.uint32) + (seed_key.to(tl.uint32) ^ row.to(tl.uint32)))
    bits = _mix32(key ^ q.to(tl.uint32))
    u = (bits >> 8).to(tl.float32) * (1.0 / 16777216.0) + 1e-12
    g = -tl.log(-tl.log(u))
    v = tl.where(mask, x / temperature + g, float("-inf"))
    tl.store(out_ptr + row, tl.argmax(v, axis=0).to(tl.int32))


class _Kernel:
    """The jitted Triton kernel (one per process)."""

    fn = None


def _triton_kernel():
    global tl, _mix32
    if _Kernel.fn is None:
        import triton
        import triton.language

        tl = triton.language
        _mix32 = triton.jit(_mix32_src)
        _Kernel.fn = triton.jit(_categorical_src)
    return _Kernel.fn


def categorical(logits: torch.Tensor, temperature: float, seed: int) -> torch.Tensor:
    """Sample class indices from (..., Q) logits with temperature by the
    Gumbel-argmax trick.  Returns (...,) int32.  CPU tensors take
    :func:`categorical_plain`; CUDA tensors launch the Triton kernel."""
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if logits.device.type == "cpu":
        return categorical_plain(logits, temperature, seed)
    if logits.device.type != "cuda":
        raise ValueError(f"the categorical kernel runs on CUDA tensors, got {logits.device}")
    import triton

    lead, Q = logits.shape[:-1], logits.shape[-1]
    flat = logits.reshape(-1, Q).to(torch.float32).contiguous()
    B = flat.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=flat.device)
    if B:
        block = triton.next_power_of_2(Q)
        _triton_kernel()[(B,)](flat, out, Q, flat.stride(0), float(temperature),
                               mix32_int(seed), BLOCK_Q=block,
                               num_warps=max(1, min(8, block // 256)))
        categorical.launches += 1
    return out.reshape(lead)


categorical.launches = 0
