"""Mixed-precision policy: the compute dtype and the casts that follow it.

Counterpart of ``mimikit_tpu/precision.py``, on torch dtypes.
:func:`compute` sets, for the code in its block, the dtype that modules
creating float tensors from non-float inputs (the class-index
``Linearizer``, the positional-encoding tables) produce, read through
:func:`compute_dtype`; everything else follows its inputs' and parameters'
dtypes.

Serving: :func:`cast_floats` gives a copy of a module, or of a dict of
tensors, with every floating tensor cast (the bf16 window re-feed,
``MMK_DECODE_BF16=1``, ``networks/transformers.py``: a bf16 copy of the net,
its forward inside ``compute(torch.bfloat16)``).

Training (``trainer_kwargs={"param_dtype": "bfloat16"}``,
``loops/train_loops.py``): the step keeps f32 master parameters and
optimizer state and runs the forward and backward in the policy's dtype.
:func:`cast_parameters` gives ``{name: p.to(dtype)}`` for every floating
parameter and buffer of a module, for ``torch.func.functional_call``, and
:func:`cast_tree` the same cast for the input and hidden tuples (integer
tensors pass through).  The casts are differentiable: the gradients come back
to the f32 masters as bf16 values in f32, as the transpose of JAX's
``convert_element_type`` gives them (``mimikit_tpu/precision.py:134-142``).
The loss takes the outputs cast to f32.  The loss barrier of the JAX module
(``loss_barrier``) pins one XLA materialization of the logits and has no
counterpart here: eager PyTorch computes them once.
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
from typing import Optional

import torch
from torch import nn

__all__ = ["compute_dtype", "compute", "cast_floats", "cast_parameters", "cast_tree",
           "resolve_dtype"]

_COMPUTE_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "mmk_torch_compute_dtype", default=None
)


def compute_dtype(default: torch.dtype = torch.float32) -> torch.dtype:
    """The policy's compute dtype, or ``default`` outside any policy."""
    d = _COMPUTE_DTYPE.get()
    return default if d is None else d


@contextlib.contextmanager
def compute(dtype: torch.dtype):
    """Set the compute dtype for the code in the block."""
    token = _COMPUTE_DTYPE.set(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def resolve_dtype(name) -> Optional[torch.dtype]:
    """A ``param_dtype`` value (``"bfloat16"``, ``"bf16"``, ``"float16"``,
    ``"float32"``, a torch dtype or None) -> the torch dtype, or None for f32
    (no policy)."""
    if name is None:
        return None
    if isinstance(name, str):
        key = name.lower().replace("torch.", "").replace("jnp.", "")
        if key in ("bfloat16", "bf16"):
            return torch.bfloat16
        if key in ("float16", "fp16", "half"):
            return torch.float16
        if key in ("float32", "f32", "fp32"):
            return None
        raise ValueError(f"unknown param_dtype '{name}'")
    if not isinstance(name, torch.dtype):
        raise ValueError(f"unknown param_dtype {name!r}")
    return None if name == torch.float32 else name


def cast_floats(tree, dtype: torch.dtype):
    """A copy of ``tree`` with every floating tensor cast to ``dtype``:
    ``tree`` an ``nn.Module`` (parameters and buffers; the original is left
    as it is) or a dict of tensors (other values pass through)."""
    if isinstance(tree, nn.Module):
        out = copy.deepcopy(tree)
        with torch.no_grad():
            for t in list(out.parameters()) + list(out.buffers()):
                if t.is_floating_point():
                    t.data = t.data.to(dtype)
        return out
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
            for k, v in tree.items()}


def cast_parameters(module: nn.Module, dtype: torch.dtype) -> dict:
    """``{name: tensor.to(dtype)}`` for every floating parameter and buffer of
    ``module`` (others as they are), for ``torch.func.functional_call``; the
    module itself is left as it is, and gradients flow back through the
    casts to its parameters."""
    named = list(module.named_parameters()) + list(module.named_buffers())
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in named}


def cast_tree(tree, dtype: torch.dtype):
    """``tree`` (a tensor, None, or nested tuples of them) with every floating
    tensor cast to ``dtype``, differentiably; other values pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        return tuple(cast_tree(x, dtype) for x in tree)
    return tree
