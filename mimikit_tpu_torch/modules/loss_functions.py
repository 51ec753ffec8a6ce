"""Loss functions (counterpart of ``mimikit_tpu/modules/loss_functions.py``).

Only the categorical objective's cross-entropy is ported.  NaN guarding is
the train loop's (``loops/logger.py``), as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy"]


def cross_entropy(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over all positions; output (..., C) logits,
    target (...) class indices (``loss_functions.py:29``).

    The precision follows the logits' own dtype: logits below f32 (a bf16
    policy's) are cast to f32 first, so the loss is the f32 log-softmax of the
    values the net produced.  That stays finite where bf16 logits reach
    |x| >= 2**15, where one bf16 ulp exceeds f32's exp underflow range (the
    case the JAX package guards with an optimization barrier,
    ``mimikit_tpu/precision.py``; eager PyTorch materializes the logits
    once)."""
    if output.is_floating_point() and output.dtype.itemsize < 4:
        output = output.float()
    return F.cross_entropy(output.reshape(-1, output.shape[-1]), target.reshape(-1).long())
