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
    target (...) class indices (``loss_functions.py:29``)."""
    return F.cross_entropy(output.reshape(-1, output.shape[-1]), target.reshape(-1).long())
